"""Time an old build of one kernel source against the package's current
one on one card, in turns.

    python scripts/kernel_ab.py SOURCE OLD [--iters N]

SOURCE is ``grain_kernels.cu``, ``pattern_kernels.cu``, ``diff_kernels.cu``
or ``estimate_kernels.cu`` (a file of ``grav1synth_tpu_torch/csrc``). OLD is an
earlier version of it with the same C entry points: a file, or a git
revision (then ``git show OLD:grav1synth_tpu_torch/csrc/SOURCE`` is taken,
which needs the checkout's ``.git``). Where the card's host holds a copy
without ``.git``, write the file first:

    mkdir -p build/ab
    git show <rev>:grav1synth_tpu_torch/csrc/diff_kernels.cu > build/ab/old_diff.cu
    python scripts/kernel_ab.py diff_kernels.cu build/ab/old_diff.cu

The script builds OLD with nvcc beside the package's own library, checks
that both builds give the same output on the inputs, then times them with
CUDA events in the order old, new, new, old. Every line carries the card's
name and power limit.

- ``grain_kernels.cu``: the luma, chroma-pair and fused kernels (the
  fused one where both builds have it) on 3840x2160
  10-bit 4:2:0 frames from a numpy seed with the frame parameters of
  .bench_cache/bench_4k10_grainy.ivf reseeded per frame (``chip_smoke.py``
  phase 4's inputs) at B = 16 and B = 112, and the single-chroma-plane
  kernel on their Cb planes (phase 7's main path: the averaged luma from
  ``_avg_luma``; both builds equal to the chroma-pair kernel's Cb), each
  time beside the kernel's bound and share (``chip_smoke.timing``); then
  the same turns end to end:
  phase 4's ``ops.grain.apply_grain`` (the batch's parameter program with
  the pattern kernel in it, captured once with the package's own library,
  then the fused grain kernel) with each build loaded, as frames/s on the
  host clock, and under torch.profiler as device-busy ms per batch and the
  device's idle share; skipped, with a note, where OLD has no fused
  kernel, which the apply path launches.
- ``pattern_kernels.cu``: the grain-pattern kernel on the stream's
  parameters at 4:2:0 10-bit, B = 16 and B = 112, with AR lag 0, 1, 2 and
  3 (``chip_smoke.lagged``), each time beside the operations bound and the
  chain bound (``chip_smoke.pattern_chain``); before them a "[chain]" line:
  the cycles of one wavefront step's dependent instructions (a multiply-add,
  a shift, an add, a min and a max in a loop, behind a shuffle and without
  one), measured with clock64 on one warp (``chip_smoke.chain_step_cycles``).
- ``diff_kernels.cu``: the lag-window statistics kernel on the three planes
  of film-like 4:2:0 frames (``chip_smoke.stats_trip``) at 4K10 B = 16 and
  1080p8 B = 32 with lag 2, and 4K10 B = 16 with lag 3, every int64 sum of
  both builds equal; and the flat-block activity kernel at the same sizes.
- ``estimate_kernels.cu``: the blur and the self-statistics kernels on the
  three planes of the same film-like frames with their noise (the
  estimate path's inputs: the statistics of each plane's blur, its flat
  blocks and, for chroma, the pooled luma q) at 4K10 B = 16 with lag 2 and
  3 and 1080p8 B = 32 with lag 2, and on a textured plate at 4K10 B = 16
  with lag 2 (``chip_smoke.textured_4k``: about a third of the blocks
  textured, whole tiles without a flat block); every output of both builds
  equal. The statistics kernel is timed alone (CUDA events around its C
  launches) and through its wrapper ``ops.estimate_kernels.self_stats``
  (zeroing, launch, unpacking) with each build loaded.

Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


ENTRY_POINTS = {
    "grain_kernels.cu": ("grain_luma", "grain_chroma_pair", "grain_fused", "grain_chroma",
                         "grain_error_string"),
    "pattern_kernels.cu": ("grain_pattern",),
    "diff_kernels.cu": ("diff_flat_block_activity", "diff_plane_stats"),
    "estimate_kernels.cu": ("estimate_self_blur", "estimate_self_stats"),
}


def old_source(source: str, old: str) -> str:
    """The path of the old version of ``source``: ``old`` if it is a file,
    else that git revision's copy, written under the build directory."""
    from grav1synth_tpu_torch import _build

    if os.path.isfile(old):
        return old
    text = subprocess.run(
        ["git", "show", f"{old}:grav1synth_tpu_torch/csrc/{source}"],
        cwd=REPO, capture_output=True, check=True,
    ).stdout
    out_dir = os.path.join(_build.build_dir(), "ab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"old_{source}")
    with open(path, "wb") as fh:
        fh.write(text)
    return path


def build_old(source: str, src: str) -> ctypes.CDLL:
    from grav1synth_tpu_torch import _build

    lib = ctypes.CDLL(cs.nvcc_shared(src, "old_" + source.split(".")[0]))
    for name in ENTRY_POINTS[source]:
        fn = getattr(lib, name, None)  # an older source may lack a later entry point
        if fn is not None:
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
    if hasattr(lib, "grain_error_string"):
        lib.grain_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def turns(runs, iters: int):
    """[(which, ms)] of the zero-argument launches ``runs["old"]`` and
    ``runs["new"]`` in the order old, new, new, old."""
    return [(k, cs.cuda_ms(runs[k], iters)) for k in ("old", "new", "new", "old")]


def report(name: str, label: str, ms, card: str, work=None, extra=lambda t: "") -> None:
    for k, t in ms:
        bound = ""
        if work is not None:
            rec = cs.timing(t, None, *work)
            bound = (f", bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}, share "
                     f"{rec['bound_ms'] / t:.3f}")
        print(f"[ab] {name} {label} {k}: {t:.4f} ms{bound}{extra(t)} on {card}", flush=True)
    print(f"[ab] {name} {label}: old/new/new/old "
          f"{'/'.join(f'{t:.4f}' for _, t in ms)} ms on {card}", flush=True)


@contextlib.contextmanager
def loaded(lib):
    """The package's kernel wrappers launch ``lib``'s kernels inside."""
    from grav1synth_tpu_torch import _build

    saved, _build._lib = _build.load(), lib
    try:
        yield
    finally:
        _build._lib = saved


def launchers(lib, luma_args, pair_args, chroma_args):
    """Zero-argument launches of ``lib``'s three kernels on the arguments of
    ``apply_plane_luma``, ``apply_planes_pair`` and ``apply_plane_chroma``,
    into outputs made once."""
    y, pat, offs, prm, bd = luma_args
    _, cb, cr, cbp, crp, offs2, p2, _, sub_x, sub_y = pair_args
    src, avg, cpat, coffs, cprm = chroma_args[:5]
    b, h, w = y.shape
    out_y, out_cb, out_cr = torch.empty_like(y), torch.empty_like(cb), torch.empty_like(cr)
    out_c = torch.empty_like(src)
    stream = torch.cuda.current_stream().cuda_stream

    def luma():
        check(lib.grain_luma(y.data_ptr(), out_y.data_ptr(), pat.data_ptr(), pat.stride(0),
                             offs.data_ptr(), prm.data_ptr(), b, h, w, bd, stream))
        return out_y

    def pair():
        check(lib.grain_chroma_pair(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out_cb.data_ptr(), out_cr.data_ptr(),
            cbp.data_ptr(), cbp.stride(0), crp.data_ptr(), crp.stride(0), offs2.data_ptr(),
            p2.data_ptr(), b, h, w, sub_x, sub_y, bd, stream))
        return out_cb, out_cr

    def chroma():
        check(lib.grain_chroma(
            src.data_ptr(), avg.data_ptr(), out_c.data_ptr(), cpat.data_ptr(), cpat.stride(0),
            coffs.data_ptr(), cprm.data_ptr(), b, src.shape[1], src.shape[2], coffs.shape[1],
            coffs.shape[2], sub_x, sub_y, bd, stream))
        return out_c

    outs3 = [torch.empty_like(t) for t in (y, cb, cr)]

    def fused():
        check(lib.grain_fused(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), *(t.data_ptr() for t in outs3),
            pat.data_ptr(), pat.stride(0), cbp.data_ptr(), cbp.stride(0), crp.data_ptr(),
            crp.stride(0), offs.data_ptr(), prm.data_ptr(), p2.data_ptr(), b, h, w, sub_x, sub_y,
            bd, stream))
        return outs3

    return luma, pair, chroma, fused


def grain_ab(libs, card: str, iters: int) -> None:
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    dev = torch.device("cuda")
    with_fused = all(hasattr(lib, "grain_fused") for lib in libs.values())
    eff, (w, h, bd, (sx, sy)) = cs.stream_params(os.path.join(REPO, cs.IVF))
    planes16 = [torch.from_numpy(a).to(dev)
                for a in cs.random_planes(np.random.default_rng(7), 16, h, w, bd, sx, sy)]
    for b in (16, 112):
        params = cs.reseeded(eff, b)
        pats = tg.generate_patterns_ref(params, bd, sx, sy)
        planes = [t.repeat(b // 16, 1, 1) for t in planes16]
        luma_args, pair_args = cs.kernel_inputs(params, planes, bd, sx, sy, dev, lambda *a: pats)
        cb_args = cs.chroma_args(pair_args)[0]
        runs = {k: launchers(lib, luma_args, pair_args, cb_args) for k, lib in libs.items()}
        want_y = gk.apply_plane_luma(*luma_args)
        want_c = gk.apply_planes_pair(*pair_args)
        for k, (luma, pair, chroma, fused) in runs.items():
            if not torch.equal(luma(), want_y) or not all(
                torch.equal(g, wc) for g, wc in zip(pair(), want_c)
            ) or not torch.equal(chroma(), want_c[0]) or (with_fused and not all(
                torch.equal(g, wt) for g, wt in zip(fused(), (want_y, *want_c)))):
                raise AssertionError(f"B={b}: the {k} build differs from the package's wrappers")
        del want_y, want_c
        src, avg, cpat, coffs, cprm = cb_args[:5]
        work = {"grain_luma": cs.luma_work(luma_args), "grain_chroma_pair": cs.pair_work(pair_args),
                "grain_chroma": (2 * cs.nbytes(src) + cs.nbytes(avg, cpat, coffs, cprm),
                                 cs.chroma_ops(cprm, src.shape[1] * src.shape[2])),
                "grain_fused": cs.fused_work(luma_args, pair_args)}
        names = ("grain_luma", "grain_chroma_pair", "grain_chroma") + (
            ("grain_fused",) if with_fused else ())
        for idx, name in enumerate(names):
            ms = turns({k: r[idx] for k, r in runs.items()}, iters)
            report(name, f"4K10 4:2:0 B={b}" + (", Cb" if idx == 2 else ""), ms, card, work[name])
        # what a plain device copy of the luma planes (K1's sample bytes,
        # read once and written once) reaches on this card: a yardstick of
        # the HBM rate a streaming kernel can get, not the kernels' function
        dst = torch.empty_like(planes[0])
        t = cs.cuda_ms(lambda: dst.copy_(planes[0]), iters)
        moved = 2 * cs.nbytes(planes[0])
        print(f"[ab] copy_ of the luma planes B={b}: {t:.4f} ms, {moved / t / 1e9:.3f} TB/s, "
              f"{moved / cs.HBM_BYTES_PER_S * 1e3 / t:.3f} of 3.35 TB/s on {card}", flush=True)
        del dst

        if not with_fused:
            print("[ab] apply_grain end to end: skipped, the old build has no grain_fused, "
                  "which the apply path launches", flush=True)
            del runs, luma_args, pair_args, cb_args, planes
            torch.cuda.empty_cache()
            continue

        # end to end: phase 4's apply, each build loaded; the program (its
        # pattern kernel the package's) is captured first, outside both turns
        def apply():
            return tg.apply_grain(*planes, tg.pack_params(params, dev), bd, sx, sy)

        apply()
        reps = 20 if b == 16 else 6
        for k in ("old", "new", "new", "old"):
            with loaded(libs[k]):
                fps = cs.frames_per_s(apply, b, reps)
                with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
                ]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        apply()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / reps
            busy = cs.device_busy(prof) / reps
            print(f"[ab] apply_grain 4K10 4:2:0 B={b}, {k} kernels: {fps:.1f} "
                  f"frames/s; profiled {wall:.3f} ms per batch, device busy {busy:.3f} ms, idle "
                  f"share {1 - busy / wall:.3f} on {card}", flush=True)
        del runs, luma_args, pair_args, cb_args, planes
        torch.cuda.empty_cache()


def pattern_ab(libs, card: str, iters: int) -> None:
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    dev = torch.device("cuda")
    probe = cs.chain_step_cycles()
    print("[chain] one wavefront step's dependent chain (multiply-add, shift, add, min, max) on "
          f"one warp: {probe[True][0]:.2f} cycles a step behind a shuffle at {probe[True][1]:.0f} "
          f"MHz, {probe[False][0]:.2f} without one at {probe[False][1]:.0f} MHz on {card}",
          flush=True)
    eff, (_, _, bd, (sx, sy)) = cs.stream_params(os.path.join(REPO, cs.IVF))
    gauss = tg.gaussian_table(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for b in (16, 112):
        for lag in range(4):
            params = cs.lagged(cs.reseeded(eff, b), lag, lag)
            pb = tg.pack_params(params, dev)
            rows = gk.pattern_params(pb)
            want = gk.generate_patterns_packed_reference(pb, bd, sx, sy)
            outs = {k: torch.empty_like(want) for k in libs}

            def launch(k):
                def run():
                    check(libs[k].grain_pattern(
                        rows.data_ptr(), gauss.data_ptr(), outs[k].data_ptr(), want.shape[1], b,
                        sx, sy, bd, 0, stream))
                return run

            runs = {k: launch(k) for k in libs}
            for k, run in runs.items():
                run()
                if not torch.equal(outs[k], want):
                    raise AssertionError(f"B={b} lag {lag}: the {k} build differs from the plain version")
            work = cs.pattern_work(params, want, rows, sx, sy)
            chain = cs.pattern_chain(params, sx, sy, probe)
            report(
                "grain_pattern", f"4K10 4:2:0 B={b} lag {lag}", turns(runs, iters), card, work,
                lambda t: (f", chain bound {chain['chain_bound_ms']:.4f} ms "
                           f"({chain['chain_steps']} steps x "
                           f"{chain['chain_step_cycles']:.2f} cycles), share of it "
                           f"{chain['chain_bound_ms'] / t:.3f}"),
            )


def diff_ab(libs, card: str, iters: int) -> None:
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label, (h, w, bd, b), lags in (
        ("4K10 B=16", (2160, 3840, 10, 16), (2, 3)), ("1080p8 B=32", (1080, 1920, 8, 32), (2,)),
    ):
        _, _, trip = cs.stats_trip(h, w, bd, b, dev)
        for lag in lags:
            work = cs.stats_work(
                trip, lag, [dk.plane_stats(s, d, bl, a, lag, bd) for s, d, bl, a in trip])
            outs = {}
            for k in libs:
                outs[k] = []
                for s, _, _, a in trip:
                    p = len(dk.offsets(lag)) + (a is not None)
                    outs[k].append(torch.zeros(
                        (b, p * (p + 1) // 2 + 1 + 3 * dk.NUM_BINS), dtype=torch.int64, device=dev))

            def launch(k):
                def run():
                    for (s, d, bl, a), out in zip(trip, outs[k]):
                        out.zero_()
                        ph, pw = s.shape[1:]
                        check(libs[k].diff_plane_stats(
                            s.data_ptr(), d.data_ptr(), bl.data_ptr(),
                            None if a is None else a.data_ptr(), out.data_ptr(), b, ph, pw,
                            ph // 16, pw // 16, lag, bd, stream))
                return run

            runs = {k: launch(k) for k in libs}
            for run in runs.values():
                run()
            if not all(torch.equal(o, n) for o, n in zip(outs["old"], outs["new"])):
                raise AssertionError(f"{label} lag {lag}: the builds' int64 sums differ")
            report("plane_stats", f"{label} (3 planes, lag {lag}; the buffers' zeroing included)",
                   turns(runs, iters), card, work)
        acts = {k: [torch.empty((b, d.shape[1] // 16, d.shape[2] // 16), dtype=torch.int32,
                                device=dev) for _, d, _, _ in trip] for k in libs}

        def launch_act(k):
            def run():
                for (_, d, _, _), out in zip(trip, acts[k]):
                    check(libs[k].diff_flat_block_activity(
                        d.data_ptr(), out.data_ptr(), b, d.shape[1], d.shape[2], stream))
            return run

        runs = {k: launch_act(k) for k in libs}
        for run in runs.values():
            run()
        if not all(torch.equal(o, n) for o, n in zip(acts["old"], acts["new"])):
            raise AssertionError(f"{label}: the builds' block activities differ")
        act_work = (sum(cs.nbytes(d) for _, d, _, _ in trip) + cs.nbytes(*acts["new"]),
                    cs.ACTIVITY_OPS * sum(d.numel() for _, d, _, _ in trip))
        report("flat_block_activity", f"{label} (3 planes)", turns(runs, iters), card, act_work)
        del trip, outs, acts, runs
        torch.cuda.empty_cache()


def estimate_ab(libs, card: str, iters: int) -> None:
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label, (h, w, bd, b), lags in (
        ("4K10 B=16", (2160, 3840, 10, 16), (2, 3)), ("1080p8 B=32", (1080, 1920, 8, 32), (2,)),
        ("4K10 B=16 textured", (2160, 3840, 10, 16), (2,)),
    ):
        if "textured" in label:
            planes = cs.textured_4k(dev, b)
        else:
            planes = [torch.from_numpy(p).to(dev) for p in cs.stats_trip(h, w, bd, b, dev)[0]]
        blurred = {k: [(torch.empty_like(p), torch.empty(p.shape, dtype=torch.int32, device=dev))
                       for p in planes] for k in libs}

        def launch_blur(k):
            def run():
                for p, (den, q) in zip(planes, blurred[k]):
                    check(libs[k].estimate_self_blur(
                        p.data_ptr(), 0, den.data_ptr(), q.data_ptr(), b, p.shape[1], p.shape[2],
                        bd, stream))
            return run

        runs = {k: launch_blur(k) for k in libs}
        for run in runs.values():
            run()
        if not all(torch.equal(o, n) for bo, bn in zip(blurred["old"], blurred["new"])
                               for o, n in zip(bo, bn)):
            raise AssertionError(f"{label}: the builds' blurs differ")
        blur_work = (sum(cs.nbytes(p, *dq) for p, dq in zip(planes, blurred["new"])),
                     cs.BLUR_OPS * sum(p.numel() for p in planes))
        report("self_blur", f"{label} (3 planes)", turns(runs, iters), card, blur_work)

        lsum = de.pool_sum(blurred["new"][0][1], planes[1].shape[1], planes[1].shape[2], 1, 1)
        stat_args = [(q, den, de.flat_blocks(den), None if k == 0 else lsum, 1 if k == 0 else 4)
                     for k, (den, q) in enumerate(blurred["new"])]
        blocks = sum(int((a[2] != 0).sum()) for a in stat_args)
        print(f"[ab] {label}: {blocks / sum(a[2].numel() for a in stat_args):.3f} of the blocks "
              f"flat", flush=True)
        for lag in lags:
            work = cs.self_stats_work(stat_args, lag, [ek.self_stats(*a[:5], lag, bd)
                                                       for a in stat_args])
            sizes = [len(ek.offsets(lag)) + (a[3] is not None) for a in stat_args]
            outs = {k: [torch.zeros((b, n * (n + 1) // 2 + 1 + 3 * ek.NUM_BINS),
                                    dtype=torch.int64, device=dev) for n in sizes]
                    for k in libs}
            for k in libs:
                cs.self_stats_launches(stat_args, lag, bd, libs[k], outs[k], zero=True)()
            if not all(torch.equal(o, n) for o, n in zip(outs["old"], outs["new"])):
                raise AssertionError(f"{label} lag {lag}: the builds' int64 sums differ")
            # the kernel alone (CUDA events around the C launches, the sums
            # left to grow), then the wrapper (zeroing, launch, unpacking)
            runs = {k: cs.self_stats_launches(stat_args, lag, bd, libs[k], outs[k])
                    for k in libs}
            report("self_stats", f"{label} (3 planes, lag {lag}; kernel alone)",
                   turns(runs, iters), card, work)
            wrapped = []
            for k in ("old", "new", "new", "old"):
                with loaded(libs[k]):
                    wrapped.append((k, cs.cuda_ms(
                        lambda: [ek.self_stats(*a[:5], lag, bd) for a in stat_args], iters)))
            report("self_stats", f"{label} (3 planes, lag {lag}; the wrapper ek.self_stats)",
                   wrapped, card)
        del planes, blurred, stat_args, outs, runs
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", choices=sorted(ENTRY_POINTS),
                    help="the file of grav1synth_tpu_torch/csrc to compare")
    ap.add_argument("old", help="an old version of it: a file, or a git revision")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from grav1synth_tpu_torch import _build

    card = cs.card_identity()
    print(card, flush=True)
    libs = {"old": build_old(args.source, old_source(args.source, args.old)), "new": _build.load()}
    {"grain_kernels.cu": grain_ab, "pattern_kernels.cu": pattern_ab,
     "diff_kernels.cu": diff_ab, "estimate_kernels.cu": estimate_ab}[args.source](
        libs, card, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
