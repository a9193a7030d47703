"""Time two builds of the luma and chroma-pair grain kernels on one card,
in turns.

    python scripts/grain_kernel_ab.py OLD.cu [--iters 20]

OLD.cu is a ``grain_kernels.cu`` with the same C entry points
(``grain_luma``, ``grain_chroma_pair``), for example an earlier commit's:

    mkdir -p build/ab
    git show <rev>:grav1synth_tpu_torch/csrc/grain_kernels.cu > build/ab/old.cu

The script builds OLD.cu with nvcc beside the package's own kernels,
makes 3840x2160 10-bit 4:2:0 frames from a numpy seed with the frame
parameters of .bench_cache/bench_4k10_grainy.ivf reseeded per frame
(``chip_smoke.py``'s phase 4 inputs), checks that both builds write the
same planes, then times each kernel at B = 16 and B = 112 with CUDA events
in the order old, new, new, old. Each time is printed beside the kernel's
bound and share (``chip_smoke.timing``) and the card's name and power
limit. Then the same turns end to end: ``chip_smoke.py`` phase 4's apply
with host patterns (pattern upload, parameter tables, both kernels)
through ``ops.grain.apply_grain`` with each build loaded, as frames/s on
the host clock, and under torch.profiler as device-busy ms per batch and
the device's idle share. Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def build_old(src: str) -> ctypes.CDLL:
    from grav1synth_tpu_torch import _build

    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    out_dir = os.path.join(_build.build_dir(), "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libgrain_old_{tag}.so")
    if not os.path.exists(so):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    for name in ("grain_luma", "grain_chroma_pair", "grain_error_string"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.grain_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def loaded(lib):
    """The package's kernel wrappers launch ``lib``'s kernels inside."""
    from grav1synth_tpu_torch import _build

    saved, _build._lib = _build.load(), lib
    try:
        yield
    finally:
        _build._lib = saved


def device_busy(prof) -> float:
    """ms of the union of the device intervals (kernels and copies) that
    ``prof`` recorded."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def launchers(lib, luma_args, pair_args):
    """Zero-argument launches of ``lib``'s two kernels on the arguments of
    ``apply_plane_luma`` and ``apply_planes_pair``, into outputs made once."""
    y, pat, offs, prm, bd = luma_args
    _, cb, cr, cbp, crp, offs2, p2, _, sub_x, sub_y = pair_args
    b, h, w = y.shape
    out_y, out_cb, out_cr = torch.empty_like(y), torch.empty_like(cb), torch.empty_like(cr)
    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

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

    return luma, pair


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="grain_kernels.cu to compare with the package's")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grain_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from grav1synth_tpu_torch import _build
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.ops import grain_kernels as gk

    card = cs.card_identity()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = {"old": build_old(args.old), "new": _build.load()}
    eff, (w, h, bd, (sx, sy)) = cs.stream_params(os.path.join(REPO, cs.IVF))
    planes16 = [torch.from_numpy(a).to(dev)
                for a in cs.random_planes(np.random.default_rng(7), 16, h, w, bd, sx, sy)]
    for b in (16, 112):
        params = cs.reseeded(eff, b)
        pats = tg.generate_patterns_ref(params, bd, sx, sy)
        planes = [t.repeat(b // 16, 1, 1) for t in planes16]
        luma_args, pair_args = cs.kernel_inputs(params, planes, bd, sx, sy, dev, lambda *a: pats)
        runs = {k: launchers(lib, luma_args, pair_args) for k, lib in libs.items()}
        want_y = gk.apply_plane_luma(*luma_args)
        want_c = gk.apply_planes_pair(*pair_args)
        for k, (luma, pair) in runs.items():
            if not torch.equal(luma(), want_y) or not all(
                torch.equal(g, wc) for g, wc in zip(pair(), want_c)
            ):
                raise AssertionError(f"B={b}: the {k} build differs from the package's wrappers")
        del want_y, want_c
        work = {"grain_luma": cs.luma_work(luma_args), "grain_chroma_pair": cs.pair_work(pair_args)}
        for idx, name in enumerate(("grain_luma", "grain_chroma_pair")):
            ms = []
            for k in ("old", "new", "new", "old"):
                ms.append((k, cs.cuda_ms(runs[k][idx], args.iters)))
            for k, t in ms:
                rec = cs.timing(t, None, *work[name])
                print(f"[ab] {name} 4K10 4:2:0 B={b} {k}: {t:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, share "
                      f"{rec['bound_ms'] / t:.3f}", flush=True)
            print(f"[ab] {name} 4K10 4:2:0 B={b}: old/new/new/old "
                  f"{'/'.join(f'{t:.4f}' for _, t in ms)} ms on {card}", flush=True)
        # what a plain device copy of the luma planes (K1's sample bytes,
        # read once and written once) reaches on this card: a yardstick of
        # the HBM rate a streaming kernel can get, not the kernels' function
        dst = torch.empty_like(planes[0])
        t = cs.cuda_ms(lambda: dst.copy_(planes[0]), args.iters)
        moved = 2 * cs.nbytes(planes[0])
        print(f"[ab] copy_ of the luma planes B={b}: {t:.4f} ms, {moved / t / 1e9:.3f} TB/s, "
              f"{moved / cs.HBM_BYTES_PER_S * 1e3 / t:.3f} of 3.35 TB/s on {card}", flush=True)
        del dst

        # end to end: phase 4's apply with host patterns, each build loaded
        def apply():
            prep = tg.prepare_patterns(params, bd, sx, sy, device=dev, generate=lambda *a: pats)
            return tg.apply_grain(*planes, tg.pack_params(params, dev), bd, sx, sy, prepared=prep)

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
            busy = device_busy(prof) / reps
            print(f"[ab] apply_grain 4K10 4:2:0 B={b} host patterns, {k} kernels: {fps:.1f} "
                  f"frames/s; profiled {wall:.3f} ms per batch, device busy {busy:.3f} ms, idle "
                  f"share {1 - busy / wall:.3f} on {card}", flush=True)
        del runs, luma_args, pair_args, planes
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
