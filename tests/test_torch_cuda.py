"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one (the
parameter batches of ``pattern_zoo`` also feed the CPU tests of
tests/test_torch_patterns.py and tests/test_torch_host.py).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from av1_builder import sample_grain_params
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops import grain_kernels as gk
from grav1synth_tpu_torch.ops import program as pg
from grav1synth_tpu_torch.utils import spans


BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")


def bench_module(name):
    """A module of the benchmark's folder by its dotted name under it
    (``inputs``, ``reference.grain_ref``), with the folder on the path
    while it imports."""
    if name not in sys.modules:
        sys.path.insert(0, BENCH)
        try:
            __import__(name)
        finally:
            sys.path.remove(BENCH)
    return sys.modules[name]


def bench_config(name):
    """A configuration of the benchmark (``benchmark/configs/<name>.json``)."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)


def _programs():
    """The parameter programs' captures and replays so far."""
    return {k: spans.counter("program." + k) for k in ("captures", "replays")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def ref_packed(params, bd, sub_x=1, sub_y=1, mono=False):
    """grain_ref's patterns of ``params`` on the host, packed as the
    pattern kernel writes them."""
    pats = tg.generate_patterns_ref(params, bd, sub_x, sub_y, mono)
    return tg.pack_patterns(*(None if a is None else torch.from_numpy(a) for a in pats))


def ref_patterns(params, bd, sub_x=1, sub_y=1, mono=False, device="cpu"):
    """``ref_packed`` on ``device``, viewed as the (luma, cb, cr) planes
    the grain kernels read."""
    packed = ref_packed(params, bd, sub_x, sub_y, mono).to(device)
    return tg._unpack_patterns(packed, None if mono else tg.chroma_pattern_shape(sub_x, sub_y))


def _params():
    p0 = sample_grain_params(seed=777)
    p1 = copy.deepcopy(p0)
    p1.grain_seed, p1.overlap_flag = 4242, False
    p2 = copy.deepcopy(p0)
    p2.grain_seed, p2.chroma_scaling_from_luma = 31337, True
    p2.scaling_points_cb, p2.scaling_points_cr = [], []
    p3 = copy.deepcopy(p0)
    p3.grain_seed, p3.clip_to_restricted_range = 9001, True
    p3.scaling_points_y = [(0, 0), (1, 255), (2, 0), (128, 200), (255, 10)]
    p4 = sample_grain_params(seed=9)
    p4.scaling_points_y = [
        (x, (x * 7 + 13 * (i % 5)) % 256) for i, x in enumerate(range(0, 256, 19))
    ][:14]
    return [p0, p1, p2, p3, p4]


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kernels_match_plain_on_cuda(cuda, sub_x, sub_y, bd):
    params = _params()
    b, h, w = len(params), 70, 301
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    rng = np.random.default_rng(bd)
    maxv = (1 << bd) - 1
    planes = [
        torch.from_numpy(rng.integers(0, maxv + 1, shape).astype(np.int16))
        for shape in ((b, h, w), (b, hc, wc), (b, hc, wc))
    ]
    outs = {}
    for dev in ("cpu", cuda):
        pats = ref_patterns(params, bd, sub_x, sub_y, device=dev)
        y, cb, cr = (t.to(dev) for t in planes)
        key = pg.ProgramKey.of(y, bd, sub_x, sub_y, False, True)
        tables = pg.program_tables(tg.pack_params(params, dev), key)
        before = spans.counters("launch.")
        got = tg.apply_with_tables(y, cb, cr, tables, pats, bd, sub_x, sub_y)
        outs[str(dev)] = [t.cpu() for t in got]
    assert spans.counter("launch.grain_fused") == before.get("grain_fused", 0) + 1
    assert spans.counter("launch.grain_luma") == before.get("grain_luma", 0)
    assert spans.counter("launch.grain_chroma_pair") == before.get("grain_chroma_pair", 0)
    for pi in range(3):
        assert torch.equal(outs["cuda"][pi], outs["cpu"][pi]), f"plane {pi}"


def _mixed_params():
    """_params() and frames whose planes are off: no luma points; no
    chroma points at all (the chroma-pair kernel copies both planes); no
    Cr points (one plane grained, one copied)."""
    base = _params()
    off_y, off_c, off_cr = (copy.deepcopy(base[0]) for _ in range(3))
    off_y.grain_seed, off_y.scaling_points_y = 11, []
    off_c.grain_seed, off_c.scaling_points_cb, off_c.scaling_points_cr = 12, [], []
    off_cr.grain_seed, off_cr.scaling_points_cr = 13, []
    return base + [off_y, off_c, off_cr]


class _KernelCase:
    """One parameter batch's tables at one bit depth and subsampling, on
    the card: patterns once, then the luma, chroma-pair, fused and single-
    chroma-plane kernels against their plain versions on any planes."""

    def __init__(self, params, bd, sub_x, sub_y, device):
        self.bd, self.sub_x, self.sub_y = bd, sub_x, sub_y
        self.pats = ref_patterns(params, bd, sub_x, sub_y, device=device)
        self.pb = tg.pack_params(params, device)
        self.py = gk.pack_plane_params(self.pb, "y", bd)
        self.p2 = torch.cat([gk.pack_plane_params(self.pb, pl, bd) for pl in ("cb", "cr")])

    def check(self, y, cb, cr, what):
        """y, cb, cr: the planes as the kernels get them (any views the
        wrappers take); the plain versions get the same planes."""
        _, h, w = y.shape
        offs = tg.block_offsets(self.pb.seed, (h + 31) // 32, (w + 31) // 32)
        luma_args = (y, self.pats[0], offs, self.py, self.bd)
        pair_args = (y, cb, cr, self.pats[1], self.pats[2], offs, self.p2, self.bd,
                     self.sub_x, self.sub_y)
        before = spans.counters("launch.")
        got = [gk.apply_plane_luma(*luma_args), *gk.apply_planes_pair(*pair_args)]
        assert spans.counter("launch.grain_luma") == before.get("grain_luma", 0) + 1
        assert spans.counter("launch.grain_chroma_pair") == before.get("grain_chroma_pair", 0) + 1
        want = [gk.apply_plane_luma_reference(*luma_args),
                *gk.apply_planes_pair_reference(*pair_args)]
        for pi, (g, wnt) in enumerate(zip(got, want)):
            assert torch.equal(g, wnt), f"{what}: plane {pi}"

    def check_fused(self, y, cb, cr, what):
        """The fused kernel on y, cb, cr (any views the wrapper takes)
        against its plain version on the same planes: one launch of its
        layout's instantiation."""
        _, h, w = y.shape
        offs = tg.block_offsets(self.pb.seed, (h + 31) // 32, (w + 31) // 32)
        args = (y, cb, cr, *self.pats, offs, self.py, self.p2, self.bd, self.sub_x, self.sub_y)
        before = spans.counters("launch.")
        got = gk.apply_planes_fused(*args)
        layout = f"grain_fused.{self.sub_x}{self.sub_y}"
        assert spans.counter("launch.grain_fused") == before.get("grain_fused", 0) + 1
        assert spans.counter("launch." + layout) == before.get(layout, 0) + 1
        want = gk.apply_planes_fused_reference(*args)
        for pi, (g, wnt) in enumerate(zip(got, want)):
            assert g.dtype == torch.int16 and torch.equal(g, wnt), f"{what}: plane {pi}"

    def check_chroma(self, y, cb, cr, what, avg=None, more=(0, 0)):
        """The single-chroma-plane kernel on Cb and on Cr against its plain
        version: ``avg`` the averaged luma (``_avg_luma`` of ``y`` by
        default), offsets of ``more`` stripes and blocks past the plane's."""
        b, h, w = y.shape
        if avg is None:
            avg = tg._avg_luma(y.to(torch.int32), cb.shape[1], cb.shape[2], self.sub_x,
                               self.sub_y).to(torch.int16)
        offs = tg.block_offsets(self.pb.seed, (h + 31) // 32 + more[0], (w + 31) // 32 + more[1])
        for plane, src, pat, prm in (("cb", cb, self.pats[1], self.p2[:b]),
                                     ("cr", cr, self.pats[2], self.p2[b:])):
            args = (src, avg, pat, offs, prm, self.bd, self.sub_x, self.sub_y)
            before = spans.counter("launch.grain_chroma")
            got = gk.apply_plane_chroma(*args)
            assert spans.counter("launch.grain_chroma") == before + 1
            assert torch.equal(got, gk.apply_plane_chroma_reference(*args)), f"{what}: {plane}"


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kernels_match_plain_at_edge_geometries_on_cuda(cuda, sub_x, sub_y, bd):
    """Luma widths 520-535 (every residue mod 8, luma and chroma), odd and
    even heights, overlap on and off, mixed active and inactive planes."""
    params = _mixed_params()
    case = _KernelCase(params, bd, sub_x, sub_y, cuda)
    rng = np.random.default_rng(200 + bd)
    for w in range(520, 536):
        h = (41, 33, 64, 71)[w % 4]
        planes = _random_planes(rng, len(params), h, w, bd, sub_x, sub_y, cuda)
        case.check(*planes, f"{bd}-bit {sub_x}{sub_y} {w}x{h}")
    torch.cuda.synchronize()


def _shifted(t, by=3):
    """``t`` copied into a view ``by`` samples into a larger storage."""
    store = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = store[by:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
def test_kernels_match_plain_on_unaligned_bases_on_cuda(cuda, sub_x, sub_y):
    """Planes whose base pointer is not 16-byte aligned: a batch slice
    ``[1:]`` of 41x301 frames (each frame starts 24682 bytes after the
    last), and 64x256 planes viewed 3 samples into their storage (every
    row 6 bytes off)."""
    params = _mixed_params()
    case = _KernelCase(params, 10, sub_x, sub_y, cuda)
    rng = np.random.default_rng(7)
    b = len(params)
    big = _random_planes(rng, b + 1, 41, 301, 10, sub_x, sub_y, cuda)
    sliced = [t[1:] for t in big]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in sliced)
    case.check(*sliced, "batch slice [1:] of 41x301")
    flat = [_shifted(t) for t in _random_planes(rng, b, 64, 256, 10, sub_x, sub_y, cuda)]
    assert all(t.data_ptr() % 16 == 6 for t in flat)
    case.check(*flat, "64x256 planes 3 samples into their storage")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (0, 0)])
def test_kernels_match_plain_beyond_one_wave_on_cuda(cuda, sub_x, sub_y):
    """More work units than CTAs resident on the card (9 frames of
    520x1000 are 612 luma units and 306 or 612 chroma ones), with a batch
    size that divides no grid, so CTAs' unit ranges cross frames."""
    params = _mixed_params() + _params()[:1]
    case = _KernelCase(params, 10, sub_x, sub_y, cuda)
    planes = _random_planes(np.random.default_rng(8), len(params), 520, 1000, 10, sub_x, sub_y, cuda)
    case.check(*planes, f"{sub_x}{sub_y} 9 x 1000x520")
    torch.cuda.synchronize()


def _fused_params():
    """_mixed_params() (luma-only, chroma-only and one-chroma-plane frames
    among clipped, overlap-off and chroma-scaling-from-luma ones) and a
    frame with every plane off."""
    off_all = copy.deepcopy(_params()[0])
    off_all.grain_seed, off_all.scaling_points_y = 14, []
    off_all.scaling_points_cb, off_all.scaling_points_cr = [], []
    return _mixed_params() + [off_all]


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_fused_kernel_matches_plain_at_edge_geometries_on_cuda(cuda, sub_x, sub_y, bd):
    """The fused kernel at luma widths 520-535 (every residue mod 8, luma
    and chroma; odd widths pair the last luma sample with itself) and odd
    and even heights, on a batch that mixes luma-only, chroma-only,
    one-chroma-plane, all-inactive, clipped, overlap-off and
    chroma-scaling-from-luma frames."""
    params = _fused_params()
    case = _KernelCase(params, bd, sub_x, sub_y, cuda)
    rng = np.random.default_rng(300 + bd)
    for w in range(520, 536):
        h = (41, 33, 64, 71)[w % 4]
        planes = _random_planes(rng, len(params), h, w, bd, sub_x, sub_y, cuda)
        case.check_fused(*planes, f"{bd}-bit {sub_x}{sub_y} {w}x{h}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_fused_kernel_matches_plain_on_unaligned_bases_on_cuda(cuda, sub_x, sub_y, bd):
    """The fused kernel on planes whose bases are not 16-byte aligned: a
    batch slice ``[1:]`` of 41x301 frames, and 64x256 planes viewed 3
    samples into their storage; and on one plane of each kind alone
    unaligned (luma only, Cb only)."""
    params = _fused_params()
    case = _KernelCase(params, bd, sub_x, sub_y, cuda)
    rng = np.random.default_rng(310 + bd)
    b = len(params)
    big = _random_planes(rng, b + 1, 41, 301, bd, sub_x, sub_y, cuda)
    sliced = [t[1:] for t in big]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in sliced)
    case.check_fused(*sliced, "batch slice [1:] of 41x301")
    planes = _random_planes(rng, b, 64, 256, bd, sub_x, sub_y, cuda)
    flat = [_shifted(t) for t in planes]
    assert all(t.data_ptr() % 16 == 6 for t in flat)
    case.check_fused(*flat, "64x256 planes 3 samples into their storage")
    case.check_fused(flat[0], *planes[1:], "64x256, luma alone unaligned")
    case.check_fused(planes[0], flat[1], planes[2], "64x256, Cb alone unaligned")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_fused_kernel_matches_plain_beyond_one_wave_on_cuda(cuda, sub_x, sub_y, bd):
    """More work units than CTAs resident on the card (10 frames of
    1000x520: 640 units at 4:2:0 and 4:2:2, 960 at 4:4:4), with a batch
    size that divides no grid, so CTAs' unit ranges cross frames."""
    params = _fused_params() + _params()[:1]
    case = _KernelCase(params, bd, sub_x, sub_y, cuda)
    planes = _random_planes(np.random.default_rng(320 + bd), len(params), 520, 1000, bd, sub_x,
                            sub_y, cuda)
    case.check_fused(*planes, f"{bd}-bit {sub_x}{sub_y} {len(params)} x 1000x520")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_chroma_kernel_matches_plain_at_edge_geometries_on_cuda(cuda, sub_x, sub_y, bd):
    """The single-chroma-plane kernel at luma widths 520-535 (every residue
    mod 8 of the chroma width), odd and even heights, overlap on and off,
    mixed active and inactive planes."""
    params = _mixed_params()
    case = _KernelCase(params, bd, sub_x, sub_y, cuda)
    rng = np.random.default_rng(300 + bd)
    for w in range(520, 536):
        h = (41, 33, 64, 71)[w % 4]
        y, cb, cr = _random_planes(rng, len(params), h, w, bd, sub_x, sub_y, cuda)
        case.check_chroma(y, cb, cr, f"{bd}-bit {sub_x}{sub_y} {w}x{h}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
def test_chroma_kernel_matches_plain_on_unaligned_bases_on_cuda(cuda, sub_x, sub_y):
    """src, avg or both off the 16-byte boundary: a batch slice ``[1:]`` of
    41x301 frames, and 64x256 planes viewed 3 samples into their storage
    with the averaged luma aligned and not."""
    params = _mixed_params()
    case = _KernelCase(params, 10, sub_x, sub_y, cuda)
    rng = np.random.default_rng(17)
    b = len(params)
    sliced = [t[1:] for t in _random_planes(rng, b + 1, 41, 301, 10, sub_x, sub_y, cuda)]
    assert all(t.data_ptr() % 16 for t in sliced)
    case.check_chroma(*sliced, "batch slice [1:] of 41x301")
    y, cb, cr = _random_planes(rng, b, 64, 256, 10, sub_x, sub_y, cuda)
    avg = tg._avg_luma(y.to(torch.int32), cb.shape[1], cb.shape[2], sub_x, sub_y).to(torch.int16)
    scb, scr, savg = _shifted(cb), _shifted(cr), _shifted(avg)
    assert all(t.data_ptr() % 16 == 6 for t in (scb, scr, savg))
    case.check_chroma(y, scb, scr, "64x256 src 3 samples in", avg=avg)
    case.check_chroma(y, cb, cr, "64x256 avg 3 samples in", avg=savg)
    case.check_chroma(y, scb, scr, "64x256 src and avg 3 samples in", avg=savg)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (0, 0)])
def test_chroma_kernel_matches_plain_beyond_one_wave_on_cuda(cuda, sub_x, sub_y):
    """More units than CTAs resident on the card: 9 frames of 520x1000 are
    576 (4:2:0) or 864 (4:4:4) units against 528 resident CTAs, with unit
    ranges that cross frames."""
    params = _mixed_params() + _params()[:1]
    case = _KernelCase(params, 10, sub_x, sub_y, cuda)
    planes = _random_planes(np.random.default_rng(18), len(params), 520, 1000, 10, sub_x, sub_y, cuda)
    case.check_chroma(*planes, f"{sub_x}{sub_y} 9 x 1000x520")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
def test_chroma_kernel_matches_plain_with_offsets_larger_than_the_plane_on_cuda(
    cuda, sub_x, sub_y
):
    """Offsets that cover more stripes and blocks than the plane has: the
    kernel counts its units from the plane and finds a stripe's randoms at
    the caller's row stride."""
    params = _mixed_params()
    case = _KernelCase(params, 12, sub_x, sub_y, cuda)
    rng = np.random.default_rng(19)
    for h, w, more in ((70, 301, (2, 3)), (64, 256, (1, 0)), (41, 527, (0, 5))):
        planes = _random_planes(rng, len(params), h, w, 12, sub_x, sub_y, cuda)
        case.check_chroma(*planes, f"{w}x{h} offsets {more} larger", more=more)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_chroma_kernel_matches_plain_on_cuda(cuda, sub_x, sub_y, bd):
    params = _params()
    b = len(params)
    rng = np.random.default_rng(50 + bd)
    maxv = (1 << bd) - 1
    pb = tg.pack_params(params, cuda)
    _, cbp, crp = (
        torch.from_numpy(a.astype(np.int16)).to(cuda)
        for a in tg.generate_patterns_ref(params, bd, sub_x, sub_y)
    )
    for h, w in ((70, 301), (33, 17), (64, 64)):
        hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
        y = torch.from_numpy(rng.integers(0, maxv + 1, (b, h, w)).astype(np.int16)).to(cuda)
        avg = tg._avg_luma(y.to(torch.int32), hc, wc, sub_x, sub_y).to(torch.int16)
        offs = tg.block_offsets(pb.seed, (h + 31) // 32, (w + 31) // 32)
        for plane, pat in (("cb", cbp), ("cr", crp)):
            src = torch.from_numpy(rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)).to(cuda)
            args = (src, avg, pat, offs, gk.pack_plane_params(pb, plane, bd), bd, sub_x, sub_y)
            before = spans.counter("launch.grain_chroma")
            got = gk.apply_plane_chroma(*args)
            assert spans.counter("launch.grain_chroma") == before + 1
            want = gk.apply_plane_chroma_reference(*args)
            assert torch.equal(got.cpu(), want.cpu()), f"{plane} {w}x{h}"
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs_on_cuda(cuda):
    src = torch.zeros((1, 32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int16"):
        gk.apply_plane_luma(
            src, torch.zeros((1, 73, 82), dtype=torch.int16, device=cuda),
            torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda),
            torch.zeros((1, gk.P_LEN), dtype=torch.int32, device=cuda), 8,
        )
    c = torch.zeros((1, 40, 40), dtype=torch.int16, device=cuda)
    pat = torch.zeros((1, 38, 44), dtype=torch.int16, device=cuda)
    prm = torch.zeros((1, gk.P_LEN), dtype=torch.int32, device=cuda)

    def offs(n):
        return torch.zeros((1, n, n), dtype=torch.int32, device=cuda)

    with pytest.raises(ValueError, match="do not cover"):  # 2 x 16 rows < 40
        gk.apply_plane_chroma(c, c, pat, offs(2), prm, 8, 1, 1)
    with pytest.raises(ValueError, match="avg: expected shape"):
        gk.apply_plane_chroma(c, c[:, :20], pat, offs(3), prm, 8, 1, 1)
    with pytest.raises(ValueError, match="pattern: expected shape"):
        gk.apply_plane_chroma(c, c, pat, offs(3), prm, 8, 0, 0)
    buf = torch.zeros((4, tg.PARAMS_WIDTH), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        gk.grain_tables(buf.to(torch.int64), 64, 64, 10, True)
    with pytest.raises(ValueError, match="expected shape"):
        gk.grain_tables(buf[:, 1:], 64, 64, 10, True)
    with pytest.raises(ValueError, match="contiguous"):
        gk.grain_tables(torch.zeros((tg.PARAMS_WIDTH, 4), dtype=torch.int32, device=cuda).t(),
                        64, 64, 10, True)
    with pytest.raises(ValueError, match="bit depth"):
        gk.grain_tables(buf, 64, 64, 9, True)


# --- the diff kernels -------------------------------------------------------

DIFF_SIZES = [(64, 64), (70, 100), (40, 301), (150, 260), (33, 17), (12, 40)]


def _diff_planes(rng, b, h, w, bd, sub_x, sub_y):
    """Source = denoised + noise, denoised flat on its upper half and
    textured below, for luma and both chroma planes."""
    maxv = (1 << bd) - 1
    out = []
    for ph, pw in ((h, w), ((h + sub_y) >> sub_y, (w + sub_x) >> sub_x)):
        d = rng.integers(0, maxv + 1, (b, ph, pw))
        d[:, : ph // 2] = maxv // 3 + rng.integers(0, 3, (b, ph // 2, pw))
        s = np.clip(d + rng.integers(-40, 41, d.shape), 0, maxv)
        out.append((s.astype(np.int16), d.astype(np.int16)))
    return out


def _stats_equal(got, want, what):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float64, (what, k)
        assert torch.equal(got[k].cpu(), want[k].cpu()), (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_diff_kernels_match_plain_on_cuda(cuda, sub_x, sub_y, bd):
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    rng = np.random.default_rng(100 + bd)
    for h, w in DIFF_SIZES:
        (sy, dy), (sc, dc) = _diff_planes(rng, 3, h, w, bd, sub_x, sub_y)
        sy, dy, sc, dc = (torch.from_numpy(a).to(cuda) for a in (sy, dy, sc, dc))
        for d in (dy, dc):
            before = spans.counter("launch.flat_block_activity")
            act = dk.flat_block_activity(d)
            ran = spans.counter("launch.flat_block_activity") - before
            assert ran == (1 if act.numel() else 0)
            assert torch.equal(act.cpu(), dk.flat_block_activity_reference(d).cpu())
        lavg4 = de.chroma_lavg4(sy, dy, sc.shape[1], sc.shape[2], sub_x, sub_y)
        for lag in (1, 2, 3):
            for s, d, aux in ((sy, dy, None), (sc, dc, lavg4)):
                blocks = de.flat_blocks(d)
                before = spans.counter("launch.plane_stats")
                got = dk.plane_stats(s, d, blocks, aux, lag, bd)
                assert spans.counter("launch.plane_stats") == before + 1
                want = dk.plane_stats_reference(s, d, blocks, aux, lag, bd)
                _stats_equal(got, want, f"{bd}-bit {w}x{h} lag {lag} aux {aux is not None}")
    torch.cuda.synchronize()


def _activity_equal(d, what):
    """The flat-block activity kernel against its plain version, one launch."""
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    before = spans.counter("launch.flat_block_activity")
    got = dk.flat_block_activity(d)
    assert spans.counter("launch.flat_block_activity") == before + 1
    assert torch.equal(got, dk.flat_block_activity_reference(d)), what


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 65, 79, 129])
def test_flat_block_activity_matches_plain_at_every_width_residue_on_cuda(cuda, h):
    """Widths 512-543 (every residue mod 16; 512 and 528 exactly WB * 16)
    at heights with H mod 16 = 0 (exactly HB * 16), 1 and 15, and past one
    64-row strip, over the whole int16 range."""
    rng = np.random.default_rng(h)
    for w in range(512, 544):
        d = torch.from_numpy(rng.integers(-32768, 32768, (2, h, w), dtype=np.int16)).to(cuda)
        _activity_equal(d, f"{w}x{h}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flat_block_activity_matches_plain_at_its_edges_on_cuda(cuda):
    """Bases off the 16-byte boundary (a batch slice ``[1:]`` of 67x301
    frames, a 80x512 plane 3 samples into its storage), samples alternating
    -32768 and 32767 on 520x81 (every step 65535, every block sum 512 *
    65535), 4 frames of 2600x16000 (1000 row strips of 64 rows, 1375 CTAs,
    more than the card holds at once) and 32 frames of 960x540 (a 1080p
    chroma batch, whose strips come out at 32 rows; the small planes above
    take 16)."""
    rng = np.random.default_rng(21)
    big = torch.from_numpy(rng.integers(0, 1024, (4, 67, 301), dtype=np.int16)).to(cuda)
    assert big[1:].data_ptr() % 16
    _activity_equal(big[1:], "batch slice [1:] of 301x67")
    flat = _shifted(torch.from_numpy(rng.integers(-32768, 32768, (2, 80, 512), dtype=np.int16)).to(cuda))
    assert flat.data_ptr() % 16 == 6
    _activity_equal(flat, "512x80 3 samples into its storage")
    i, j = np.mgrid[0:81, 0:520]  # every full block has all 512 of its steps
    alt = np.where((i + j) % 2, -32768, 32767).astype(np.int16)
    d = torch.from_numpy(np.stack([alt, -1 - alt])).to(cuda)
    _activity_equal(d, "alternating -32768 / 32767")
    from grav1synth_tpu_torch.ops import diff_kernels as dk
    assert int(dk.flat_block_activity(d).min()) == 512 * 65535
    tall = torch.from_numpy(rng.integers(0, 1024, (4, 16000, 2600), dtype=np.int16)).to(cuda)
    _activity_equal(tall, "4 x 2600x16000")
    mid = torch.from_numpy(rng.integers(0, 256, (32, 540, 960), dtype=np.int16)).to(cuda)
    _activity_equal(mid, "32 x 960x540")
    torch.cuda.synchronize()


# (name, s, d, aux): a 12-bit plane at the ends of its range. r = s - d is
# +4095 or -4095 on every pixel and the x4 luma-residual column +-16380, so
# every pair sum of the statistics kernel reaches its bound.
EXTREME_CASES = [
    ("r+4095 aux+16380", 4095, 0, 16380),
    ("r-4095 aux+16380", 0, 4095, 16380),
    ("r+4095 aux-16380", 4095, 0, -16380),
    ("r-4095 aux-16380", 0, 4095, -16380),
]


def extreme_stats_inputs(s_val, d_val, aux_val, h=200, w=160, b=2):
    """(s, d, blocks, aux) int16/uint8 numpy planes of constant value with
    every full block flat: 200 rows are three tiles of the statistics
    kernel and twelve of its 16-row segments, 160 columns one tile and a
    quarter. Also used by tests/test_torch_diff.py."""
    s = np.full((b, h, w), s_val, np.int16)
    d = np.full((b, h, w), d_val, np.int16)
    blocks = np.ones((b, h // 16, w // 16), np.uint8)
    aux = np.full((b, h, w), aux_val, np.int16)
    return s, d, blocks, aux


def tall_stats_inputs():
    """A 12-bit plane 10,000 rows tall and 32 wide at r = 4095, every block
    flat: one column's sum of r * r is 1.7e11, past 2^32."""
    return extreme_stats_inputs(4095, 0, 16380, h=10000, w=32, b=1)


@pytest.mark.cuda
@pytest.mark.parametrize("name,s_val,d_val,aux_val", EXTREME_CASES, ids=[c[0] for c in EXTREME_CASES])
@pytest.mark.parametrize("lag", [1, 2, 3])
def test_plane_stats_matches_plain_at_the_ends_of_its_ranges_on_cuda(
    cuda, lag, name, s_val, d_val, aux_val
):
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    s, d, blocks, aux = (
        torch.from_numpy(a).to(cuda) for a in extreme_stats_inputs(s_val, d_val, aux_val)
    )
    for a in (None, aux):
        got = dk.plane_stats(s, d, blocks, a, lag, 12)
        want = dk.plane_stats_reference(s, d, blocks, a, lag, 12)
        _stats_equal(got, want, f"{name} lag {lag} aux {a is not None}")
    assert float(want["ata"].abs().max()) > 2.0**32


@pytest.mark.cuda
@pytest.mark.parametrize("lag", [1, 2, 3])
def test_plane_stats_matches_plain_on_a_tall_plane_on_cuda(cuda, lag):
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    s, d, blocks, aux = (torch.from_numpy(a).to(cuda) for a in tall_stats_inputs())
    for a in (None, aux):
        got = dk.plane_stats(s, d, blocks, a, lag, 12)
        want = dk.plane_stats_reference(s, d, blocks, a, lag, 12)
        _stats_equal(got, want, f"tall lag {lag} aux {a is not None}")
    # one column alone: (10000 - 2 lag) rows of 4095^2
    assert float(want["ata"][0, 0, 0]) / (32 - 2 * lag) > 2.0**32


@pytest.mark.cuda
def test_plane_stats_matches_plain_on_unaligned_rows_on_cuda(cuda):
    """The kernel stages 16 bytes a load where every row starts on a
    16-byte boundary, and sample by sample elsewhere: the same plane at an
    aligned base, 3 samples into its storage, and at a width that is no
    multiple of 8."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    rng = np.random.default_rng(77)
    for h, w in ((150, 264), (150, 260)):
        (sy, dy), _ = _diff_planes(rng, 2, h, w, 10, 1, 1)
        sy, dy = torch.from_numpy(sy).to(cuda), torch.from_numpy(dy).to(cuda)
        aux = torch.from_numpy(rng.integers(-400, 401, (2, h, w)).astype(np.int16)).to(cuda)
        blocks = de.flat_blocks(dy)
        want = dk.plane_stats_reference(sy, dy, blocks, aux, 2, 10)
        _stats_equal(dk.plane_stats(sy, dy, blocks, aux, 2, 10), want, f"{w}x{h} aligned base")
        shifted = [_shifted(t) for t in (sy, dy, aux)]
        assert all(t.data_ptr() % 16 == 6 for t in shifted)
        got = dk.plane_stats(shifted[0], shifted[1], blocks, shifted[2], 2, 10)
        _stats_equal(got, want, f"{w}x{h} 3 samples into the storage")


@pytest.mark.cuda
def test_diff_batch_on_cuda_matches_cpu(cuda):
    """DiffEstimator on the card and on the CPU: the same statistics to the
    last bit, so the same table."""
    from grav1synth_tpu_torch.ops.diff_estimate import DiffEstimator

    rng = np.random.default_rng(5)
    frames = []
    for _ in range(6):
        (sy, dy), (sc, dc) = _diff_planes(rng, 1, 96, 128, 10, 1, 1)
        frames.append(([sy[0], sc[0], sc[0]], [dy[0], dc[0], dc[0]]))
    tables = []
    for dev in ("cpu", cuda):
        est = DiffEstimator((24, 1), 10, 10, chunk_frames=1000, device=dev)
        est.diff_batch([f[0] for f in frames], [f[1] for f in frames])
        tables.append(est.finish())
    assert len(tables[0]) == len(tables[1]) == 1
    assert tables[0][0].params == tables[1][0].params


@pytest.mark.cuda
def test_diff_wrappers_check_inputs_on_cuda(cuda):
    from grav1synth_tpu_torch.ops import diff_kernels as dk

    d = torch.zeros((1, 32, 32), dtype=torch.int16, device=cuda)
    blocks = torch.zeros((1, 2, 2), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError, match="int16"):
        dk.flat_block_activity(d.to(torch.int32))
    with pytest.raises(TypeError, match="uint8"):
        dk.plane_stats(d, d, blocks.float(), None, 2, 8)
    with pytest.raises(ValueError, match="shape"):
        dk.plane_stats(d, d, blocks[:, :1], None, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        dk.plane_stats(d, d.transpose(1, 2), blocks, None, 2, 8)
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        dk.plane_stats(d, d.cpu(), blocks, None, 2, 8)
    with pytest.raises(ValueError, match="lag"):
        dk.plane_stats(d, d, blocks, None, 4, 8)


# --- the estimate path ------------------------------------------------------


@pytest.mark.cuda
def test_estimate_on_cuda_matches_cpu(cuda):
    """The blur, the flat map (the flat-block kernel) and the statistics on
    the card against the CPU run; NoiseEstimator tables equal."""
    from grav1synth_tpu_torch.ops import estimate as te

    rng = np.random.default_rng(8)
    frames = []
    for _ in range(6):
        (sy, _), (sc, _) = _diff_planes(rng, 1, 96, 130, 10, 1, 1)
        frames.append([sy[0], sc[0], sc[0][::-1].copy()])
    y = torch.from_numpy(np.stack([f[0] for f in frames]))
    c = torch.from_numpy(np.stack([f[1] for f in frames]))
    den_cpu, q_cpu = te.self_blur(y, 10)
    den, q = te.self_blur(y.to(cuda), 10)
    assert torch.equal(den.cpu(), den_cpu) and torch.equal(q.cpu(), q_cpu)
    before = spans.counter("launch.flat_block_activity")
    assert torch.equal(te.flat_blocks(den).cpu(), te.flat_blocks(den_cpu))
    assert spans.counter("launch.flat_block_activity") == before + 1
    for got, want in (
        (te.batch_self_stats(y.to(cuda), 2, 10), te.batch_self_stats(y, 2, 10)),
        (
            te.batch_self_stats_chroma(c.to(cuda), y.to(cuda), 3, 10, 1, 1),
            te.batch_self_stats_chroma(c, y, 3, 10, 1, 1),
        ),
    ):
        for k in want:
            scale = max(float(want[k].abs().max()), 1.0)
            assert float((got[k].cpu() - want[k]).abs().max()) / scale < 1e-9, k
    tables = []
    for dev in ("cpu", cuda):
        est = te.NoiseEstimator((24, 1), 10, device=dev)
        spans.reset()
        est.push_batch(frames)
        # the card's batch: K8, K5 and K9 once a plane (finish's
        # calibration pushes a batch of its own)
        launches = ({k: spans.counter("launch." + k) for k in ("self_blur", "self_stats")},
                    spans.counter("launch.flat_block_activity"))
        tables.append(est.finish())
    assert launches == ({"self_blur": 3, "self_stats": 3}, 3)
    assert len(tables[0]) == 1 and tables[0][0].params == tables[1][0].params


# --- the estimate kernels (K8, K9) -------------------------------------------


def _estimate_planes(rng, b, h, w, bd, sub_x, sub_y):
    """Grainy luma and chroma numpy planes (the sources of _diff_planes):
    flat on their upper half, textured below."""
    (sy, _), (sc, _) = _diff_planes(rng, b, h, w, bd, sub_x, sub_y)
    return sy, sc


def checkerboard(h, w, bd):
    """Two (h, w) frames of 0 / max in a checkerboard, the second mirrored:
    every block away from the edge has the same activity, so all of them
    are flat, and |q| reaches 40 max."""
    i, j = np.mgrid[0:h, 0:w]
    board = np.where((i + j) % 2, 0, (1 << bd) - 1).astype(np.int16)
    return np.stack([board, board[:, ::-1].copy()])


def textured_plate(rng, b, h, w, bd):
    """(b, h, w) int16 planes where only some blocks are flat: a smooth
    gradient with grain, textured (random levels on 8 x 8 cells, which the
    9 x 9 blur does not smooth away) on every 2 x 8-block tile of every
    fourth tile diagonal, so that whole statistics tiles hold no flat block,
    and on about one block in seven elsewhere. Smooth blocks along the
    plane's sides are flat and touch the 4-sample band; where h or w is not
    a multiple of 16 the partial last block row and column are never flat.
    About a third of the blocks are textured, so the median activity that
    sets the flat threshold is a smooth block's."""
    maxv = (1 << bd) - 1
    hb, wb = h // 16, w // 16
    by, bx = np.mgrid[0:hb, 0:wb]
    tex = ((by // 2 + bx // 8) % 4 == 1)[None] | (rng.random((b, hb, wb)) < 0.15)
    tex = np.pad(tex.repeat(16, 1).repeat(16, 2), ((0, 0), (0, h - 16 * hb), (0, w - 16 * wb)))
    cells = rng.integers(0, maxv + 1, (b, (h + 7) // 8, (w + 7) // 8), dtype=np.int32)
    cells = cells.repeat(8, 1).repeat(8, 2)[:, :h, :w]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((0.2 + 0.5 * xx / w + 0.1 * yy / h) * maxv).astype(np.float32)
    plate = np.where(tex, cells, smooth[None]) + rng.normal(0, 0.02 * maxv, (b, h, w))
    return np.clip(np.round(plate), 0, maxv).astype(np.int16)


def _unaligned(t, by: int = 3):
    """``t`` copied into a view ``by`` elements into a larger storage."""
    store = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = store[by:].view(t.shape)
    view.copy_(t)
    return view


def _blur_equal(f, bd, what):
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    before = spans.counter("launch.self_blur")
    den, q = ek.self_blur(f, bd)
    assert spans.counter("launch.self_blur") == before + 1
    want = ek.self_blur_reference(f, bd)
    assert torch.equal(den, want[0]) and torch.equal(q, want[1]), what


def _self_stats_all(q, den, lsum, n_pool, lags, bd, what):
    """``self_stats`` against its plain version on the same card inputs,
    luma (no lsum) and with ``lsum``; tolerance 0."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    blocks = de.flat_blocks(den)
    for lag in lags:
        for aux in (None,) if lsum is None else (None, lsum):
            before = spans.counter("launch.self_stats")
            got = ek.self_stats(q, den, blocks, aux, n_pool, lag, bd)
            assert spans.counter("launch.self_stats") == before + 1
            want = ek.self_stats_reference(q, den, blocks, aux, n_pool, lag, bd)
            _stats_equal(got, want, f"{what} lag {lag} lsum {aux is not None}")


BLUR_CARD_SIZES = [(1, 1), (1, 12), (12, 1), (5, 7), (8, 9), (12, 12), (15, 33), (70, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_self_blur_matches_plain_on_cuda(cuda, bd):
    """Small odd and even planes (under 9 and 16 samples), widths 520-531
    (every residue of the 4-column lane), uint8 at 8 bits, bases off the
    16-byte boundary and a batch slice."""
    rng = np.random.default_rng(300 + bd)
    maxv = (1 << bd) - 1
    sizes = BLUR_CARD_SIZES + [((33, 64, 41)[w % 3], w) for w in range(520, 532)]
    for h, w in sizes:
        f = torch.from_numpy(rng.integers(0, maxv + 1, (3, h, w)).astype(np.int16)).to(cuda)
        _blur_equal(f, bd, f"{w}x{h}")
        if bd == 8:
            _blur_equal(f.to(torch.uint8), bd, f"uint8 {w}x{h}")
    f = torch.from_numpy(rng.integers(0, maxv + 1, (4, 40, 528)).astype(np.int16)).to(cuda)
    _blur_equal(_unaligned(f), bd, "528x40 3 samples into its storage")
    _blur_equal(f[1:], bd, "batch slice [1:] of 528x40")


@pytest.mark.cuda
def test_self_blur_matches_plain_on_many_ctas_and_int16_extremes_on_cuda(cuda):
    """More CTAs than the card holds at once (4 x 16000x2600: 41,000), and
    samples over the whole int16 range, where the box sum is largest."""
    rng = np.random.default_rng(310)
    big = torch.from_numpy(rng.integers(0, 4096, (4, 2600, 16000), dtype=np.int16)).to(cuda)
    _blur_equal(big, 12, "4 x 16000x2600")
    del big
    for v in (-32768, 32767):
        _blur_equal(torch.full((2, 40, 150), v, dtype=torch.int16, device=cuda), 12, f"all {v}")
    f = rng.integers(-32768, 32768, (2, 70, 301), dtype=np.int16)
    _blur_equal(torch.from_numpy(f).to(cuda), 12, "int16 range 301x70")


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_self_stats_matches_plain_on_cuda(cuda, sub_x, sub_y, bd):
    """K9 against its plain version, to the last bit, at lags 0-3, luma and
    chroma (the pooled luma column), on small odd and even planes, one under
    16 samples and one under 9."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    rng = np.random.default_rng(320 + bd)
    n_pool = (1 + sub_x) * (1 + sub_y)
    for h, w in ((64, 64), (70, 100), (41, 301), (150, 260), (33, 17), (12, 40), (40, 8)):
        sy, sc = (torch.from_numpy(a).to(cuda)
                  for a in _estimate_planes(rng, 3, h, w, bd, sub_x, sub_y))
        den_y, q_y = ek.self_blur(sy, bd)
        _self_stats_all(q_y, den_y, None, 1, (0, 1, 2, 3), bd, f"luma {w}x{h}")
        den_c, q_c = ek.self_blur(sc, bd)
        lsum = de.pool_sum(q_y, q_c.shape[1], q_c.shape[2], sub_x, sub_y)
        _self_stats_all(q_c, den_c, lsum, n_pool, (0, 1, 2, 3), bd, f"chroma {w}x{h}")


@pytest.mark.cuda
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_self_stats_matches_plain_at_its_extremes_on_cuda(cuda, lag):
    """The 12-bit 0/max checkerboard (every block flat, |q| = 40 max, the
    pooled column of a 4:4:4 plane as large), a plane 10,000 rows tall,
    q and den off the 16-byte boundary, and a batch of 4K10 4:2:0 chroma
    planes (more CTAs than the card holds)."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    f = torch.from_numpy(checkerboard(96, 200, 12)).to(cuda)
    den, q = ek.self_blur(f, 12)
    assert int(q[:, 4:-4, 4:-4].abs().max()) == 40 * 4095
    assert float((de.flat_blocks(den) != 0).float().mean()) > 0.5
    _self_stats_all(q, den, q, 1, (lag,), 12, "12-bit checkerboard")
    rng = np.random.default_rng(330 + lag)
    tall = torch.from_numpy(_estimate_planes(rng, 1, 10000, 48, 10, 0, 0)[0]).to(cuda)
    den, q = ek.self_blur(tall, 10)
    _self_stats_all(q, den, q, 1, (lag,), 10, "10-bit 48x10000")
    sy, _ = _estimate_planes(rng, 2, 150, 264, 10, 0, 0)
    den, q = ek.self_blur(torch.from_numpy(sy).to(cuda), 10)
    qu, du = _unaligned(q), _unaligned(den)
    _self_stats_all(qu, du, _unaligned(q, 1), 1, (lag,), 10, "264x150 off the boundary")
    c = torch.from_numpy(rng.integers(0, 1024, (16, 1080, 1920), dtype=np.int16)).to(cuda)
    den, q = ek.self_blur(c, 10)
    _self_stats_all(q, den, (q * 4).contiguous(), 4, (lag,), 10, "16 x 1920x1080")


@pytest.mark.cuda
def test_self_stats_persistent_grid_crosses_frames_on_cuda(cuda):
    """K9's persistent grid: 1100 frames of one tile each (more frames than
    resident CTAs, so every CTA's tiles cross frames and its sums are added
    to each frame's outputs as the frame changes), and 24 frames of a
    textured plate with 12 tiles each, whole tiles without a flat block
    among them; lags 0-3, luma and chroma."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    rng = np.random.default_rng(340)
    f = torch.from_numpy(rng.integers(500, 540, (1100, 40, 136), dtype=np.int16)).to(cuda)
    den, q = ek.self_blur(f, 10)
    _self_stats_all(q, den, (q * 2).contiguous(), 2, (0, 1, 2, 3), 10, "1100 frames of 136x40")
    plate = torch.from_numpy(textured_plate(rng, 24, 103, 517, 10)).to(cuda)
    den, q = ek.self_blur(plate, 10)
    _self_stats_all(q, den, (q * 4).contiguous(), 4, (0, 1, 2, 3), 10, "24 textured 517x103")


@pytest.mark.cuda
def test_self_stats_single_tile_and_no_full_block_on_cuda(cuda):
    """B = 1 with a single tile (one CTA), and planes with no full 16 x 16
    block (every output zero)."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    rng = np.random.default_rng(341)
    f = torch.from_numpy(rng.integers(200, 230, (1, 32, 128), dtype=np.int16)).to(cuda)
    den, q = ek.self_blur(f, 8)
    assert int(de.flat_blocks(den).sum()) > 0
    _self_stats_all(q, den, q, 1, (0, 1, 2, 3), 8, "one 128x32 tile")
    for h, w in ((12, 40), (40, 8), (15, 300)):
        f = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.int16)).to(cuda)
        den, q = ek.self_blur(f, 8)
        blocks = torch.zeros((2, h // 16, w // 16), dtype=torch.uint8, device=cuda)
        for lag in (0, 2, 3):
            for aux in (None, q):
                got = ek.self_stats(q, den, blocks, aux, 1, lag, 8)
                assert all(float(v.abs().sum()) == 0 for v in got.values()), (h, w, lag)


@pytest.mark.cuda
def test_self_stats_unaligned_and_textured_on_cuda(cuda):
    """q, den and lsum off the 16-byte boundary (the 4-byte cp.async and
    plain-load staging), each alone and together, on a textured plate at
    lags 0-3."""
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    rng = np.random.default_rng(342)
    plate = torch.from_numpy(textured_plate(rng, 3, 150, 264, 12)).to(cuda)
    den, q = ek.self_blur(plate, 12)
    _self_stats_all(q, den, q.flip(2).contiguous(), 1, (0, 1, 2, 3), 12, "aligned 264x150")
    _self_stats_all(_unaligned(q), den, q, 1, (0, 1, 2, 3), 12, "q off the boundary")
    _self_stats_all(q, _unaligned(den, 1), q, 1, (0, 1, 2, 3), 12, "den off the boundary")
    _self_stats_all(q, den, _unaligned(q, 2), 1, (0, 1, 2, 3), 12, "lsum off the boundary")
    # an odd width: every row off the boundary
    plate = torch.from_numpy(textured_plate(rng, 2, 97, 263, 12)).to(cuda)
    den, q = ek.self_blur(plate, 12)
    _self_stats_all(q, den, q, 1, (0, 1, 2, 3), 12, "263x97")


def _self_stats_int64(q, den, blocks, lsum, lag, bd):
    """K9's int64 output recounted with int64 tensor arithmetic on the
    card: per frame the Gram's upper triangle of the masked, shifted design
    row by row, n_ar, then the bins' counts, sums of q and sums of q^2. Exact
    where the plain version's float64 sums are not (a frame's sum past
    2^53)."""
    from grav1synth_tpu_torch.ops import diff_kernels as dk
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    b, h, w = q.shape
    mask = dk._pixel_flat(blocks, h, w) & ek._band(h, w, q.device)
    m = mask[:, lag : h - lag, lag : w - lag].to(torch.int64)
    design = [q[:, lag + dr : h - lag + dr, lag + dc : w - lag + dc].to(torch.int64) * m
              for dr, dc in dk.offsets(lag)]
    if lsum is not None:
        design.append(lsum[:, lag : h - lag, lag : w - lag].to(torch.int64) * m)
    sums = [(design[i] * design[j]).sum((1, 2)) for i in range(len(design))
            for j in range(i, len(design))]
    sums.append(m.sum((1, 2)))
    bins = (den.to(torch.int64) >> (bd - 6)) + ek.NUM_BINS * torch.arange(
        b, device=q.device)[:, None, None]
    qm = q.to(torch.int64) * mask
    for v in (mask.to(torch.int64), qm, qm * q):
        mom = torch.zeros(b * ek.NUM_BINS, dtype=torch.int64, device=q.device)
        mom.index_add_(0, bins.reshape(-1), v.reshape(-1))
        sums.extend(mom.reshape(b, ek.NUM_BINS).T)
    return torch.stack(sums, 1)


@pytest.mark.cuda
def test_self_stats_checkerboard_over_many_tiles_a_cta_on_cuda(cuda):
    """The 12-bit 0/max checkerboard (every block flat, |q| = 40 max) with
    lsum = 4 q and n_pool 4 (the largest design values) on a plane of 1197
    tiles (2400 x 2000, near the largest frame whose int64 sums the C entry
    point takes at this depth and pool), more than the card holds CTAs:
    every CTA sums more than 4096 flat pixels of one frame, so its shared
    sums carry several tiles' worth of the largest products before they are
    flushed. A frame's sums pass 2^53 here, where the plain version's
    float64 sums round, so the kernel is held to an int64 recount on the
    card, unpacked as its own sums are (tolerance 0); the 96 x 200
    checkerboard of the test above holds it to the plain version."""
    from grav1synth_tpu_torch.ops import diff_estimate as de
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    f = torch.from_numpy(checkerboard(2000, 2400, 12)[:1]).to(cuda)
    den, q = ek.self_blur(f, 12)
    assert int(q[:, 4:-4, 4:-4].abs().max()) == 40 * 4095
    blocks = de.flat_blocks(den)
    assert float((blocks != 0).float().mean()) > 0.9
    lsum = (q * 4).contiguous()
    for lag in (0, 1, 2, 3):
        for aux in (None, lsum):
            got = ek.self_stats(q, den, blocks, aux, 4, lag, 12)
            p = len(ek.offsets(lag)) + (aux is not None)
            want = ek._unpack_self_stats(_self_stats_int64(q, den, blocks, aux, lag, 12), p,
                                         None if aux is None else 4)
            _stats_equal(got, want, f"checkerboard lag {lag} lsum {aux is not None}")


@pytest.mark.cuda
def test_estimate_wrappers_check_inputs_on_cuda(cuda):
    from grav1synth_tpu_torch.ops import estimate_kernels as ek

    f = torch.zeros((2, 32, 48), dtype=torch.int16, device=cuda)
    den, q = ek.self_blur(f, 10)
    blocks = torch.zeros((2, 2, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="lag 4"):
        ek.self_stats(q, den, blocks, None, 1, 4, 10)
    with pytest.raises(TypeError):
        ek.self_stats(q.to(torch.int64), den, blocks, None, 1, 2, 10)
    with pytest.raises(ValueError):
        ek.self_stats(q, den, blocks, q, 3, 2, 10)
    with pytest.raises(TypeError):
        ek.self_blur(f.to(torch.int32), 10)
    with pytest.raises(ValueError):
        ek.self_blur(f, 9)
    with pytest.raises(ValueError):
        ek.self_stats(q, den.cpu(), blocks, None, 1, 2, 10)


# --- grain patterns (K7) and the sharded apply ------------------------------

# (sub_x, sub_y, monochrome): 4:2:0, 4:2:2, 4:4:4 and monochrome
PATTERN_LAYOUTS = [(1, 1, False), (1, 0, False), (0, 0, False), (1, 1, True)]
PATTERN_LAYOUT_IDS = ["420", "422", "444", "mono"]


def pattern_zoo(seed: int, n: int = 8):
    """A mixed batch of FilmGrainParams covering what pattern generation
    branches on, made from a numpy seed: AR lag 0-3, ar_coeff_shift 6-9,
    grain_scale_shift 0-3, chroma scaling from luma, inactive planes (no
    luma points, no Cr points, no points at all) and random coefficients,
    small on even frames and over the whole int8 range (saturating) on
    odd ones. Also used by tests/test_torch_patterns.py."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = sample_grain_params(seed=int(rng.integers(0, 1 << 16)))
        kind = i % 5
        if kind == 0:
            p.scaling_points_y = []
        elif kind == 1:
            p.chroma_scaling_from_luma = True
            p.scaling_points_cb, p.scaling_points_cr = [], []
        elif kind == 2:
            p.scaling_points_cr = []
        elif kind == 3:
            p.scaling_points_y, p.scaling_points_cb, p.scaling_points_cr = [], [], []
        lag = i % 4
        p.ar_coeff_lag = lag
        p.ar_coeff_shift = 6 + int(rng.integers(0, 4))
        p.grain_scale_shift = int(rng.integers(0, 4))
        bound = 128 if i % 2 else 12

        def coeffs(k):
            return [int(c) for c in rng.integers(-bound, bound, k)]

        n_pos = 2 * lag * (lag + 1)
        n_chroma = n_pos + (1 if p.scaling_points_y else 0)
        csfl = p.chroma_scaling_from_luma
        p.ar_coeffs_y = coeffs(n_pos) if p.scaling_points_y else []
        p.ar_coeffs_cb = coeffs(n_chroma) if p.scaling_points_cb or csfl else []
        p.ar_coeffs_cr = coeffs(n_chroma) if p.scaling_points_cr or csfl else []
        out.append(p)
    return out


def set_lag(params, lag: int, seed: int):
    """Gives every frame of ``params`` AR lag ``lag`` and random
    coefficients, over the whole int8 range on odd frames."""
    rng = np.random.default_rng(1000 * lag + seed)
    n_pos = 2 * lag * (lag + 1)
    for i, p in enumerate(params):
        bound = 128 if i % 2 else 12

        def coeffs(k):
            return [int(c) for c in rng.integers(-bound, bound, k)]

        n_chroma = n_pos + (1 if p.scaling_points_y else 0)
        csfl = p.chroma_scaling_from_luma
        p.ar_coeff_lag = lag
        p.ar_coeffs_y = coeffs(n_pos) if p.scaling_points_y else []
        p.ar_coeffs_cb = coeffs(n_chroma) if p.scaling_points_cb or csfl else []
        p.ar_coeffs_cr = coeffs(n_chroma) if p.scaling_points_cr or csfl else []
    return params


def uniform_lag_zoo(lag: int, seed: int, n: int = 6):
    """``pattern_zoo`` with every frame at AR lag ``lag``: the pattern
    kernel's filter is a template on the frame's lag. Also used by
    tests/test_torch_patterns.py."""
    return set_lag(pattern_zoo(seed, n), lag, seed)


def stray_slot_frames():
    """Four lag-2 frames with every plane on, for ``stray_slots``."""
    return set_lag([sample_grain_params(seed=50 + i) for i in range(4)], 2, 9)


def stray_slots(pb):
    """``pb`` (a packed batch of lag-2 frames) with one non-zero lag-3 slot
    in frames 0-2: luma slot (-3, -3), Cb slot (-3, +3), Cr slot (0, -3).
    Such a frame is filtered at lag 3, whatever its lag says."""
    pb.coeffs_y[0, 0] = 70
    pb.coeffs_cb[1, 6] = -90
    pb.coeffs_cr[2, 21] = 50
    return pb


def _random_planes(rng, b, h, w, bd, sub_x, sub_y, device):
    maxv = (1 << bd) - 1
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    return [
        torch.from_numpy(rng.integers(0, maxv + 1, shape).astype(np.int16)).to(device)
        for shape in ((b, h, w), (b, hc, wc), (b, hc, wc))
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_pattern_kernel_matches_plain_on_cuda(cuda, sub_x, sub_y, mono, bd):
    params = pattern_zoo(100 * bd + 10 * sub_x + 2 * sub_y + mono)
    pb = tg.pack_params(params, cuda)
    before = spans.counter("launch.grain_pattern")
    got = gk.generate_patterns_packed(pb, bd, sub_x, sub_y, mono)
    assert spans.counter("launch.grain_pattern") == before + 1
    want = gk.generate_patterns_packed_reference(pb, bd, sub_x, sub_y, mono)
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(got.cpu(), ref_packed(params, bd, sub_x, sub_y, mono))


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_pattern_kernel_matches_plain_at_each_lag_on_cuda(cuda, lag, bd, sub_x, sub_y, mono):
    pb = tg.pack_params(uniform_lag_zoo(lag, bd + sub_x + sub_y + mono), cuda)
    got = gk.generate_patterns_packed(pb, bd, sub_x, sub_y, mono)
    want = gk.generate_patterns_packed_reference(pb, bd, sub_x, sub_y, mono)
    assert got.dtype == torch.int16 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
def test_pattern_kernel_takes_lag3_for_a_stray_lag3_slot_on_cuda(cuda, sub_x, sub_y, mono):
    """Lag-2 frames with one non-zero lag-3 slot each, beside a clean one."""
    pb = stray_slots(tg.pack_params(stray_slot_frames(), cuda))
    clean = tg.pack_params(stray_slot_frames(), cuda)
    got = gk.generate_patterns_packed(pb, 10, sub_x, sub_y, mono)
    want = gk.generate_patterns_packed_reference(pb, 10, sub_x, sub_y, mono)
    assert torch.equal(got, want)
    moved = (want != gk.generate_patterns_packed_reference(clean, 10, sub_x, sub_y, mono)).any(1)
    assert moved.tolist() == [True, not mono, not mono, False]


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (0, 0)])
def test_device_pattern_apply_equals_host_pattern_apply_on_cuda(cuda, sub_x, sub_y):
    params = pattern_zoo(31 + sub_x)
    planes = _random_planes(np.random.default_rng(3), len(params), 70, 301, 10, sub_x, sub_y, cuda)
    pb = tg.pack_params(params, cuda)
    # the grain kernels on the program's tables and grain_ref's patterns
    tables = pg.program_tables(pb, pg.ProgramKey.of(planes[0], 10, sub_x, sub_y, False, True))
    want = tg.apply_with_tables(*planes, tables, ref_patterns(params, 10, sub_x, sub_y, device=cuda),
                                10, sub_x, sub_y)
    tg.apply_grain(*planes, pb, 10, sub_x, sub_y)  # captures the batch's program
    torch.cuda.synchronize()
    spans.reset()
    got = tg.apply_grain(*planes, pb, 10, sub_x, sub_y)
    torch.cuda.synchronize()
    assert {k: spans.counter("launch." + k)
            for k in ("grain_pattern", "grain_fused", "grain_luma", "grain_chroma_pair")} == {
        "grain_pattern": 1, "grain_fused": 1, "grain_luma": 0, "grain_chroma_pair": 0,
    }
    assert _programs() == {"captures": 0, "replays": 1}
    for pi in range(3):
        assert torch.equal(got[pi], want[pi]), f"plane {pi}"


@pytest.mark.cuda
def test_apply_at_4k_12bit_444_through_the_program_on_cuda(cuda):
    """3840x2160 12-bit 4:4:4, B = 2 (overlap on and off, clipping off and
    on), through ``pack_params`` and ``apply_grain`` with a captured
    program: the luma kernel at 12 bits and the chroma-pair kernel's
    unsubsampled 12-bit path, whose 56,736 B of dynamic shared memory pass
    the 48 KB default, equal to their plain versions on the program's own
    tables and patterns, frame 0 equal to grain_ref; the fused kernel's
    <0,0> instantiation launched once, the program's tables and pattern
    kernels once each."""
    from grav1synth_tpu_torch.ops import grain_ref

    h, w, bd = 2160, 3840, 12
    params = [sample_grain_params(seed=1201), sample_grain_params(seed=1202)]
    params[1].overlap_flag, params[1].clip_to_restricted_range = False, True
    y, cb, cr = _random_planes(np.random.default_rng(12), 2, h, w, bd, 0, 0, cuda)
    tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), bd, 0, 0)  # captures the program
    torch.cuda.synchronize()
    spans.reset()
    got = tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), bd, 0, 0)
    torch.cuda.synchronize()
    assert _programs() == {"captures": 0, "replays": 1}
    assert spans.counters("launch.") == {"grain_tables": 1, "grain_pattern": 1, "grain_fused": 1,
                                         "grain_fused.00": 1}
    key = pg.ProgramKey.of(y, bd, 0, 0, False, True)
    tables = pg.program_body(tg.pack_params(params, cuda).buffer, key)
    luma_pat, cb_pat, cr_pat = tg._unpack_patterns(tables.patterns, tg.chroma_pattern_shape(0, 0))
    assert tuple(cb_pat.shape) == (2, 73, 82)
    want_y = gk.apply_plane_luma_reference(y, luma_pat, tables.offsets, tables.params_y, bd)
    assert torch.equal(got[0], want_y), "luma"
    del want_y
    want_cb, want_cr = gk.apply_planes_pair_reference(
        y, cb, cr, cb_pat, cr_pat, tables.offsets, tables.params2, bd, 0, 0)
    assert torch.equal(got[1], want_cb) and torch.equal(got[2], want_cr), "chroma"
    del want_cb, want_cr
    ref = grain_ref.apply_grain_frame([t[0].cpu().numpy().astype(np.int32) for t in (y, cb, cr)],
                                      params[0], bd, 0, 0)
    for k in range(3):
        assert np.array_equal(got[k][0].cpu().numpy().astype(np.int32), ref[k]), f"plane {k}"


@pytest.mark.cuda
def test_apply_at_4k_10bit_422_on_the_cells_tables_on_cuda(cuda):
    """3840x2160 10-bit 4:2:2, B = 2, on tables of the uhd10_422 cell's
    shape drawn by the benchmark's own ``draw_tables`` (14 luma, 10 Cb and
    10 Cr points, AR lag 3, overlap on, restricted-range clip), through
    ``pack_params`` and ``apply_grain``, the benchmark's path: both frames
    equal to the benchmark's frozen grain_ref on every plane, the
    fused kernel's <1,0> instantiation launched once."""
    from grav1synth_tpu_torch.obu.types import FilmGrainParams

    cfg = bench_config("uhd10_422")
    h, w, bd = cfg["height"], cfg["width"], cfg["bit_depth"]
    sub_x, sub_y = cfg["subsampling"]
    tables = bench_module("inputs").draw_tables(2**33 + 422, cfg["grain"], 2)
    params = [FilmGrainParams(**t) for t in tables]
    assert len(tables[0]["ar_coeffs_y"]) == 24 and len(tables[0]["scaling_points_y"]) == 14
    y, cb, cr = _random_planes(np.random.default_rng(422), 2, h, w, bd, sub_x, sub_y, cuda)
    tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), bd, sub_x, sub_y)  # the capture
    torch.cuda.synchronize()
    spans.reset()
    got = tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), bd, sub_x, sub_y)
    got = [t.cpu().numpy().astype(np.int32) for t in got]
    assert spans.counter("launch.grain_fused") == 1
    assert spans.counters("launch.grain_fused.") == {"10": 1}
    assert spans.counter("launch.grain_chroma_pair") == 0
    grain_ref = bench_module("reference.grain_ref")
    ref_params = bench_module("reference.types").FilmGrainParams
    for i, t in enumerate(tables):
        planes = [p[i].cpu().numpy().astype(np.int32) for p in (y, cb, cr)]
        want = grain_ref.apply_grain_frame(planes, ref_params(**t), bd, sub_x, sub_y)
        for k in range(3):
            wrong = int(np.count_nonzero(got[k][i] != want[k]))
            assert wrong == 0, f"frame {i} plane {k}: {wrong} samples differ"


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)], ids=["420", "422", "444"])
def test_chroma_pair_launches_counted_by_layout_on_cuda(cuda, sub_x, sub_y):
    """``launch.grain_fused.<sub_x><sub_y>`` counts the fused kernel's
    launches of a batch's own layout, once an ``apply_grain``, and no
    other layout's; the apply path launches the chroma-pair kernel no
    more."""
    params = _params()
    rng = np.random.default_rng(7)
    y, cb, cr = _random_planes(rng, len(params), 64, 96, 10, sub_x, sub_y, cuda)
    tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), 10, sub_x, sub_y)  # the capture
    spans.reset()
    for n in (1, 2):
        tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), 10, sub_x, sub_y)
        assert spans.counters("launch.grain_fused.") == {f"{sub_x}{sub_y}": n}
        assert spans.counter("launch.grain_fused") == n
        assert spans.counter("launch.grain_chroma_pair") == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)], ids=["420", "422", "444"])
def test_apply_launches_the_fused_kernel_or_the_luma_kernel_alone_on_cuda(cuda, sub_x, sub_y):
    """A three-plane ``apply_grain`` launches the fused kernel once and the
    luma and chroma-pair kernels not at all; a batch whose tables touch no
    chroma launches the luma kernel once and the fused kernel not at
    all."""
    rng = np.random.default_rng(9)
    y, cb, cr = _random_planes(rng, 5, 64, 96, 10, sub_x, sub_y, cuda)
    for params, want in ((_params(), {"grain_fused": 1, "grain_luma": 0}),
                         (luma_tables(_params()), {"grain_fused": 0, "grain_luma": 1})):
        tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), 10, sub_x, sub_y)  # the capture
        spans.reset()
        tg.apply_grain(y, cb, cr, tg.pack_params(params, cuda), 10, sub_x, sub_y)
        got = {k: spans.counter("launch." + k) for k in ("grain_fused", "grain_luma")}
        assert got == want and spans.counter("launch.grain_chroma_pair") == 0
        assert spans.counters("launch.grain_fused.") == (
            {f"{sub_x}{sub_y}": 1} if want["grain_fused"] else {})
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sharded_apply_over_a_two_shard_mesh_on_one_card(cuda):
    from grav1synth_tpu_torch.parallel import DeviceMesh, sharded_apply_with_stats

    params = pattern_zoo(41)
    y, cb, cr = _random_planes(np.random.default_rng(4), len(params), 64, 96, 10, 1, 1, cuda)
    pb = tg.pack_params(params, cuda)
    want = tg.apply_grain(y, cb, cr, pb, 10)
    got = sharded_apply_with_stats(DeviceMesh([cuda, cuda]), y, cb, cr, pb, 10)
    for pi in range(3):
        assert torch.equal(got[pi], want[pi]), f"plane {pi}"
    d = want[0].to(torch.int64) - y.to(torch.int64)
    assert got[3].dtype == torch.float64 and got[3].item() == float((d * d).sum())
    assert got[4].item() == len(params)


@pytest.mark.cuda
@pytest.mark.parametrize("luma_only", [False, True], ids=["chroma", "luma-only"])
@pytest.mark.parametrize("bd", [8, 10])
def test_sharded_apply_from_render_s_pinned_host_batch_on_one_card(cuda, bd, luma_only):
    """render's mesh branch: the planes staged by ``pipelines._stage`` in
    pinned host memory (uint8 at 8 bits, int16 above), each shard copied
    to the card from it, with the tables' own chroma fact: the planes and
    the energy of the one-card apply on int16 card planes."""
    from grav1synth_tpu_torch import pipelines
    from grav1synth_tpu_torch.parallel import DeviceMesh, sharded_apply_with_stats

    params = pattern_zoo(42 + bd)
    if luma_only:
        params = luma_tables(params)
    assert tg.pack_params(params, "cpu").touches_chroma != luma_only
    rng = np.random.default_rng(bd)
    dtype = np.uint8 if bd == 8 else np.uint16
    shapes = ((64, 96), (32, 48), (32, 48))
    frames = [[rng.integers(0, 1 << bd, sh, dtype=dtype) for sh in shapes] for _ in params]
    staged = [pipelines._stage([f[k] for f in frames], cuda) for k in range(3)]
    assert all(map(torch.Tensor.is_pinned, staged))
    assert all(t.dtype == (torch.uint8 if bd == 8 else torch.int16) for t in staged)
    got = sharded_apply_with_stats(DeviceMesh([cuda, cuda]), *staged,
                                   tg.pack_params(params, "cpu"), bd)
    planes = [torch.from_numpy(np.stack([f[k] for f in frames]).astype(np.int16)).to(cuda)
              for k in range(3)]
    want = tg.apply_grain(*planes, tg.pack_params(params, cuda), bd)
    for pi in range(3):
        assert torch.equal(got[pi].to(torch.int16), want[pi]), f"plane {pi}"
    d = want[0].to(torch.int64) - planes[0].to(torch.int64)
    assert got[3].item() == float((d * d).sum()) and got[4].item() == len(params)


def luma_tables(params):
    """The tables with their chroma switched off: no Cb or Cr points, no
    chroma scaling from luma."""
    return [dataclasses.replace(p, scaling_points_cb=[], scaling_points_cr=[],
                                chroma_scaling_from_luma=False) for p in params]


def program_paths(params, planes, bd, sub_x, sub_y, mono, device):
    """(graph, eager): the apply through the batch's parameter program, and
    the same with the program's eager body in the graph's place."""
    y, cb, cr = planes
    key = pg.ProgramKey.of(y, bd, sub_x, sub_y, mono, tg._touches_chroma(params))

    def graph():
        pb = tg.pack_params(params, device)
        assert pb.touches_chroma == key.chroma_static or mono
        return tg.apply_grain(y, cb, cr, pb, bd, sub_x, sub_y, mono)

    def eager():
        tables = pg.program_body(tg.pack_params(params, device).buffer, key)
        pats = tg._unpack_patterns(
            tables.patterns, None if mono else tg.chroma_pattern_shape(sub_x, sub_y))
        return tg.apply_with_tables(y, cb, cr, tables, pats, bd, sub_x, sub_y, mono)

    return graph, eager


# chroma_static False: the batch's tables touch no chroma (``luma_tables``),
# so the program makes no Cb|Cr rows and the luma kernel runs alone
CHROMA_STATIC = [pytest.param(False, id="luma-only"), pytest.param(True, id="device")]


@pytest.mark.cuda
@pytest.mark.parametrize("chroma_static", CHROMA_STATIC)
@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
def test_program_graph_equals_eager_body_on_cuda(cuda, sub_x, sub_y, mono, chroma_static):
    """The apply through the captured program equals the eager body with
    the same kernels, and the CPU run; after the capture a batch is one
    replay, with the tables and pattern kernels in it, and the fused
    kernel after it, or the luma kernel alone where ``chroma_static`` is
    False or the batch is monochrome."""
    params = pattern_zoo(60 + 2 * sub_x + sub_y + 4 * mono)
    if not chroma_static:
        params = luma_tables(params)
    planes = _random_planes(np.random.default_rng(5), len(params), 70, 301, 10, sub_x, sub_y, cuda)
    if mono:
        planes = [planes[0], None, None]
    graph, eager = program_paths(params, planes, 10, sub_x, sub_y, mono, cuda)
    got = graph()
    want = eager()
    cpu_planes = [None if t is None else t.cpu() for t in planes]
    on_cpu = program_paths(params, cpu_planes, 10, sub_x, sub_y, mono, "cpu")[0]()
    for k in range(1 if mono else 3):
        assert torch.equal(got[k], want[k]), f"plane {k}: graph vs eager body"
        assert torch.equal(got[k].cpu(), on_cpu[k]), f"plane {k}: card vs CPU"
    torch.cuda.synchronize()
    spans.reset()
    again = graph()
    torch.cuda.synchronize()
    assert _programs() == {"captures": 0, "replays": 1}
    assert spans.counter("launch.grain_tables") == 1
    assert spans.counter("launch.grain_pattern") == 1
    assert spans.counter("launch.grain_fused") == (chroma_static and not mono)
    assert spans.counter("launch.grain_luma") == (not chroma_static or mono)
    assert spans.counter("launch.grain_chroma_pair") == 0
    if not (chroma_static or mono):
        assert got[1] is planes[1] and got[2] is planes[2]
    assert all(torch.equal(a, b) for a, b in zip(again[:1 if mono else 3], got))


@pytest.mark.cuda
def test_program_replays_on_two_streams_in_turn_on_cuda(cuda):
    """Batches of one program on two streams in turn: each replay waits for
    the stream of the last, so no batch reads another's tables."""
    params = [pattern_zoo(70 + i) for i in range(4)]
    planes = _random_planes(np.random.default_rng(6), len(params[0]), 64, 96, 10, 1, 1, cuda)
    want = [tg.apply_grain(*planes, tg.pack_params(ps, cuda), 10) for ps in params]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    got = []
    for i, ps in enumerate(params):
        with torch.cuda.stream(streams[i % 2]):
            streams[i % 2].wait_stream(torch.cuda.default_stream(cuda))
            got.append(tg.apply_grain(*planes, tg.pack_params(ps, cuda), 10))
    torch.cuda.synchronize()
    for i in range(len(params)):
        for k in range(3):
            assert torch.equal(got[i][k], want[i][k]), f"batch {i} plane {k}"


@pytest.mark.cuda
def test_program_outputs_are_the_next_replays_on_cuda(cuda):
    """A replay's outputs are the graph's static tensors: the next replay
    of the same program writes the same tensors with its batch's tables."""
    first, second = pattern_zoo(80), pattern_zoo(81)
    y = torch.zeros((len(first), 64, 64), dtype=torch.int16, device=cuda)
    prog = pg.program_for(pg.ProgramKey.of(y, 10, 1, 1, False, True))
    out1 = prog.run(tg.pack_params(first, cuda))
    kept = out1.offsets.clone()
    pb2 = tg.pack_params(second, cuda)
    out2 = prog.run(pb2)
    assert out2.offsets.data_ptr() == out1.offsets.data_ptr()
    assert out2.patterns.data_ptr() == out1.patterns.data_ptr()
    torch.cuda.synchronize()
    want = tg.block_offsets(pb2.seed, 2, 2)  # the seeds differ between the batches
    assert torch.equal(out2.offsets, want) and not torch.equal(kept, want)


@pytest.mark.cuda
@pytest.mark.parametrize("chroma_static", CHROMA_STATIC)
def test_program_ragged_batches_share_a_program_on_cuda(cuda, chroma_static):
    """Batches of 5, 8 and 6 frames run one program captured at 8: each
    fills the first rows of the static input and equals the eager body with
    the same kernels, after a batch of other frames filled the rest."""
    pg.clear_programs()
    outs = []
    for n, seed in ((5, 90), (8, 91), (6, 92)):
        params = pattern_zoo(seed, n=n)
        if not chroma_static:
            params = luma_tables(params)
        planes = _random_planes(np.random.default_rng(seed), n, 70, 301, 10, 1, 1, cuda)
        graph, eager = program_paths(params, planes, 10, 1, 1, False, cuda)
        outs.append((graph(), eager()))
    torch.cuda.synchronize()
    assert len(pg._PROGRAMS) == 1 and next(iter(pg._PROGRAMS)).batch == 8
    for i, (got, want) in enumerate(outs):
        for k in range(3):
            assert torch.equal(got[k], want[k]), f"batch {i} plane {k}"


@pytest.mark.cuda
def test_program_cache_drops_programs_without_waiting_on_cuda(cuda):
    """More geometries than the cache keeps: the least recent programs are
    dropped once their stream has passed them, with no device-wide wait,
    and every batch stays equal to its eager body."""
    pg.clear_programs()
    params = pattern_zoo(93, n=4)
    results = []
    for h in range(64, 64 + pg.MAX_PROGRAMS + 3):
        planes = _random_planes(np.random.default_rng(h), len(params), h, 96, 10, 1, 1, cuda)
        graph, eager = program_paths(params, planes, 10, 1, 1, False, cuda)
        results.append((graph(), eager()))
    assert len(pg._PROGRAMS) == pg.MAX_PROGRAMS
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(results):
        for k in range(3):
            assert torch.equal(got[k], want[k]), f"geometry {i} plane {k}"
    pg.program_for(next(iter(pg._PROGRAMS)))  # frees what has passed
    assert not pg._RETIRED
    pg.clear_programs()
    assert not pg._PROGRAMS and not pg._RETIRED


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bd", [(np.uint8, 8), (np.uint16, 10)], ids=["8bit", "10bit"])
def test_upload_keeps_a_batch_in_flight_on_cuda(cuda, dtype, bd):
    """``pipelines._upload`` stages into pinned blocks of the caching host
    allocator: a batch whose upload waits behind the stream is not
    overwritten by the next batch's staging; after the warm-up, the next
    batches (two behind the stream, then render's FIFO of one in flight)
    pin no new block;
    ``upload.frames`` counts every frame staged."""
    from grav1synth_tpu_torch import pipelines

    rng = np.random.default_rng(bd)
    batches = [list(rng.integers(0, 1 << bd, (6, 540, 960), dtype=dtype)) for _ in range(10)]
    host_stats = getattr(torch.cuda, "host_memory_stats", dict)

    def check(got, planes, done=None):
        if done is not None:
            done.synchronize()
        assert got.dtype == torch.int16 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), torch.from_numpy(np.stack(planes).astype(np.int16)))

    def behind_the_stream(a, b) -> bool:
        """``a`` uploaded behind about half a second of the stream, then
        ``b`` staged; whether ``a``'s copy had passed by then."""
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 30)
        got_a = pipelines._upload(a, cuda)
        a_passed = torch.cuda.Event()
        a_passed.record()
        got_b = pipelines._upload(b, cuda)
        passed = a_passed.query()
        torch.cuda.synchronize()
        check(got_a, a)
        check(got_b, b)
        return passed

    frames0 = spans.counter("upload.frames")
    # warm-up: the widening kernel loaded (a lazily loaded kernel waits
    # for the stream at its first launch) and device memory cached; then
    # two blocks pinned, so that no allocation below waits for the stream
    check(pipelines._upload(batches[0], cuda), batches[0])
    behind_the_stream(batches[1], batches[2])
    allocs = host_stats().get("num_host_alloc")
    assert not behind_the_stream(batches[3], batches[4]), \
        "the first upload passed before the second was staged"
    pending = []
    for planes in batches[5:]:
        got = pipelines._upload(planes, cuda)
        done = torch.cuda.Event()
        done.record()
        pending.append((got, planes, done))
        if len(pending) > 1:
            check(*pending.pop(0))
    check(*pending.pop())
    assert host_stats().get("num_host_alloc") == allocs
    assert spans.counter("upload.frames") - frames0 == 10 * 6


# --- the tables kernel --------------------------------------------------------

DENSE_Y = [(x, (x * 7 + 13 * (i % 5)) % 256) for i, x in enumerate(range(0, 256, 19))][:14]
# (frames, the bucket whose program runs them)
TABLE_BATCHES = [(1, 1), (5, 8), (16, 16), (112, 128)]
TABLE_GEOMETRIES = [(1080, 1920), (2160, 3840)]


def tables_zoo(seed: int, n: int):
    """``pattern_zoo``'s tables (AR lag 0-3, chroma scaling from luma, no
    luma points, no Cr points, no points at all) with, in turn, the clip to
    the restricted range, luma-only tables, a one-point curve on every
    plane, a 14-point luma curve with the clip, and the overlap off."""
    out = pattern_zoo(seed, n)
    for i, p in enumerate(out):
        kind = i % 7
        if kind == 1:
            p.clip_to_restricted_range = True
        elif kind == 2:
            out[i] = luma_tables([p])[0]
        elif kind == 4:
            p.scaling_points_y, p.scaling_points_cb = [(100, 50)], [(20, 90)]
            p.scaling_points_cr = [(255, 7)]
        elif kind == 5:
            p.scaling_points_y, p.clip_to_restricted_range = DENSE_Y, True
        elif kind == 6:
            p.overlap_flag = False
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_tables_kernel_equals_plain_program_tables_on_cuda(cuda, bd, sub_x, sub_y, mono):
    """The program's tables on the card (the tables kernel: luma rows, Cb|Cr
    rows, block offsets, pattern rows) equal the plain ``program_tables`` on
    the CPU at tolerance 0, with the chroma tables and without, at 1080p and
    4K, for ragged batches of 1, 5, 16 and 112 frames on the whole static
    input of their bucket: the batch's rows, then zeros or another batch's
    rows; and on rows no table makes (points out of order or repeated,
    every count, switches at random), as PyTorch's int32 arithmetic gives
    them. One launch a body."""
    rng = np.random.default_rng(bd)
    raw = torch.from_numpy(rng.integers(0, 256, (16, tg.PARAMS_WIDTH)).astype(np.int32))
    for field, top in (("num_y", 15), ("num_cb", 11), ("num_cr", 11), ("csfl", 2), ("overlap", 2),
                       ("clip", 2)):
        raw[:, tg.PARAM_COLUMNS[field][0]] = torch.from_numpy(rng.integers(0, top, 16).astype(np.int32))
    cases = [(16, 16, "raw", raw)]
    for b, bucket in TABLE_BATCHES:
        batch = tg.pack_params(tables_zoo(100 + b + bd, b), "cpu").buffer
        other = tg.pack_params(tables_zoo(200 + b, bucket), "cpu").buffer
        for past in (torch.zeros_like(other), other):
            buf = past.clone()
            buf[:b] = batch
            cases.append((b, bucket, "zeros past the batch" if past is not other else
                          "another batch past it", buf))
    for b, bucket, kind, buf in cases:
        for h, w in TABLE_GEOMETRIES:
            for chroma_static in (False, True):
                key = pg.ProgramKey(cuda, bucket, h, w, bd, sub_x, sub_y, mono, chroma_static)
                want = pg.program_tables(tg.GrainParamsBatch(buf),
                                         dataclasses.replace(key, device=torch.device("cpu")))
                launched = spans.counter("launch.grain_tables")
                got = pg.program_body(buf.to(cuda), key)
                assert spans.counter("launch.grain_tables") == launched + 1
                what = f"B={b} of {bucket}, {kind}, {h}x{w}, chroma {chroma_static}"
                for name in ("params_y", "params2", "offsets", "rows"):
                    g, wt = getattr(got, name), getattr(want, name)
                    assert (g is None) == (wt is None), (what, name)
                    if wt is not None:
                        assert g.dtype == torch.int32 and g.is_cuda, (what, name)
                        assert torch.equal(g.cpu(), wt), (what, name)
                assert (got.params2 is None) == (mono or not chroma_static), what


@pytest.mark.cuda
@pytest.mark.parametrize("chroma_static", CHROMA_STATIC)
@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
def test_program_graph_is_the_tables_and_pattern_kernels_on_cuda(cuda, sub_x, sub_y, mono,
                                                                  chroma_static):
    """The captured program of every key is two kernel nodes, the tables
    kernel and the pattern kernel (read through libcuda), and at most one
    memset or memcpy; a replay counts one launch of each, and its tables
    equal the plain ``program_tables``."""
    from chip_smoke import graph_nodes

    params = tables_zoo(300 + 2 * sub_x + sub_y + 4 * mono, 5)
    if not chroma_static:
        params = luma_tables(params)
    y = torch.zeros((len(params), 2160, 3840), dtype=torch.int16, device=cuda)
    key = pg.ProgramKey.of(y, 10, sub_x, sub_y, mono, chroma_static)
    pg.clear_programs()
    prog = pg.program_for(key)
    pb = tg.pack_params(params, cuda)
    prog.run(pb)  # captures
    torch.cuda.synchronize()
    nodes = graph_nodes(prog.graph)
    assert nodes.get("kernel") == 2, nodes
    assert nodes["nodes"] - 2 <= 1 and set(nodes) <= {"nodes", "kernel", "memset", "memcpy"}, nodes
    assert prog.kernels == {"grain_tables": 1, "grain_pattern": 1}
    spans.reset()
    out = prog.run(pb)
    torch.cuda.synchronize()
    assert _programs() == {"captures": 0, "replays": 1}
    assert spans.counter("launch.grain_tables") == 1
    assert spans.counter("launch.grain_pattern") == 1
    want = pg.program_tables(tg.GrainParamsBatch(pb.buffer.cpu()),
                             dataclasses.replace(key, device=torch.device("cpu")))
    for name in ("params_y", "params2", "offsets", "rows"):
        g, wt = getattr(out, name), getattr(want, name)
        assert (g is None) == (wt is None), name
        if wt is not None:
            assert torch.equal(g.cpu(), wt), name
    pg.clear_programs()
