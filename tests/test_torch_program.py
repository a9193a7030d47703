"""The apply path's one-buffer parameters and parameter program
(``ops.program``, the counterpart of the JAX package's ``jax.jit``
boundary) against the parent forms and the JAX package, on the CPU.

On the CPU the program runs its body eagerly (on the card it is one
captured CUDA graph, held to the same body by ``chip_smoke.py`` phase 12
and tests/test_torch_cuda.py). Here:

- the one-buffer ``pack_params`` equals the per-field upload it replaced,
  field by field, and ``from_jax_params`` of ``grain_jax.pack_params``
  gives the same buffer;
- the program's outputs equal ``pack_plane_params``, ``block_offsets`` and
  ``pattern_params`` as they were before the program (kept below as the
  reference, with the loop forms of ``_scaling_eval8`` and
  ``lfsr_outputs``), and the broadcast forms equal the loops;
- ``apply_grain`` through the program, with and without the tables'
  chroma fact, and the grain kernels on the program's tables and
  grain_ref's patterns, equal ``grain_jax.apply_grain`` (Pallas in
  interpret mode, the native shim's patterns) and ``grain_ref`` at
  tolerance 0; on tables drawn by the benchmark's own
  ``draw_tables`` (the uhd12_444 cell's 4:4:4 12-bit layout and table
  shape, and generate's luma-only, AR lag 0 shape) the benchmark's path,
  ``pack_params`` then ``apply_grain``, also equals the benchmark's frozen
  ``grain_ref``;
- the program's body, run on the meta device, makes no tensor from host
  data and reads nothing back: what a CUDA graph capture forbids.

Inputs come from numpy seeds. Integer arithmetic: every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from av1_builder import sample_grain_params
from grav1synth_tpu.obu.types import FilmGrainParams as JaxParams
from grav1synth_tpu.ops import grain_jax, grain_ref
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops import grain_kernels as gk
from grav1synth_tpu_torch.ops import program as pg
from grav1synth_tpu_torch.parallel import mesh as tmesh
from grav1synth_tpu_torch.utils import spans

from test_torch_cuda import (
    DENSE_Y, bench_config, bench_module, pattern_zoo, ref_packed, ref_patterns,
    stray_slot_frames, stray_slots,
)

# (id, sub_x, sub_y, mono)
LAYOUTS = [("420", 1, 1, False), ("422", 1, 0, False), ("444", 0, 0, False), ("mono", 1, 1, True)]


def _equal(got, want, what):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    bad = int((got != want).sum())
    assert bad == 0, f"{what}: {bad} mismatching samples"


def mixed_batch(seed: int):
    """``pattern_zoo``'s frames (no luma points, chroma scaling from luma,
    no Cr points, no points at all, all on; AR lag 0-3) beside a luma-only
    frame and one with a dense 14-point luma curve."""
    params = pattern_zoo(seed, n=5)
    luma = sample_grain_params(seed=seed + 1)
    luma.scaling_points_cb, luma.scaling_points_cr = [], []
    luma.ar_coeffs_cb, luma.ar_coeffs_cr = [], []
    dense = sample_grain_params(seed=seed + 2)
    dense.scaling_points_y = DENSE_Y
    dense.scaling_points_cb = DENSE_Y[:10]
    return params + [luma, dense]


def luma_batch(seed: int):
    """Frames with luma points alone (photon-noise style tables)."""
    out = []
    for i in range(3):
        p = sample_grain_params(seed=seed + i)
        p.scaling_points_cb, p.scaling_points_cr = [], []
        p.ar_coeffs_cb, p.ar_coeffs_cr = [], []
        p.overlap_flag = bool(i % 2)
        out.append(p)
    return out


# generate's table shape (``ops/photon_noise.py``): 14 luma points, no
# chroma points, AR lag 0, overlap on
PHOTON_GRAIN = {"y_points": 14, "cb_points": 0, "cr_points": 0, "ar_lag": 0, "overlap": True,
                "chroma_scaling_from_luma": False, "clip_to_restricted_range": False}


def drawn_batch(flags, seed: int = 2**31 + 17):
    """Three tables drawn by the benchmark's own ``draw_tables``, as the JAX
    package's parameters. With ``photon`` in ``flags``, of generate's
    shape; else of the uhd12_444 cell's shape (4 Y, 2 Cb, 2 Cr points, AR
    lag 2), or with ``cell422`` of the uhd10_422 cell's (14 Y, 10 Cb, 10 Cr
    points, AR lag 3), with overlap and clipping on where ``flags`` name
    them, chroma scaled from luma (and no chroma points) with ``cfl``, AR
    lag 3 with ``lag3``. One draw's tables differ only in ``grain_seed``,
    so they make one run of frames sharing a parameter row; with ``runs``
    the last table comes from a second draw, a second run."""
    if "photon" in flags:
        grain = PHOTON_GRAIN
    else:
        cell = "uhd10_422" if "cell422" in flags else "uhd12_444"
        grain = dict(bench_config(cell)["grain"], overlap="overlap" in flags,
                     clip_to_restricted_range="clip" in flags)
        if "cfl" in flags:
            grain.update(cb_points=0, cr_points=0, chroma_scaling_from_luma=True)
        if "lag3" in flags:
            grain["ar_lag"] = 3
    draw = bench_module("inputs").draw_tables
    tables = draw(seed, grain, 3)
    if "runs" in flags:
        tables[2:] = draw(seed + 1, grain, 1)
    return [JaxParams(**t) for t in tables]


def frames(b, h, w, bd, sub_x, sub_y, mono, seed):
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    y = rng.integers(0, maxv + 1, (b, h, w)).astype(np.int16)
    if mono:
        return y, None, None
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    cb = rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)
    cr = rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)
    return y, cb, cr


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test processes side by side; one torch thread
    keeps this file's many small ops (the plain pattern generator's
    wavefront loop above all) from spinning against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The parent forms, kept as the reference: the per-field upload, the loop
# forms of the LFSR and the LUT, and the table functions that used them.


def _lag_offsets(lag):
    out = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            out.append((dr, dc))
    return out


_SLOT = {off: i for i, off in enumerate(_lag_offsets(3))}


def parent_scatter(coeffs, lag):
    out = np.zeros(24, dtype=np.int32)
    for c, off in zip(coeffs, _lag_offsets(lag)):
        out[_SLOT[off]] = c
    return out


def parent_pack_params(params, device):
    """Each field built in numpy and uploaded on its own."""
    b = len(params)

    def pad_points(pts, n):
        out = np.zeros((b, n, 2), dtype=np.int32)
        for i, p in enumerate(pts):
            if p:
                arr = np.asarray(p, dtype=np.int32)
                out[i, : len(p)] = arr
                out[i, len(p) :] = arr[-1]
        return out

    def arr(get):
        return np.asarray([get(p) for p in params], dtype=np.int32)

    def chroma_coeffs(get_coeffs, active):
        out = np.zeros((b, 25), dtype=np.int32)
        for i, p in enumerate(params):
            cs = get_coeffs(p)
            if not active(p) or not cs:
                continue
            n_spatial = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
            out[i, :24] = parent_scatter(cs[:n_spatial], p.ar_coeff_lag)
            if len(p.scaling_points_y) > 0 and len(cs) > n_spatial:
                out[i, 24] = cs[n_spatial]
        return out

    host = dict(
        seed=arr(lambda p: p.grain_seed),
        num_y=arr(lambda p: len(p.scaling_points_y)),
        num_cb=arr(lambda p: len(p.scaling_points_cb)),
        num_cr=arr(lambda p: len(p.scaling_points_cr)),
        pts_y=pad_points([p.scaling_points_y for p in params], 14),
        pts_cb=pad_points([p.scaling_points_cb for p in params], 10),
        pts_cr=pad_points([p.scaling_points_cr for p in params], 10),
        coeffs_y=np.stack([parent_scatter(p.ar_coeffs_y, p.ar_coeff_lag) for p in params]),
        coeffs_cb=chroma_coeffs(lambda p: p.ar_coeffs_cb,
                                lambda p: p.chroma_scaling_from_luma or len(p.scaling_points_cb) > 0),
        coeffs_cr=chroma_coeffs(lambda p: p.ar_coeffs_cr,
                                lambda p: p.chroma_scaling_from_luma or len(p.scaling_points_cr) > 0),
        scaling_shift=arr(lambda p: p.scaling_shift),
        ar_shift=arr(lambda p: p.ar_coeff_shift),
        grain_scale_shift=arr(lambda p: p.grain_scale_shift),
        cb_mult=arr(lambda p: p.cb_mult),
        cb_luma_mult=arr(lambda p: p.cb_luma_mult),
        cb_offset=arr(lambda p: p.cb_offset),
        cr_mult=arr(lambda p: p.cr_mult),
        cr_luma_mult=arr(lambda p: p.cr_luma_mult),
        cr_offset=arr(lambda p: p.cr_offset),
        csfl=arr(lambda p: int(p.chroma_scaling_from_luma)),
        overlap=arr(lambda p: int(p.overlap_flag)),
        clip=arr(lambda p: int(p.clip_to_restricted_range)),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


def parent_lfsr_basis(n):
    out = np.empty((n, 16), dtype=np.int32)
    for j in range(16):
        lf = grain_ref.Lfsr(1 << j)
        for k in range(n):
            lf.bits(16)
            out[k, j] = lf.state
    return out


def parent_lfsr_outputs(seeds, n, nbits):
    basis = torch.as_tensor(parent_lfsr_basis(n), device=seeds.device)
    seeds = seeds.to(torch.int32)
    state = torch.zeros((seeds.shape[0], n), dtype=torch.int32, device=seeds.device)
    for j in range(16):
        bit = (seeds >> j) & 1
        state ^= basis[None, :, j] * bit[:, None]
    return (state >> (16 - nbits)) & ((1 << nbits) - 1)


def parent_block_offsets(seed, num_stripes, blocks):
    s = torch.arange(num_stripes, dtype=torch.int32, device=seed.device)
    rr = seed.to(torch.int32)[:, None]
    rr = rr ^ (((s * 37 + 178) & 255) << 8)[None, :]
    rr = rr ^ ((s * 173 + 105) & 255)[None, :]
    outs = parent_lfsr_outputs(rr.reshape(-1), blocks, 8)
    return outs.reshape(seed.shape[0], num_stripes, blocks)


def parent_scaling_eval8(v, pts, num, n_seg=13):
    b, p_max, _ = pts.shape
    x_j = pts[:, :, 0]
    y_j = pts[:, :, 1]
    dx = x_j[:, 1:] - x_j[:, :-1]
    dy = y_j[:, 1:] - y_j[:, :-1]
    dx_safe = torch.clamp(dx, min=1)
    delta = dy * torch.div(65536 + (dx_safe >> 1), dx_safe, rounding_mode="floor")
    seg_idx = torch.arange(p_max - 1, device=pts.device)[None, :]
    seg_valid = (seg_idx < (num[:, None] - 1)) & (dx > 0)
    shape = v.shape
    vflat = v.reshape(b, -1)
    val = torch.zeros_like(vflat)
    for j in range(min(n_seg, p_max - 1)):
        in_seg = (
            (vflat >= x_j[:, j : j + 1])
            & (vflat < x_j[:, j + 1 : j + 2])
            & seg_valid[:, j : j + 1]
        )
        seg_val = y_j[:, j : j + 1] + (
            ((vflat - x_j[:, j : j + 1]) * delta[:, j : j + 1] + 32768) >> 16
        )
        val = torch.where(in_seg, seg_val, val)
    last = torch.clamp(num - 1, min=0)[:, None].long()
    below = vflat < x_j[:, :1]
    above = vflat >= torch.gather(x_j, 1, last)
    val = torch.where(below, y_j[:, :1], val)
    val = torch.where(above, torch.gather(y_j, 1, last), val)
    val = val * (num > 0).to(val.dtype)[:, None]
    return val.reshape(shape)


def parent_pack_plane_params(p, plane, bit_depth, n_seg=13):
    maxval = (1 << bit_depth) - 1
    grain_center = 128 << (bit_depth - 8)
    clip = p.clip > 0
    zero = torch.zeros_like(p.seed)
    if plane == "y":
        active = p.num_y > 0
        num, pts = p.num_y, p.pts_y
        hi = torch.where(clip, zero + (235 << (bit_depth - 8)), zero + maxval)
        use_mult = mult = luma_mult = offset = zero
    else:
        num_own = p.num_cb if plane == "cb" else p.num_cr
        pts_own = p.pts_cb if plane == "cb" else p.pts_cr
        csfl = p.csfl > 0
        active = csfl | (num_own > 0)
        num = torch.where(csfl, p.num_y, num_own)
        pts_own = torch.nn.functional.pad(pts_own, (0, 0, 0, 14 - pts_own.shape[1]))
        pts = torch.where(csfl[:, None, None], p.pts_y, pts_own)
        hi = torch.where(clip, zero + (240 << (bit_depth - 8)), zero + maxval)
        use_mult = (~csfl).to(torch.int32)
        if plane == "cb":
            mult, luma_mult, offset = p.cb_mult, p.cb_luma_mult, p.cb_offset
        else:
            mult, luma_mult, offset = p.cr_mult, p.cr_luma_mult, p.cr_offset
    lo = torch.where(clip, zero + (16 << (bit_depth - 8)), zero)
    out = torch.zeros((p.batch, gk.P_LEN), dtype=torch.int32, device=p.device)
    out[:, gk.P_ACTIVE] = active.to(torch.int32)
    out[:, gk.P_SCALING_SHIFT] = p.scaling_shift
    out[:, gk.P_OVERLAP] = p.overlap
    out[:, gk.P_CLIP_LO] = lo
    out[:, gk.P_CLIP_HI] = hi
    out[:, gk.P_GMIN] = -grain_center
    out[:, gk.P_GMAX] = grain_center - 1
    out[:, gk.P_USE_MULT] = use_mult
    out[:, gk.P_MULT] = mult
    out[:, gk.P_LUMA_MULT] = luma_mult
    out[:, gk.P_OFFSET] = offset
    nodes = torch.arange(256, dtype=torch.int32, device=pts.device)
    out[:, gk.P_LUT:] = parent_scaling_eval8(nodes.expand(p.batch, 256), pts, num, n_seg)
    return out


def parent_pattern_params(p):
    has_y = (p.num_y > 0).to(torch.int32)
    cb_on = ((p.num_cb > 0) | (p.csfl > 0)).to(torch.int32)
    cr_on = ((p.num_cr > 0) | (p.csfl > 0)).to(torch.int32)
    head = torch.stack(
        [
            p.seed, has_y, cb_on, cr_on, p.ar_shift, p.grain_scale_shift,
            p.coeffs_cb[:, 24] * cb_on * has_y, p.coeffs_cr[:, 24] * cr_on * has_y,
        ],
        1,
    )
    rows = torch.cat(
        [
            head, p.coeffs_y, p.coeffs_cb[:, :24] * cb_on[:, None],
            p.coeffs_cr[:, :24] * cr_on[:, None],
        ],
        1,
    )
    return rows.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# One buffer


@pytest.mark.parametrize("batch", ["mixed", "lags", "luma"])
def test_one_buffer_pack_params_equals_per_field_upload(batch):
    params = {"mixed": mixed_batch(3), "lags": pattern_zoo(17, n=9), "luma": luma_batch(5)}[batch]
    pb = tg.pack_params(params, "cpu")
    want = parent_pack_params(params, "cpu")
    assert tuple(pb.buffer.shape) == (len(params), tg.PARAMS_WIDTH)
    assert pb.buffer.dtype == torch.int32 and pb.buffer.is_contiguous()
    assert list(tg.PARAM_COLUMNS) == list(want)
    for name, w in want.items():
        got = getattr(pb, name)
        assert got.dtype == torch.int32 and got.shape == w.shape, name
        assert got.untyped_storage().data_ptr() == pb.buffer.untyped_storage().data_ptr(), name
        _equal(got, w, name)
    jb = tg.from_jax_params(grain_jax.pack_params(params), "cpu")
    assert torch.equal(jb.buffer, pb.buffer)


def test_buffer_follows_in_place_edits_and_replaced_fields():
    """In-place edits of a field land in the buffer, the batch's only
    storage; a field cannot be replaced, and a batch is made only from a
    buffer of the layout's width."""
    pb = tg.pack_params(stray_slot_frames(), "cpu")
    stray_slots(pb)
    start = tg.PARAM_COLUMNS["coeffs_cb"][0]
    assert int(pb.buffer[1, start + 6]) == -90
    pb.clip[:] ^= 1
    _equal(pb.buffer[:, -1], pb.clip, "clip edited in place")
    with pytest.raises(AttributeError):
        pb.seed = pb.seed + 1
    with pytest.raises(AttributeError):
        pb.extra = 1  # nothing beside the buffer and its chroma fact
    for bad in (pb.buffer[:, 1:], pb.buffer.to(torch.int64), pb.buffer[0]):
        with pytest.raises(ValueError, match="parameter buffer"):
            tg.GrainParamsBatch(bad)


@pytest.mark.parametrize("luma_only", [False, True], ids=["chroma", "luma-only"])
def test_shard_params_move_buffer_rows(luma_only):
    """A shard of a parameter batch is its buffer's rows, one copy, with
    every field a view of the copy, and the batch's chroma fact."""
    params = pattern_zoo(23, n=6)
    if luma_only:
        params = [dataclasses.replace(p, scaling_points_cb=[], scaling_points_cr=[],
                                      chroma_scaling_from_luma=False) for p in params]
    pb = tg.pack_params(params, "cpu")
    assert pb.touches_chroma != luma_only
    shard = tmesh._shard_params(pb, slice(2, 5), torch.device("cpu"))
    assert torch.equal(shard.buffer, pb.buffer[2:5])
    assert shard.touches_chroma == pb.touches_chroma
    want = tg.pack_params(params[2:5], "cpu")
    for name in tg.PARAM_COLUMNS:
        _equal(getattr(shard, name), getattr(want, name), name)


# ---------------------------------------------------------------------------
# The broadcast forms against the loops


def _curves(rng, b, most=14):
    """(pts, num) int32: random curves of up to ``most`` points (the first
    has that many), with repeated and decreasing x among them."""
    pts = np.zeros((b, 14, 2), dtype=np.int32)
    num = rng.integers(0, most + 1, b).astype(np.int32)
    num[0] = most
    for i in range(b):
        n = int(num[i])
        if i % 3 == 0:
            xs = np.sort(rng.choice(256, n, replace=False)) if n else np.zeros(0, int)
        else:
            xs = rng.integers(0, 256, n)  # repeated and decreasing x
        pts[i, :n, 0] = xs
        pts[i, :n, 1] = rng.integers(0, 256, n)
        if n:
            pts[i, n:] = pts[i, n - 1]
    return torch.from_numpy(pts), torch.from_numpy(num)


@pytest.mark.parametrize("n_seg", range(1, 14))
def test_scaling_eval8_broadcast_equals_loop(n_seg):
    """Batches whose curves have at most ``n_seg`` segments: the broadcast
    over every segment equals the loop bounded by the batch's ``n_seg`` (as
    the parent's tables ran it) and the loop over all 13."""
    rng = np.random.default_rng(n_seg)
    pts, num = _curves(rng, 24, most=n_seg + 1)
    nodes = torch.arange(256, dtype=torch.int32).expand(24, 256)
    want = parent_scaling_eval8(nodes, pts, num, n_seg)
    _equal(want, parent_scaling_eval8(nodes, pts, num), "loop: n_seg against 13")
    _equal(tg._scaling_eval8(nodes, pts, num), want, "LUT")
    _equal(tg.scaling_lut(pts, num), want, "scaling_lut")
    # planes wider than one chunk of the broadcast (2^24 segment tests)
    if n_seg in (1, 13):
        v = torch.from_numpy(rng.integers(0, 256, (24, 3, 30000)).astype(np.int32))
        _equal(tg._scaling_eval8(v, pts, num), parent_scaling_eval8(v, pts, num, n_seg),
               "chunked planes")


@pytest.mark.parametrize("n,nbits", [(1, 8), (120, 8), (73 * 82, 11), (38 * 44, 11)])
def test_lfsr_outputs_broadcast_equals_loop(n, nbits):
    seeds = torch.from_numpy(
        np.concatenate([[0, 1, 0xFFFF, 0xB524], np.random.default_rng(n).integers(0, 1 << 16, 29)])
        .astype(np.int32)
    )
    _equal(tg.lfsr_outputs(seeds, n, nbits), parent_lfsr_outputs(seeds, n, nbits), "lfsr")


# ---------------------------------------------------------------------------
# The program's outputs against the parent table functions


@pytest.mark.parametrize("layout,sub_x,sub_y,mono", LAYOUTS, ids=[c[0] for c in LAYOUTS])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_program_outputs_equal_parent_tables(bd, layout, sub_x, sub_y, mono):
    params = mixed_batch(10 * bd + sub_x + 2 * sub_y + 4 * mono)
    pb = tg.pack_params(params, "cpu")
    h, w = 70, 130
    # the segment bound the parent's tables ran with (the JAX package's)
    n_seg, chroma_static = grain_jax._host_metadata(params, mono)
    assert chroma_static and tg._touches_chroma(params)
    offs = parent_block_offsets(pb.seed, 3, 5)
    y_rows = parent_pack_plane_params(pb, "y", bd, n_seg)
    c_rows = torch.cat([parent_pack_plane_params(pb, pl, bd, n_seg) for pl in ("cb", "cr")])

    def check(out, key):
        what = f"chroma {key.chroma_static}"
        _equal(out.offsets, offs, f"{what}: offsets")
        _equal(out.params_y, y_rows, f"{what}: luma rows")
        if mono or not key.chroma_static:
            assert out.params2 is None, what
        else:
            _equal(out.params2, c_rows, f"{what}: Cb|Cr rows")
        _equal(out.rows, parent_pattern_params(pb), f"{what}: pattern rows")

    y = torch.zeros((len(params), h, w), dtype=torch.int16)
    keys = [pg.ProgramKey.of(y, bd, sub_x, sub_y, mono, cs) for cs in (True, False)]
    for key in keys:
        check(pg.program_tables(pb, key), key)
    if bd != 10:  # the plain pattern generator is slow; whole runs at one bit depth a layout
        return
    # a whole run, the pattern kernel's plain version in it, its patterns
    # against grain_ref's; a second run makes new outputs
    card = pg.program_for(keys[0]).run(pb)
    check(card, keys[0])
    assert card.patterns.dtype == torch.int16
    assert torch.equal(card.patterns, ref_packed(params, bd, sub_x, sub_y, mono))
    again = pg.program_for(keys[0]).run(pb)
    assert again.params_y is not card.params_y and torch.equal(again.params_y, card.params_y)


@pytest.mark.parametrize("chroma", [pytest.param(True, id="chroma"),
                                    pytest.param(False, id="luma-only")])
def test_tables_wrapper_takes_the_plain_version_on_the_cpu(chroma):
    """``grain_tables`` on a CPU buffer is its plain version, the program's
    tables, with no kernel launched; a buffer of another dtype or width, or
    another bit depth, is refused before anything runs."""
    pb = tg.pack_params(mixed_batch(6), "cpu")
    y = torch.zeros((len(pb.seed), 70, 130), dtype=torch.int16)
    key = pg.ProgramKey.of(y, 12, 1, 1, False, chroma)
    launched = spans.counter("launch.grain_tables")
    got = gk.grain_tables(pb.buffer, 70, 130, 12, chroma)
    want = pg.program_tables(pb, key)
    assert spans.counter("launch.grain_tables") == launched
    assert (got[1] is None) == (not chroma)
    for g, (name, w) in zip(got, [(n, getattr(want, n))
                                  for n in ("params_y", "params2", "offsets", "rows")]):
        if w is not None:
            _equal(g, w, name)
    with pytest.raises(TypeError, match="int32"):
        gk.grain_tables(pb.buffer.to(torch.int64), 70, 130, 12, chroma)
    with pytest.raises(ValueError, match="expected shape"):
        gk.grain_tables(pb.buffer[:, 1:], 70, 130, 12, chroma)
    with pytest.raises(ValueError, match="expected shape"):
        gk.grain_tables(pb.buffer[0], 70, 130, 12, chroma)
    with pytest.raises(ValueError, match="bit depth"):
        gk.grain_tables(pb.buffer, 70, 130, 9, chroma)


def test_program_refuses_a_batch_it_was_not_made_for():
    pb = tg.pack_params(pattern_zoo(2, n=3), "cpu")
    key = pg.ProgramKey(torch.device("cpu"), 2, 64, 64, 10, 1, 1, False, True)
    with pytest.raises(ValueError, match="does not fit the program"):
        pg.GrainProgram(key).run(pb)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        pg.GrainProgram(dataclasses.replace(key, device=torch.device("meta")))


def test_program_cache_keeps_the_most_recent():
    pg.clear_programs()
    keys = [pg.ProgramKey(torch.device("cpu"), 2, 64, h, 10, 1, 1, False, True)
            for h in range(64, 64 + pg.MAX_PROGRAMS + 2)]
    progs = [pg.program_for(k) for k in keys]
    assert pg.program_for(keys[2]) is progs[2]  # now the most recent
    pg.program_for(keys[0])  # made again: the least recent (keys[3]) goes
    assert len(pg._PROGRAMS) == pg.MAX_PROGRAMS
    assert keys[3] not in pg._PROGRAMS and keys[2] in pg._PROGRAMS
    assert pg.program_for(keys[-1]) is progs[-1]
    pg.clear_programs()
    assert not pg._PROGRAMS


@pytest.mark.parametrize("b,bucket", [(0, 1), (1, 1), (2, 2), (3, 4), (5, 8), (16, 16),
                                      (17, 32), (112, 128)])
def test_program_key_rounds_the_batch_up_to_a_power_of_two(b, bucket):
    """Batches of 9 to 16 frames share one program, and so on: a stream's
    batches make a few programs, not one per batch size. Monochrome keys
    never make chroma tables, whatever the caller says."""
    assert pg.batch_bucket(b) == bucket
    y = torch.zeros((b, 8, 8), dtype=torch.int16)
    key = pg.ProgramKey.of(y, 10, 1, 1, False, True)
    assert key.batch == bucket and key.chroma_static
    assert pg.ProgramKey.of(y, 10, 1, 1, True, True) == pg.ProgramKey.of(y, 10, 1, 1, True, False)


@pytest.mark.parametrize("layout,sub_x,sub_y,mono", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_program_rows_past_the_batch_touch_nothing(layout, sub_x, sub_y, mono):
    """On the card a batch fills the first rows of its program's static
    input and the rest keep zeros or an earlier batch's frames. The body on
    such a padded buffer, cut to the batch (``ProgramOutputs.first``),
    equals the body on the batch alone, the Cb|Cr rows included."""
    params = mixed_batch(30 + sub_x + 2 * sub_y)
    b = len(params)
    n = pg.batch_bucket(b)
    assert n > b
    pb = tg.pack_params(params, "cpu")
    other = tg.pack_params(pattern_zoo(31, n=n), "cpu").buffer
    y = torch.zeros((b, 40, 70), dtype=torch.int16)
    key = pg.ProgramKey.of(y, 10, sub_x, sub_y, mono, True)

    def body(buf):
        # the plain pattern generator is slow: its rows on every layout,
        # the patterns themselves on one
        if layout == "420":
            return pg.program_body(buf, key)
        return pg.program_tables(tg.GrainParamsBatch(buf), key)

    want = body(pb.buffer)
    for pad in (torch.zeros_like(other), other):
        padded = pad.clone()
        padded[:b] = pb.buffer
        got = body(padded).first(b)
        for name in ("params_y", "params2", "offsets", "rows", "patterns"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if w is not None:
                _equal(g, w, name)
    assert want.first(b).params_y.shape[0] == b


# ---------------------------------------------------------------------------
# The apply through the program against the JAX package and grain_ref

# (id, sub_x, sub_y, mono, bit_depth, h, w, batch)
APPLY_CASES = [
    ("420-10-64x96-mixed", 1, 1, False, 10, 64, 96, "mixed"),
    ("422-8-40x70-mixed", 1, 0, False, 8, 40, 70, "mixed"),
    ("444-12-33x64-mixed", 0, 0, False, 12, 33, 64, "mixed"),
    ("mono-8-64x64-mixed", 1, 1, True, 8, 64, 64, "mixed"),
    ("420-12-70x130-mixed", 1, 1, False, 12, 70, 130, "mixed"),
    ("420-10-64x64-luma", 1, 1, False, 10, 64, 64, "luma"),
    # the uhd12_444 cell's layout, depth and table shape, B = 3
    ("444-12-71x134-cell-overlap-clip", 0, 0, False, 12, 71, 134, "cell overlap clip"),
    ("444-12-71x134-cell-overlap", 0, 0, False, 12, 71, 134, "cell overlap"),
    ("444-12-71x134-cell-clip", 0, 0, False, 12, 71, 134, "cell clip"),
    ("444-12-71x134-cell", 0, 0, False, 12, 71, 134, "cell"),
    ("444-12-71x134-cell-cfl", 0, 0, False, 12, 71, 134, "cell overlap cfl"),
    ("444-12-71x134-cell-lag3", 0, 0, False, 12, 71, 134, "cell overlap lag3"),
    # the uhd10_422 cell's layout, depth and table shape, B = 3, at an even
    # and an odd size: one run of frames sharing a row, and two runs
    ("422-10-70x100-cell422-overlap-clip", 1, 0, False, 10, 70, 100, "cell422 overlap clip"),
    ("422-10-70x100-cell422-overlap", 1, 0, False, 10, 70, 100, "cell422 overlap"),
    ("422-10-70x100-cell422-overlap-clip-runs", 1, 0, False, 10, 70, 100,
     "cell422 overlap clip runs"),
    ("422-10-41x527-cell422-overlap-clip", 1, 0, False, 10, 41, 527, "cell422 overlap clip"),
    ("422-10-41x527-cell422-overlap", 1, 0, False, 10, 41, 527, "cell422 overlap"),
    ("422-10-41x527-cell422-overlap-clip-runs", 1, 0, False, 10, 41, 527,
     "cell422 overlap clip runs"),
    # generate's table shape: at 4:4:4 12-bit, and at 1080p8's layout and depth
    ("444-12-71x134-photon", 0, 0, False, 12, 71, 134, "photon"),
    ("420-8-67x120-photon", 1, 1, False, 8, 67, 120, "photon"),
]

# batches whose tables touch no chroma: the chroma kernel is skipped where
# the batch comes from pack_params
LUMA_ONLY = ("luma", "photon")


def _batch(kind, seed):
    if kind == "mixed":
        return mixed_batch(seed)
    if kind == "luma":
        return luma_batch(seed)
    return drawn_batch(kind.split())


@pytest.mark.parametrize(
    "sub_x,sub_y,mono,bd,h,w,batch", [c[1:] for c in APPLY_CASES], ids=[c[0] for c in APPLY_CASES]
)
def test_apply_through_program_matches_jax_and_ref(sub_x, sub_y, mono, bd, h, w, batch):
    params = _batch(batch, bd + h)
    y, cb, cr = frames(len(params), h, w, bd, sub_x, sub_y, mono, seed=bd * 7 + h)
    jb = grain_jax.pack_params(params)
    rows, n = spans.counter("pack.rows"), spans.counter("pack.frames")
    pb = tg.pack_params(params, "cpu")
    assert pb.touches_chroma == (batch not in LUMA_ONLY)
    if batch not in ("mixed", "luma"):
        # a parameter row a run of frames sharing a table
        assert spans.counter("pack.frames") - n == 3
        assert spans.counter("pack.rows") - rows == (2 if "runs" in batch else 1)
    cb_t, cr_t = _t(cb), _t(cr)
    key = pg.ProgramKey.of(_t(y), bd, sub_x, sub_y, mono, pb.touches_chroma)
    outs = {
        # the grain kernels on the program's tables and grain_ref's patterns
        "given patterns": tg.apply_with_tables(
            _t(y), cb_t, cr_t, pg.program_tables(pb, key),
            ref_patterns(params, bd, sub_x, sub_y, mono), bd, sub_x, sub_y, mono),
        # a bare buffer: the chroma tables and kernel on, whatever the tables
        "card patterns, JAX's buffer": tg.apply_grain(
            _t(y), cb_t, cr_t, tg.from_jax_params(jb, "cpu"), bd, sub_x, sub_y, mono),
        # render's and the benchmark's path: pack_params (the tables' chroma
        # fact), then apply_grain, card patterns
        "card patterns, packed": tg.apply_grain(_t(y), cb_t, cr_t, pb, bd, sub_x, sub_y, mono),
    }
    want = grain_jax.apply_grain(y, cb, cr, jb, bd, sub_x, sub_y, mono, backend="pallas",
                                 host_params=params)
    nplanes = 1 if mono else 3
    if batch in LUMA_ONLY:  # the chroma kernel skipped: cb/cr returned as they came
        for what in ("given patterns", "card patterns, packed"):
            assert outs[what][1] is cb_t and outs[what][2] is cr_t, what
    for what, out in outs.items():
        assert all(o is None for o in out[nplanes:]), what
        for k in range(nplanes):
            _equal(out[k], want[k], f"{what}: grain_jax plane {k}")
    planes = [y, cb, cr][:nplanes]
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame([pl[i].astype(np.int32) for pl in planes], p, bd,
                                          sub_x, sub_y)
        for k in range(nplanes):
            _equal(outs["card patterns, packed"][k][i], ref[k],
                   f"grain_ref frame {i} plane {k}")
    if batch not in ("mixed", "luma"):
        # the frozen reference that decides the cell's ``correct``
        bench_ref = bench_module("reference.grain_ref")
        ref_params = bench_module("reference.types").FilmGrainParams
        for i, p in enumerate(params):
            ref = bench_ref.apply_grain_frame([pl[i].astype(np.int32) for pl in planes],
                                              ref_params(**dataclasses.asdict(p)), bd, sub_x, sub_y)
            for k in range(nplanes):
                _equal(outs["card patterns, packed"][k][i], ref[k],
                       f"benchmark grain_ref frame {i} plane {k}")


# ---------------------------------------------------------------------------
# Capture safety


class NoHostTensors(TorchDispatchMode):
    """Fails any op with a CPU tensor among its arguments or its results:
    a tensor made from host data, or a read back. Scalars are no tensors."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def on_cpu(tree):
            return any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                       for t in tree_flatten(tree)[0])

        if on_cpu((args, kwargs)):
            raise AssertionError(f"{func}: a CPU tensor among its arguments")
        out = func(*args, **kwargs)
        if on_cpu(out):
            raise AssertionError(f"{func}: a CPU tensor among its results")
        return out


def test_no_host_tensors_mode_catches_uploads_and_read_backs():
    x = torch.zeros(4, device="meta", dtype=torch.int32)
    with NoHostTensors():
        x + 1
        with pytest.raises(AssertionError, match="CPU tensor"):
            torch.as_tensor(np.arange(4), device="meta")
    with NoHostTensors(), pytest.raises((AssertionError, NotImplementedError, RuntimeError)):
        x.sum().item()


@pytest.mark.parametrize("chroma_static", [pytest.param(True, id="device"),
                                           pytest.param(False, id="luma-only")])
@pytest.mark.parametrize("layout,sub_x,sub_y,mono", [LAYOUTS[0], LAYOUTS[3]],
                         ids=[LAYOUTS[0][0], LAYOUTS[3][0]])
def test_program_body_is_capture_safe(layout, sub_x, sub_y, mono, chroma_static):
    """The program's body on a meta-device buffer, after one warm-up run
    (as the card warms up before capturing), under a mode that fails on any
    CPU tensor: nothing is made from host data and nothing is read back,
    with the Cb|Cr rows and without. The pattern kernel's launch is left
    out (the meta device has no kernels); its rows are in."""
    params = mixed_batch(4)
    buf = tg.pack_params(params, "cpu").buffer.to("meta")
    key = pg.ProgramKey(torch.device("meta"), len(params), 2160, 3840, 10, sub_x, sub_y, mono,
                        chroma_static)
    p = tg.GrainParamsBatch(buf)
    pg.program_tables(p, key)  # warm-up: fills the LFSR basis cache
    with NoHostTensors():
        out = pg.program_tables(tg.GrainParamsBatch(buf), key)
    assert out.offsets.device.type == "meta"
    assert tuple(out.offsets.shape) == (len(params), 68, 120)
    assert tuple(out.params_y.shape) == (len(params), gk.P_LEN)
    assert (out.params2 is None) == (mono or not chroma_static)
    assert tuple(out.rows.shape) == (len(params), gk.Q_LEN) and out.rows.device.type == "meta"
