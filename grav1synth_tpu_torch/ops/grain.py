"""AV1 film grain application in PyTorch (counterpart of
grav1synth_tpu/ops/grain_jax.py).

A batch's parameters travel as one (B, ``PARAMS_WIDTH``) int32 buffer
(``GrainParamsBatch``: every field is a view of it), built on the host
one row per run of frames whose tables are equal but for the seed, and
uploaded in one pinned, non-blocking copy.

``apply_grain`` runs each batch as one parameter program
(``ops.program``, the counterpart of the JAX package's ``jax.jit``
boundary): the per-plane parameter tables, the block offsets and the
pattern kernel of ``grain_kernels``, which writes the batch's grain
patterns as one packed int16 buffer (``generate_patterns`` is its plain
version), replayed as one CUDA graph on the card and run eagerly on the
CPU. The per-pixel work then runs in the two CUDA kernels of
``grain_kernels`` (luma, then Cb+Cr in one pass). Everything here is
integer arithmetic and bit-exact against ``grain_ref`` (itself validated
against dav1d).

``apply_grain_reference`` is the plain PyTorch version of the whole
apply, written from the same pieces as the JAX package's XLA
formulation: ``_noise_plane``, ``scaling_lookup``, ``_avg_luma``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obu.types import FilmGrainParams
from ..utils import spans
from . import grain_ref
from .tables_data import GAUSSIAN_SEQUENCE

GRAIN_W = 82
GRAIN_H = 73
CHROMA_W_420 = 44
CHROMA_H_420 = 38
BLOCK = 32
MAX_Y_POINTS = 14
MAX_UV_POINTS = 10

# AR lag-3 neighbour slots in spec scan order (deltaRow -3..0, deltaCol
# -3..3, stopping at (0,0)); lower-lag coefficient lists are scattered
# into these slots so one layout serves every lag.
LAG3_OFFSETS: Tuple[Tuple[int, int], ...] = tuple(
    (dr, dc)
    for dr in range(-3, 1)
    for dc in range(-3, 4)
    if not (dr == 0 and dc >= 0)
)
_LAG3_SLOT = {off: i for i, off in enumerate(LAG3_OFFSETS)}


def _lag_offsets(lag: int) -> List[Tuple[int, int]]:
    out = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            out.append((dr, dc))
    return out


@functools.lru_cache(maxsize=None)
def _lag3_slots(lag: int) -> Tuple[int, ...]:
    """The lag-3 slot of each lag-N coefficient, in scan order."""
    return tuple(_LAG3_SLOT[off] for off in _lag_offsets(lag))


# ---------------------------------------------------------------------------
# Batched parameters


# the fields of a parameter batch, in the buffer's column order, with the
# per-frame shape of each that is not a scalar
_PARAM_FIELDS: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("seed", ()), ("num_y", ()), ("num_cb", ()), ("num_cr", ()),
    ("pts_y", (MAX_Y_POINTS, 2)),  # padded with the last point
    ("pts_cb", (MAX_UV_POINTS, 2)), ("pts_cr", (MAX_UV_POINTS, 2)),
    ("coeffs_y", (24,)),  # in lag-3 slots
    ("coeffs_cb", (25,)), ("coeffs_cr", (25,)),  # 24 slots + luma coefficient
    ("scaling_shift", ()), ("ar_shift", ()), ("grain_scale_shift", ()),
    ("cb_mult", ()), ("cb_luma_mult", ()), ("cb_offset", ()),
    ("cr_mult", ()), ("cr_luma_mult", ()), ("cr_offset", ()),
    ("csfl", ()), ("overlap", ()), ("clip", ()),  # 0/1
)


def _numel(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _column_layout() -> Tuple[Dict[str, Tuple[int, Tuple[int, ...]]], int]:
    out, start = {}, 0
    for name, shape in _PARAM_FIELDS:
        out[name] = (start, shape)
        start += _numel(shape)
    return out, start


# field -> (first column, per-frame shape) in the parameter buffer;
# PARAMS_WIDTH columns in all
PARAM_COLUMNS, PARAMS_WIDTH = _column_layout()


class GrainParamsBatch:
    """Per-frame grain parameters of a batch: one (B, ``PARAMS_WIDTH``)
    int32 ``buffer``, so the batch uploads, slices and moves as one
    tensor. Each field of ``PARAM_COLUMNS`` (``seed``, ``pts_y``, ...) is
    a read-only property giving a view of its columns, (B,) or
    (B, *shape); an in-place edit of a view is an edit of the buffer.

    ``touches_chroma``, a host bool, says whether some frame's table
    touches chroma (``pack_params`` sets it from the tables; a batch made
    from a bare buffer is taken to). ``apply_grain`` skips the chroma
    tables and kernel of a batch that does not."""

    __slots__ = ("buffer", "touches_chroma")

    def __init__(self, buffer: torch.Tensor, touches_chroma: bool = True):
        if buffer.dim() != 2 or buffer.shape[1] != PARAMS_WIDTH or buffer.dtype != torch.int32:
            raise ValueError(
                f"a parameter buffer is (B, {PARAMS_WIDTH}) int32, got "
                f"{tuple(buffer.shape)} {buffer.dtype}"
            )
        self.buffer = buffer
        self.touches_chroma = bool(touches_chroma)

    @property
    def batch(self) -> int:
        return self.buffer.shape[0]

    @property
    def device(self) -> torch.device:
        return self.buffer.device


def _column_view(start: int, shape: Tuple[int, ...]) -> property:
    if not shape:
        return property(lambda self: self.buffer[:, start])
    stop = start + _numel(shape)
    return property(lambda self: self.buffer[:, start:stop].view(self.buffer.shape[0], *shape))


for _name, (_start, _shape) in PARAM_COLUMNS.items():
    setattr(GrainParamsBatch, _name, _column_view(_start, _shape))


def _upload(host: np.ndarray, device, touches_chroma: bool = True) -> GrainParamsBatch:
    """A (B, ``PARAMS_WIDTH``) int32 host buffer as a batch on ``device``:
    one copy, pinned and non-blocking on a CUDA device."""
    buf = torch.from_numpy(host)
    device = torch.device(device)
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    else:
        buf = buf.to(device)
    return GrainParamsBatch(buf, touches_chroma)


def from_jax_params(batch, device) -> GrainParamsBatch:
    """The JAX package's GrainParamsBatch (any object whose fields are
    array-likes: numpy arrays or jax arrays) as the port's, on
    ``device``, in one buffer. The tests feed one packed batch to both
    packages through this."""
    b = len(batch.seed)
    host = np.empty((b, PARAMS_WIDTH), dtype=np.int32)
    for name, (start, shape) in PARAM_COLUMNS.items():
        host[:, start : start + _numel(shape)] = np.asarray(getattr(batch, name), dtype=np.int32).reshape(b, -1)
    return _upload(host, device)


def _touches_chroma(params) -> bool:
    """Whether any frame in the batch touches chroma (photon-noise tables
    without --chroma and many film tables are luma-only; the chroma tables
    and the chroma kernel are then skipped)."""
    return any(
        hp.chroma_scaling_from_luma
        or len(hp.scaling_points_cb) > 0
        or len(hp.scaling_points_cr) > 0
        for hp in params
    )


def pack_params(params: List[FilmGrainParams], device) -> GrainParamsBatch:
    """Stack host FilmGrainParams into one parameter buffer on ``device``.

    A frame's row depends on its table alone, and only its seed column on
    ``grain_seed``; consecutive frames mostly share a table (inter frames
    that copy a reference's grain, a table's segments). So one row is built
    per run of frames whose tables are ``equal_ignoring_seed`` to the run's
    first, each run fills its rows from it, and the seeds are written last.
    The batch's ``touches_chroma`` is read from the runs' first tables.
    Nothing outlives the call: a table edited in place packs to its new
    values. Counters ``pack.frames`` and ``pack.rows``."""
    with spans.span("grain.pack"):
        rows: List[List[int]] = []
        runs: List[int] = []
        heads: List[FilmGrainParams] = []
        for p in params:
            if heads and (p is heads[-1] or p.equal_ignoring_seed(heads[-1])):
                runs[-1] += 1
            else:
                heads.append(p)
                rows.append(_param_row(p))
                runs.append(1)
        table = np.array(rows, dtype=np.int32).reshape(len(rows), PARAMS_WIDTH)
        host = np.repeat(table, runs, axis=0)
        host[:, PARAM_COLUMNS["seed"][0]] = [p.grain_seed for p in params]
        spans.count("pack.frames", len(params))
        spans.count("pack.rows", len(rows))
        return _upload(host, device, _touches_chroma(heads))


def _points(pts, n: int) -> List[int]:
    """A curve's n (x, y) pairs, flat: padded with the last point; an
    empty curve is all zeros."""
    if len(pts) == 0:
        return [0] * (2 * n)
    return [v for pt in pts for v in pt] + [*pts[-1]] * (n - len(pts))


def _in_lag3(coeffs, slots: Tuple[int, ...]) -> List[int]:
    """A lag-N coefficient list placed into the 24 lag-3 slots."""
    out = [0] * 24
    for s, c in zip(slots, coeffs):
        out[s] = c
    return out


def _param_row(p: FilmGrainParams) -> List[int]:
    """One table's ``PARAMS_WIDTH`` values in ``PARAM_COLUMNS`` order, the
    seed's left 0. A chroma plane's coefficients are zeros unless it is
    active (its own points, or scaling from luma), and its luma coefficient
    (slot 24) is set only where luma has points."""
    lag = p.ar_coeff_lag
    slots = _lag3_slots(lag)
    n_spatial = 2 * lag * (lag + 1)
    y, cb, cr = p.scaling_points_y, p.scaling_points_cb, p.scaling_points_cr
    csfl = p.chroma_scaling_from_luma

    def chroma(cs, active):
        if not active or len(cs) == 0:
            return [0] * 25
        luma = cs[n_spatial] if len(y) > 0 and len(cs) > n_spatial else 0
        return _in_lag3(cs[:n_spatial], slots) + [luma]

    return [
        0, len(y), len(cb), len(cr),
        *_points(y, MAX_Y_POINTS), *_points(cb, MAX_UV_POINTS), *_points(cr, MAX_UV_POINTS),
        *_in_lag3(p.ar_coeffs_y, slots),
        *chroma(p.ar_coeffs_cb, csfl or len(cb) > 0),
        *chroma(p.ar_coeffs_cr, csfl or len(cr) > 0),
        p.scaling_shift, p.ar_coeff_shift, p.grain_scale_shift,
        p.cb_mult, p.cb_luma_mult, p.cb_offset,
        p.cr_mult, p.cr_luma_mult, p.cr_offset,
        int(csfl), int(p.overlap_flag), int(p.clip_to_restricted_range),
    ]


# ---------------------------------------------------------------------------
# LFSR and block offsets


@functools.lru_cache(maxsize=16)
def _lfsr_basis(n: int) -> np.ndarray:
    """(n, 16) int32: the 16-bit state after k+1 updates when starting
    from the unit state 1 << j. The spec LFSR is linear over GF(2), so
    the state from any seed is the XOR of the columns of its set bits."""
    out = np.empty((n, 16), dtype=np.int32)
    for j in range(16):
        lf = grain_ref.Lfsr(1 << j)
        for k in range(n):
            lf.bits(16)
            out[k, j] = lf.state
    return out


@functools.lru_cache(maxsize=None)
def _lfsr_basis_on(n: int, device: torch.device) -> torch.Tensor:
    """``_lfsr_basis(n)`` on ``device``, uploaded once per (n, device) and
    never freed."""
    return torch.as_tensor(_lfsr_basis(n), device=device)


def lfsr_outputs(seeds: torch.Tensor, n: int, nbits: int) -> torch.Tensor:
    """(N,) int32 seeds -> (N, n) outputs of get_random_number(nbits):
    the top ``nbits`` of the state after each of n updates. The state is
    the XOR of the basis columns of the seed's set bits: one broadcast over
    the 16 bits, then an XOR tree over them."""
    basis = _lfsr_basis_on(n, seeds.device)
    bit = torch.arange(16, dtype=torch.int32, device=seeds.device)
    bits = (seeds.to(torch.int32)[:, None] >> bit) & 1  # (N, 16)
    terms = basis[None, :, :] * bits[:, None, :]  # (N, n, 16)
    while terms.shape[-1] > 1:
        half = terms.shape[-1] // 2
        terms = terms[..., :half] ^ terms[..., half:]
    state = terms[..., 0]
    return (state >> (16 - nbits)) & ((1 << nbits) - 1)


def block_offsets(seed: torch.Tensor, num_stripes: int, blocks: int) -> torch.Tensor:
    """(B,) seeds -> (B, num_stripes, blocks) int32 8-bit offset randoms
    with the spec's per-stripe reseeding."""
    s = torch.arange(num_stripes, dtype=torch.int32, device=seed.device)
    rr = seed.to(torch.int32)[:, None]
    rr = rr ^ (((s * 37 + 178) & 255) << 8)[None, :]
    rr = rr ^ ((s * 173 + 105) & 255)[None, :]
    outs = lfsr_outputs(rr.reshape(-1), blocks, 8)
    return outs.reshape(seed.shape[0], num_stripes, blocks)


# ---------------------------------------------------------------------------
# Noise plane assembly


def _noise_plane(
    pattern: torch.Tensor,  # (B, gh, gw)
    offsets: torch.Tensor,  # (B, S, NB) 8-bit randoms
    h: int,
    w: int,
    sub_x: int,
    sub_y: int,
    overlap: torch.Tensor,  # (B,)
    gmin: torch.Tensor,  # (B,)
    gmax: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """(B, h, w) int32 per-pixel grain before scaling, with overlap
    blending. Each block's window (plus its overlap margin) is gathered
    from the pattern at the block's offset; the left, top and top-left
    neighbours' continuations come from the same gathered tensor rolled
    along the block axes."""
    dev = pattern.device
    b = pattern.shape[0]
    bw = BLOCK >> sub_x
    bh = BLOCK >> sub_y
    ov_cols = 2 >> sub_x
    ov_rows = 2 >> sub_y
    ext_h = bh + ov_rows
    ext_w = bw + ov_cols
    n_s, n_b = offsets.shape[1], offsets.shape[2]

    rand = offsets.long()
    ox = 3 + (2 >> sub_x) * (3 + (rand >> 4))
    oy = 3 + (2 >> sub_y) * (3 + (rand & 15))
    rows = oy[..., None, None] + torch.arange(ext_h, device=dev)[:, None]
    cols = ox[..., None, None] + torch.arange(ext_w, device=dev)[None, :]
    bidx = torch.arange(b, device=dev)[:, None, None, None, None]
    sel = pattern[bidx, rows, cols].to(torch.int32)  # (B, S, NB, ext_h, ext_w)

    def blocks_to_plane(blocks):  # (B, S, NB, bh, bw) -> (B, h, w)
        plane = blocks.permute(0, 1, 3, 2, 4).reshape(b, n_s * bh, n_b * bw)
        return plane[:, :h, :w]

    def pad_to_block(t):  # zero-pad an overlap strip to (bh, bw)
        return torch.nn.functional.pad(
            t, (0, bw - t.shape[-1], 0, bh - t.shape[-2])
        )

    # t[:, i] := t[:, i-1] along a block axis (edge wraps; masked out by
    # has_left / has_top)
    cur = blocks_to_plane(sel[:, :, :, :bh, :bw])
    left_sel = torch.roll(sel, 1, dims=2)
    left = blocks_to_plane(pad_to_block(left_sel[:, :, :, :bh, bw : bw + ov_cols]))
    top_sel = torch.roll(sel, 1, dims=1)
    top = blocks_to_plane(pad_to_block(top_sel[:, :, :, bh : bh + ov_rows, :bw]))
    topleft_sel = torch.roll(top_sel, 1, dims=2)
    topleft = blocks_to_plane(
        pad_to_block(topleft_sel[:, :, :, bh : bh + ov_rows, bw : bw + ov_cols])
    )

    ys = np.arange(h)
    xs = np.arange(w)
    colpos = xs % bw
    rowpos = ys % bh
    has_left = ((xs // bw) > 0) & (colpos < ov_cols)
    has_top = ((ys // bh) > 0) & (rowpos < ov_rows)
    if sub_x:
        wx_old = np.where(colpos == 0, 23, 0)
        wx_new = np.where(colpos == 0, 22, 32)
    else:
        wx_old = np.select([colpos == 0, colpos == 1], [27, 17], 0)
        wx_new = np.select([colpos == 0, colpos == 1], [17, 27], 32)
    if sub_y:
        wy_old = np.where(rowpos == 0, 23, 0)
        wy_new = np.where(rowpos == 0, 22, 32)
    else:
        wy_old = np.select([rowpos == 0, rowpos == 1], [27, 17], 0)
        wy_new = np.select([rowpos == 0, rowpos == 1], [17, 27], 32)

    def col(a):
        return torch.as_tensor(a, device=dev)[None, None, :]

    def row(a):
        return torch.as_tensor(a, device=dev)[None, :, None]

    has_left, wx_old, wx_new = col(has_left), col(wx_old), col(wx_new)
    has_top, wy_old, wy_new = row(has_top), row(wy_old), row(wy_new)
    ov = (overlap > 0)[:, None, None]
    gmin_b = gmin[:, None, None]
    gmax_b = gmax[:, None, None]

    def hblend(old, new):
        blended = torch.clamp((old * wx_old + new * wx_new + 16) >> 5, gmin_b, gmax_b)
        return torch.where(ov & has_left, blended, new)

    cur_h = hblend(left, cur)
    top_h = hblend(topleft, top)
    blended_v = torch.clamp((top_h * wy_old + cur_h * wy_new + 16) >> 5, gmin_b, gmax_b)
    return torch.where(ov & has_top, blended_v, cur_h)


# ---------------------------------------------------------------------------
# Scaling


def _scaling_eval8(
    v: torch.Tensor,  # (B, ...) int32 in the 8-bit node domain 0..255
    pts: torch.Tensor,  # (B, P, 2)
    num: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Exact spec LUT value at 8-bit node positions: lut[x] for x in
    [x_j, x_{j+1}) is y_j + ((x - x_j) * delta_j + 32768) >> 16 with
    delta_j = dy * ((65536 + dx/2) // dx). Every segment of the padded
    curves is one broadcast over (B, P - 1, samples); where several hold
    a sample, the last one gives its value. Large inputs go in column
    chunks of about 2^24 segment tests."""
    b, p_max, _ = pts.shape
    n = p_max - 1
    x_j = pts[:, :, 0]
    y_j = pts[:, :, 1]
    dx = x_j[:, 1:] - x_j[:, :-1]
    dy = y_j[:, 1:] - y_j[:, :-1]
    dx_safe = torch.clamp(dx, min=1)
    delta = dy * torch.div(65536 + (dx_safe >> 1), dx_safe, rounding_mode="floor")
    seg_idx = torch.arange(p_max - 1, device=pts.device)[None, :]
    seg_valid = (seg_idx < (num[:, None] - 1)) & (dx > 0)
    lo, hi, ok = x_j[:, :n, None], x_j[:, 1:, None], seg_valid[:, :, None]
    order = torch.arange(1, n + 1, dtype=torch.int32, device=pts.device)[None, :, None]

    def segments(vs):  # (B, L) -> (B, L) value of the last segment holding each sample, or 0
        x = vs[:, None, :]
        pick = torch.where((x >= lo) & (x < hi) & ok, order, 0).amax(1)
        j = (pick - 1).clamp(min=0).long()
        seg_val = torch.gather(y_j, 1, j) + (
            ((vs - torch.gather(x_j, 1, j)) * torch.gather(delta, 1, j) + 32768) >> 16
        )
        return torch.where(pick > 0, seg_val, 0)

    shape = v.shape
    vflat = v.reshape(b, -1)
    step = max(1, (1 << 24) // max(1, b * n))
    chunks = [segments(vflat[:, i : i + step]) for i in range(0, max(vflat.shape[1], 1), step)]
    val = chunks[0] if len(chunks) == 1 else torch.cat(chunks, 1)
    last = torch.clamp(num - 1, min=0)[:, None].long()
    below = vflat < x_j[:, :1]
    above = vflat >= torch.gather(x_j, 1, last)
    val = torch.where(below, y_j[:, :1], val)
    val = torch.where(above, torch.gather(y_j, 1, last), val)
    val = val * (num > 0).to(val.dtype)[:, None]
    return val.reshape(shape)


def scaling_lookup(
    v: torch.Tensor, pts: torch.Tensor, num: torch.Tensor, bit_depth: int
) -> torch.Tensor:
    """Spec scaling including the high-bit-depth node interpolation."""
    v = torch.clamp(v, 0, (1 << bit_depth) - 1)
    if bit_depth == 8:
        return _scaling_eval8(v, pts, num)
    shift = bit_depth - 8
    pad = 1 << shift
    idx = v >> shift
    rem = v & (pad - 1)
    a = _scaling_eval8(idx, pts, num)
    b_val = _scaling_eval8(torch.clamp(idx + 1, max=255), pts, num)
    interp = a + (((b_val - a) * rem + (pad >> 1)) >> shift)
    return torch.where(idx >= 255, a, interp)


def scaling_lut(pts: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """(B, 256) int32 scaling LUT at the 8-bit nodes, as
    grain_ref.build_scaling_lut builds it for 8-bit content."""
    nodes = torch.arange(256, dtype=torch.int32, device=pts.device)
    return _scaling_eval8(nodes.expand(pts.shape[0], 256), pts, num)


def lut_scale(v: torch.Tensor, lut: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Scaling of (B, ...) samples through per-frame (B, 256) node LUTs,
    interpolated between nodes above 8 bits exactly as grain_ref's
    expanded LUT (``a`` itself at the last node)."""
    v = torch.clamp(v, 0, (1 << bit_depth) - 1)
    lut = lut.to(torch.int32)

    def at(idx):
        return torch.gather(lut, 1, idx.reshape(idx.shape[0], -1).long()).reshape(
            idx.shape
        )

    if bit_depth == 8:
        return at(v)
    shift = bit_depth - 8
    idx = v >> shift
    rem = v & ((1 << shift) - 1)
    a = at(idx)
    b_val = at(torch.clamp(idx + 1, max=255))
    interp = a + (((b_val - a) * rem + (1 << (shift - 1))) >> shift)
    return torch.where(idx >= 255, a, interp)


def _avg_luma(y: torch.Tensor, hc: int, wc: int, sub_x: int, sub_y: int) -> torch.Tensor:
    """Chroma scaling input: horizontally averaged luma (spec 7.18.3.5;
    vertical subsampling takes the even rows, and an odd luma width
    pairs the last sample with itself)."""
    w = y.shape[2]
    ly = y[:, :: 1 << sub_y, :][:, :hc, :]
    if not sub_x:
        return ly[:, :, :wc]
    a = ly[:, :, 0 : 2 * wc : 2]
    if 2 * wc <= w:
        bb = ly[:, :, 1 : 2 * wc : 2]
    else:
        bb = torch.cat([ly[:, :, 1::2], a[:, :, -1:]], dim=2)
    return (a + bb + 1) >> 1


def _round_shift(x: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """Round2(x, ss) for per-frame (B,) shifts >= 1, broadcast over
    (B, h, w)."""
    ss = ss.to(torch.int32)[:, None, None]
    return (x + torch.bitwise_left_shift(torch.ones_like(ss), ss - 1)) >> ss


# ---------------------------------------------------------------------------
# Host patterns


def _unpack_patterns(packed: torch.Tensor, chroma_shape):
    """Views of the packed (B, n) buffer as (luma, cb, cr) patterns
    (row stride n; the last two axes are contiguous)."""
    b = packed.shape[0]
    n_luma = GRAIN_H * GRAIN_W
    luma = packed[:, :n_luma].reshape(b, GRAIN_H, GRAIN_W)
    if chroma_shape is None:
        return luma, None, None
    ch, cw = chroma_shape
    n_c = ch * cw
    cb = packed[:, n_luma : n_luma + n_c].reshape(b, ch, cw)
    cr = packed[:, n_luma + n_c : n_luma + 2 * n_c].reshape(b, ch, cw)
    return luma, cb, cr


def generate_patterns_ref(
    params_list, bit_depth: int, sub_x: int = 1, sub_y: int = 1, monochrome: bool = False
):
    """grain_ref's pattern generation with the contract of
    ffshim.generate_patterns_native: (luma (n,73,82), cb, cr) int32,
    cb/cr None when monochrome. For hosts without the native shim."""
    pats = [
        grain_ref.generate_grain(p, bit_depth, monochrome, sub_x, sub_y)
        for p in params_list
    ]
    luma = np.stack([g.luma for g in pats]).astype(np.int32)
    if monochrome:
        return luma, None, None
    cb = np.stack([g.cb for g in pats]).astype(np.int32)
    cr = np.stack([g.cr for g in pats]).astype(np.int32)
    return luma, cb, cr


# ---------------------------------------------------------------------------
# Grain patterns on the device (grain_jax.generate_patterns)


def chroma_pattern_shape(sub_x: int, sub_y: int) -> Tuple[int, int]:
    """(rows, cols) of a chroma pattern: 38 x 44 at 4:2:0, 73 x 44 at
    4:2:2, 73 x 82 at 4:4:4."""
    return (CHROMA_H_420 if sub_y else GRAIN_H, CHROMA_W_420 if sub_x else GRAIN_W)


@functools.lru_cache(maxsize=None)
def gaussian_table(device: torch.device) -> torch.Tensor:
    """The spec's 2048-entry Gaussian sequence as int16 on ``device``
    (uploaded once per device; never written)."""
    return torch.as_tensor(GAUSSIAN_SEQUENCE, dtype=torch.int16, device=device)


def _round2(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Spec Round2 for per-frame shifts >= 0 broadcast against ``x``
    (shift 0 leaves x as it is; arithmetic on negatives)."""
    add = torch.bitwise_left_shift(torch.ones_like(shift), torch.clamp(shift - 1, min=0))
    return torch.where(shift > 0, (x + add) >> shift, x)


def _gaussian_base(
    seeds: torch.Tensor, h: int, w: int, shift: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """(B,) seeds -> (B, h, w) int32 rounded Gaussian base noise, zero
    for inactive frames (grain_jax._gaussian_base)."""
    idx = lfsr_outputs(seeds, h * w, 11)
    g = gaussian_table(seeds.device).to(torch.int32)[idx.long()]
    g = _round2(g, shift.to(torch.int32)[:, None]) * active.to(torch.int32)[:, None]
    return g.reshape(-1, h, w)


@functools.lru_cache(maxsize=8)
def _wavefronts(h: int, w: int) -> np.ndarray:
    """The AR region's positions grouped by t = 4y + x (grain_jax._wavefronts):
    every AR neighbour of (y, x) has a smaller t, so the positions sharing
    a t are independent. (T, P) flat positions, padded with h * w (a
    scratch slot)."""
    groups: dict = {}
    for y in range(3, h):
        for x in range(3, w - 3):
            groups.setdefault(4 * y + x, []).append(y * w + x)
    ts = sorted(groups)
    out = np.full((len(ts), max(len(v) for v in groups.values())), h * w, dtype=np.int64)
    for i, t in enumerate(ts):
        out[i, : len(groups[t])] = groups[t]
    return out


def _ar_filter_reference(
    pattern: torch.Tensor,  # (B, h, w) int32
    coeffs: torch.Tensor,  # (B, 24) lag-3 slots
    ar_shift: torch.Tensor,  # (B,)
    gmin: torch.Tensor,  # (B,)
    gmax: torch.Tensor,  # (B,)
    luma_term: Optional[torch.Tensor] = None,  # (B, h, w) added to each sum
) -> torch.Tensor:
    """The spec's AR recurrence over the pattern, as a wavefront scan
    batched across frames (grain_jax._ar_filter; with ``luma_term``, the
    chroma filter's collocated-luma tap, _ar_filter_chroma)."""
    b, h, w = pattern.shape
    dev = pattern.device
    flat = torch.cat(
        [pattern.reshape(b, h * w), torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1
    )
    extra = None
    if luma_term is not None:
        extra = torch.cat(
            [luma_term.reshape(b, h * w), torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1
        )
    rel = torch.tensor([dr * w + dc for dr, dc in LAG3_OFFSETS], device=dev)
    coeffs = coeffs.to(torch.int32)[:, None, :]
    shift = ar_shift.to(torch.int32)[:, None]
    lo, hi = gmin[:, None], gmax[:, None]
    for pos in torch.as_tensor(_wavefronts(h, w), device=dev):
        window = flat[:, pos[:, None] + rel[None, :]]  # (B, P, 24)
        s = (window * coeffs).sum(-1, dtype=torch.int32)
        if extra is not None:
            s = s + extra[:, pos]
        flat[:, pos] = torch.clamp(flat[:, pos] + _round2(s, shift), lo, hi)
    return flat[:, : h * w].reshape(b, h, w)


def generate_patterns(
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """Plain PyTorch grain patterns from a parameter batch
    (grain_jax.generate_patterns, spec 7.18.3.3): (luma (B, 73, 82),
    cb, cr) int32, cb/cr None when monochrome. The pattern kernel
    (``grain_kernels.generate_patterns_packed``) is held against it."""
    shift = 12 - bit_depth + p.grain_scale_shift
    grain_center = 128 << (bit_depth - 8)
    gmin = torch.full_like(p.seed, -grain_center)
    gmax = torch.full_like(p.seed, grain_center - 1)
    has_y = (p.num_y > 0).to(torch.int32)
    luma = _gaussian_base(p.seed, GRAIN_H, GRAIN_W, shift, has_y)
    luma = _ar_filter_reference(luma, p.coeffs_y, p.ar_shift, gmin, gmax)
    if monochrome:
        return luma, None, None
    ch, cw = chroma_pattern_shape(sub_x, sub_y)
    # collocated luma average of the filtered region: the anchor of chroma
    # (y, x) is luma (((y - 3) << sub_y) + 3, ((x - 3) << sub_x) + 3)
    n_rows, n_cols = ch - 3, cw - 6
    acc = torch.zeros((p.batch, n_rows, n_cols), dtype=torch.int32, device=p.device)
    for i in range(sub_y + 1):
        for j in range(sub_x + 1):
            acc += luma[:, 3 + i :: 1 << sub_y, 3 + j :: 1 << sub_x][:, :n_rows, :n_cols]
    avg = torch.zeros((p.batch, ch, cw), dtype=torch.int32, device=p.device)
    avg[:, 3:, 3 : cw - 3] = _round2(acc, torch.tensor(sub_x + sub_y, device=p.device))
    out = [luma]
    for seed_xor, num, coeffs in ((0xB524, p.num_cb, p.coeffs_cb), (0x49D8, p.num_cr, p.coeffs_cr)):
        active = ((num > 0) | (p.csfl > 0)).to(torch.int32)
        base = _gaussian_base(p.seed ^ seed_xor, ch, cw, shift, active)
        # the luma tap counts only when the frame has luma points
        luma_coeff = coeffs[:, 24] * active * has_y
        out.append(
            _ar_filter_reference(
                base, coeffs[:, :24] * active[:, None], p.ar_shift, gmin, gmax,
                luma_coeff[:, None, None] * avg,
            )
        )
    return tuple(out)


def pack_patterns(luma, cb, cr) -> torch.Tensor:
    """(luma, cb, cr) patterns -> the packed (B, 73 * 82 [+ 2 ch cw])
    int16 buffer the pattern kernel writes (``_unpack_patterns`` views
    it as planes again)."""
    b = luma.shape[0]
    parts = [luma.reshape(b, -1)] + ([] if cb is None else [cb.reshape(b, -1), cr.reshape(b, -1)])
    return torch.cat(parts, 1).to(torch.int16)


# ---------------------------------------------------------------------------
# Full application


def apply_grain(
    y: torch.Tensor,
    cb: Optional[torch.Tensor],
    cr: Optional[torch.Tensor],
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """Apply film grain to a batch of frames on ``y.device``
    (grain_jax's on-device-pattern apply without its segment bound: the
    program evaluates every segment, at the same device time).

    Frames go to the kernels as int16 (every AV1 bit depth fits) and come
    back as int16. The batch's parameter program (``ops.program``) runs
    first, the pattern kernel inside it: one graph replay on a CUDA device,
    eager on the CPU. Then the CUDA grain kernel runs (the fused luma, Cb
    and Cr kernel); on the CPU its plain version. A batch whose tables
    touch no chroma (``p.touches_chroma`` False) skips the chroma tables,
    runs the luma kernel alone and returns ``cb``/``cr`` untouched."""
    with spans.span("program.replay"):
        from .program import ProgramKey, program_for

        key = ProgramKey.of(y, bit_depth, sub_x, sub_y, monochrome, p.touches_chroma)
        tables = program_for(key).run(p)
    with spans.span("grain.launch"):
        chroma_shape = None if monochrome else chroma_pattern_shape(sub_x, sub_y)
        return apply_with_tables(y, cb, cr, tables,
                                 _unpack_patterns(tables.patterns, chroma_shape), bit_depth,
                                 sub_x, sub_y, monochrome)


def apply_with_tables(
    y: torch.Tensor,
    cb: Optional[torch.Tensor],
    cr: Optional[torch.Tensor],
    tables,
    patterns,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """The grain kernels after a parameter program, on the stream the
    program ran on: the fused kernel (luma, Cb and Cr in one pass) where
    the program made chroma rows, else, for a monochrome batch or one whose
    tables touch no chroma, the luma kernel alone. ``tables`` is the
    program's ``ProgramOutputs``, ``patterns`` the (luma, cb, cr) pattern
    views."""
    from . import grain_kernels as gk

    luma_pat, cb_pat, cr_pat = patterns
    y16 = y.to(torch.int16)
    if monochrome or tables.params2 is None:
        y_out = gk.apply_plane_luma(y16, luma_pat, tables.offsets, tables.params_y, bit_depth)
        return (y_out, None, None) if monochrome else (y_out, cb, cr)
    return gk.apply_planes_fused(
        y16, cb.to(torch.int16), cr.to(torch.int16), luma_pat, cb_pat, cr_pat, tables.offsets,
        tables.params_y, tables.params2, bit_depth, sub_x, sub_y,
    )


def apply_grain_reference(
    y: torch.Tensor,
    cb: Optional[torch.Tensor],
    cr: Optional[torch.Tensor],
    luma_pat: torch.Tensor,
    cb_pat: Optional[torch.Tensor],
    cr_pat: Optional[torch.Tensor],
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """Plain PyTorch version of the whole apply (the JAX package's
    ``_apply_xla_with_patterns``): scaling by the closed-form curve,
    noise by ``_noise_plane``. Returns int32 planes."""
    y = y.to(torch.int32)
    _, h, w = y.shape
    grain_center = 128 << (bit_depth - 8)
    gmin = torch.full_like(p.seed, -grain_center)
    gmax = torch.full_like(p.seed, grain_center - 1)
    maxval = (1 << bit_depth) - 1
    offs = block_offsets(p.seed, (h + BLOCK - 1) // BLOCK, (w + BLOCK - 1) // BLOCK)

    clip = (p.clip > 0)[:, None, None]
    zero = torch.zeros((), dtype=torch.int32, device=y.device)
    lo = torch.where(clip, zero + (16 << (bit_depth - 8)), zero)
    noise_y = _noise_plane(luma_pat, offs, h, w, 0, 0, p.overlap, gmin, gmax)
    scale_y = scaling_lookup(y, p.pts_y, p.num_y, bit_depth)
    hi_y = torch.where(clip, zero + (235 << (bit_depth - 8)), zero + maxval)
    y_out = torch.clamp(y + _round_shift(scale_y * noise_y, p.scaling_shift), lo, hi_y)
    y_out = torch.where((p.num_y > 0)[:, None, None], y_out, y)
    if monochrome:
        return y_out, None, None

    hc, wc = cb.shape[1], cb.shape[2]
    avg_luma = _avg_luma(y, hc, wc, sub_x, sub_y)
    hi_c = torch.where(clip, zero + (240 << (bit_depth - 8)), zero + maxval)
    use_csfl = (p.csfl > 0)[:, None, None]

    def chroma_plane(src, pat, mult, luma_mult, offset, pts, num):
        src = src.to(torch.int32)
        noise_c = _noise_plane(pat, offs, hc, wc, sub_x, sub_y, p.overlap, gmin, gmax)
        combined = avg_luma * (luma_mult[:, None, None] - 128) + src * (
            mult[:, None, None] - 128
        )
        val_mult = torch.clamp(
            (combined >> 6) + ((offset[:, None, None] - 256) << (bit_depth - 8)),
            0,
            maxval,
        )
        val = torch.where(use_csfl, avg_luma, val_mult)
        # under csfl the luma points drive chroma
        scale = torch.where(
            use_csfl,
            scaling_lookup(val, p.pts_y, p.num_y, bit_depth),
            scaling_lookup(val, pts, num, bit_depth),
        )
        out = torch.clamp(src + _round_shift(scale * noise_c, p.scaling_shift), lo, hi_c)
        active = ((num > 0) | (p.csfl > 0))[:, None, None]
        return torch.where(active, out, src)

    cb_out = chroma_plane(
        cb, cb_pat, p.cb_mult, p.cb_luma_mult, p.cb_offset, p.pts_cb, p.num_cb
    )
    cr_out = chroma_plane(
        cr, cr_pat, p.cr_mult, p.cr_luma_mult, p.cr_offset, p.pts_cr, p.num_cr
    )
    return y_out, cb_out, cr_out
