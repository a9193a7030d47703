"""The grain kernels (counterparts of the Pallas kernels in
grav1synth_tpu/ops/grain_pallas.py), each beside its plain PyTorch
version.

- ``apply_plane_luma``   -> CUDA ``grain_luma_kernel``
  (replaces ``grain_pallas._luma_kernel``)
- ``apply_planes_pair``  -> CUDA ``grain_chroma_pair_kernel``
  (replaces ``grain_pallas._chroma_pair_kernel``)
- ``apply_planes_fused`` -> CUDA ``grain_fused_kernel``
  (replaces ``grain_pallas._fused_kernel``: luma, Cb and Cr in one pass
  that reads each luma sample once; the apply path's kernel for every
  three-plane batch)
- ``apply_plane_chroma`` -> CUDA ``grain_chroma_kernel``
  (replaces ``grain_pallas._chroma_kernel``: one chroma plane, with the
  averaged luma of its scaling input given as an input)
- ``generate_patterns_packed`` (``pattern_params``, then
  ``pattern_kernel``) -> CUDA ``grain_pattern_kernel``
  (replaces ``grain_jax.generate_patterns``, an XLA wavefront scan: the
  Gaussian base and AR filter of every plane, written as the packed int16
  buffer the kernels above read)
- ``grain_tables`` -> CUDA ``grain_tables_kernel``
  (replaces the glue of ``grain_jax``'s jitted apply: ``block_offsets``
  with ``lfsr_outputs``, ``_scaling_eval8`` and the per-plane rows; its
  plain version, ``grain_tables_reference``, is ``pack_plane_params``,
  ``block_offsets`` and ``pattern_params``)

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it checks device, dtype, shape and contiguity, then launches the
kernel or raises, and counts the launch in ``utils.spans``'
``launch.<kernel>`` counter (the chroma-pair kernel's also under
``launch.grain_chroma_pair.<sub_x><sub_y>``, its layout's instantiation:
``.11``, ``.10``, ``.00``; the fused kernel's likewise under
``launch.grain_fused.<sub_x><sub_y>``). A launch recorded into a CUDA
graph under capture launches nothing: it is counted in
``recorded.<kernel>``, and the graph's owner (``ops.program``) adds what
its graph holds to ``launch.<kernel>`` on each replay.

Per-plane parameter rows (``pack_plane_params``) carry the scalars the
kernels read and the plane's 256-entry scaling LUT at the 8-bit nodes;
the kernels read the LUT directly (and interpolate between nodes above
8 bits) where the Pallas kernels evaluate the curve in closed form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ..utils import spans
from .grain import (
    BLOCK,
    GRAIN_H,
    GRAIN_W,
    PARAMS_WIDTH,
    GrainParamsBatch,
    _avg_luma,
    _noise_plane,
    _round_shift,
    block_offsets,
    chroma_pattern_shape,
    gaussian_table,
    generate_patterns,
    lut_scale,
    pack_patterns,
    scaling_lut,
)

# packed per-plane parameter row (int32)
P_ACTIVE = 0
P_SCALING_SHIFT = 1
P_OVERLAP = 2
P_CLIP_LO = 3
P_CLIP_HI = 4
P_GMIN = 5
P_GMAX = 6
P_USE_MULT = 7
P_MULT = 8
P_LUMA_MULT = 9
P_OFFSET = 10
P_LUT = 16  # 256 scaling values at the 8-bit nodes
P_LEN = P_LUT + 256

# packed per-frame pattern row (int32; csrc/pattern_kernels.cu)
Q_SEED = 0
Q_HAS_Y = 1  # the frame has luma points
Q_CB_ACTIVE = 2  # Cb has points, or chroma scaling from luma
Q_CR_ACTIVE = 3
Q_AR_SHIFT = 4
Q_GRAIN_SCALE_SHIFT = 5
Q_CB_LUMA = 6  # Cb's collocated-luma coefficient (0 unless luma and Cb are on)
Q_CR_LUMA = 7
Q_COEFFS_Y = 8  # 24 lag-3 slots each, zeroed for an inactive chroma plane
Q_COEFFS_CB = Q_COEFFS_Y + 24
Q_COEFFS_CR = Q_COEFFS_CB + 24
Q_LEN = Q_COEFFS_CR + 24


def _launched(*names: str) -> None:
    """Count one launch under each of ``names``, or, under graph capture,
    one launch recorded into the graph."""
    kind = "recorded." if torch.cuda.is_current_stream_capturing() else "launch."
    for name in names:
        spans.count(kind + name)


def pack_plane_params(p: GrainParamsBatch, plane: str, bit_depth: int) -> torch.Tensor:
    """(B, P_LEN) int32 rows for plane "y", "cb" or "cr", on p's device."""
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
    out = torch.zeros((p.batch, P_LEN), dtype=torch.int32, device=p.device)
    out[:, P_ACTIVE] = active.to(torch.int32)
    out[:, P_SCALING_SHIFT] = p.scaling_shift
    out[:, P_OVERLAP] = p.overlap
    out[:, P_CLIP_LO] = lo
    out[:, P_CLIP_HI] = hi
    out[:, P_GMIN] = -grain_center
    out[:, P_GMAX] = grain_center - 1
    out[:, P_USE_MULT] = use_mult
    out[:, P_MULT] = mult
    out[:, P_LUMA_MULT] = luma_mult
    out[:, P_OFFSET] = offset
    out[:, P_LUT:] = scaling_lut(pts, num)
    return out


def pattern_params(p: GrainParamsBatch) -> torch.Tensor:
    """(B, Q_LEN) int32 rows for the pattern kernel, on p's device. The
    spec's activity rules are folded in here: an inactive chroma plane
    gets zero coefficients, and a chroma plane's luma tap counts only when
    the frame has luma points."""
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
# Plain PyTorch versions


def grain_tables_reference(
    buf: torch.Tensor, height: int, width: int, bit_depth: int, chroma: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The tables of ``grain_tables`` from PyTorch ops: the luma rows, the
    Cb|Cr rows (None unless ``chroma``), the block offsets and the pattern
    rows of the (B, PARAMS_WIDTH) parameter buffer ``buf``."""
    p = GrainParamsBatch(buf)
    offsets = block_offsets(p.seed, (height + BLOCK - 1) // BLOCK, (width + BLOCK - 1) // BLOCK)
    params2 = None
    if chroma:
        params2 = torch.cat([pack_plane_params(p, plane, bit_depth) for plane in ("cb", "cr")])
    return pack_plane_params(p, "y", bit_depth), params2, offsets, pattern_params(p)


def _grain_plane(src, noise, prm, bit_depth, scale_in):
    """clip(src + Round2(scale(scale_in) * noise, shift), lo, hi), or
    src for inactive rows, in the dtype of ``src``."""
    s32 = src.to(torch.int32)
    scale = lut_scale(scale_in, prm[:, P_LUT:], bit_depth)
    out = torch.clamp(
        s32 + _round_shift(scale * noise, prm[:, P_SCALING_SHIFT]),
        prm[:, P_CLIP_LO, None, None],
        prm[:, P_CLIP_HI, None, None],
    )
    out = torch.where((prm[:, P_ACTIVE] > 0)[:, None, None], out, s32)
    return out.to(src.dtype)


def apply_plane_luma_reference(
    src: torch.Tensor,  # (B, H, W)
    pattern: torch.Tensor,  # (B, 73, 82)
    offsets: torch.Tensor,  # (B, S, NB)
    params: torch.Tensor,  # (B, P_LEN) from pack_plane_params "y"
    bit_depth: int,
) -> torch.Tensor:
    _, h, w = src.shape
    noise = _noise_plane(
        pattern, offsets, h, w, 0, 0,
        params[:, P_OVERLAP], params[:, P_GMIN], params[:, P_GMAX],
    )
    return _grain_plane(src, noise, params, bit_depth, src.to(torch.int32))


def apply_plane_chroma_reference(
    src: torch.Tensor,  # (B, Hc, Wc)
    avg: torch.Tensor,  # (B, Hc, Wc) averaged ungrained luma (_avg_luma)
    pattern: torch.Tensor,  # (B, ch, cw)
    offsets: torch.Tensor,  # (B, S, NB), luma-block indexed
    params: torch.Tensor,  # (B, P_LEN) from pack_plane_params "cb" or "cr"
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> torch.Tensor:
    _, hc, wc = src.shape
    maxval = (1 << bit_depth) - 1
    noise = _noise_plane(
        pattern, offsets, hc, wc, sub_x, sub_y,
        params[:, P_OVERLAP], params[:, P_GMIN], params[:, P_GMAX],
    )

    def col(k):
        return params[:, k, None, None]

    avg = avg.to(torch.int32)
    combined = avg * (col(P_LUMA_MULT) - 128) + src.to(torch.int32) * (col(P_MULT) - 128)
    val_mult = torch.clamp(
        (combined >> 6) + ((col(P_OFFSET) - 256) << (bit_depth - 8)), 0, maxval
    )
    val = torch.where(col(P_USE_MULT) > 0, val_mult, avg)
    return _grain_plane(src, noise, params, bit_depth, val)


def apply_planes_pair_reference(
    y: torch.Tensor,  # (B, H, W) ungrained source luma
    cb: torch.Tensor,  # (B, Hc, Wc)
    cr: torch.Tensor,
    cb_pat: torch.Tensor,  # (B, ch, cw)
    cr_pat: torch.Tensor,
    offsets: torch.Tensor,  # (B, S, NB), luma-block indexed
    params2: torch.Tensor,  # (2B, P_LEN): cb rows, then cr rows
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b = y.shape[0]
    avg = _avg_luma(y.to(torch.int32), cb.shape[1], cb.shape[2], sub_x, sub_y)
    return tuple(
        apply_plane_chroma_reference(src, avg, pat, offsets, prm, bit_depth, sub_x, sub_y)
        for src, pat, prm in ((cb, cb_pat, params2[:b]), (cr, cr_pat, params2[b:]))
    )


def apply_planes_fused_reference(
    y: torch.Tensor,  # (B, H, W) ungrained source luma
    cb: torch.Tensor,  # (B, Hc, Wc)
    cr: torch.Tensor,
    luma_pat: torch.Tensor,  # (B, 73, 82)
    cb_pat: torch.Tensor,  # (B, ch, cw)
    cr_pat: torch.Tensor,
    offsets: torch.Tensor,  # (B, S, NB)
    params_y: torch.Tensor,  # (B, P_LEN) from pack_plane_params "y"
    params2: torch.Tensor,  # (2B, P_LEN): cb rows, then cr rows
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The luma kernel's plain version, then the chroma-pair kernel's."""
    y_out = apply_plane_luma_reference(y, luma_pat, offsets, params_y, bit_depth)
    return (y_out, *apply_planes_pair_reference(
        y, cb, cr, cb_pat, cr_pat, offsets, params2, bit_depth, sub_x, sub_y))


def generate_patterns_packed_reference(
    p: GrainParamsBatch, bit_depth: int, sub_x: int = 1, sub_y: int = 1,
    monochrome: bool = False,
) -> torch.Tensor:
    """(B, 73 * 82 [+ 2 ch cw]) int16 packed patterns from the plain
    ``generate_patterns``."""
    return pack_patterns(*generate_patterns(p, bit_depth, sub_x, sub_y, monochrome))


# ---------------------------------------------------------------------------
# CUDA wrappers


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"the kernels take tensors on one CUDA device or on the CPU, "
            f"got {sorted(str(t.device) for t in tensors)}"
        )
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_pattern(name: str, t: torch.Tensor, b: int, gh: int, gw: int) -> int:
    """Patterns may be views into the packed upload buffer: each frame's
    (gh, gw) pattern must be contiguous; frames sit ``stride(0)`` apart.
    Returns that frame stride."""
    if t.dtype != torch.int16:
        raise TypeError(f"{name}: expected torch.int16, got {t.dtype}")
    if tuple(t.shape) != (b, gh, gw):
        raise ValueError(f"{name}: expected shape {(b, gh, gw)}, got {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) != gw:
        raise ValueError(f"{name}: each frame's pattern must be contiguous")
    return t.stride(0)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({_build.error_string(err)})"
        )


def apply_plane_luma(
    src: torch.Tensor,  # (B, H, W) int16
    pattern: torch.Tensor,  # (B, 73, 82) int16
    offsets: torch.Tensor,  # (B, S, NB) int32
    params: torch.Tensor,  # (B, P_LEN) int32
    bit_depth: int,
) -> torch.Tensor:
    """Luma grain for a batch of frames; returns a new (B, H, W) int16."""
    if _on_cpu(src, pattern, offsets, params):
        return apply_plane_luma_reference(src, pattern, offsets, params, bit_depth)
    b, h, w = src.shape
    s, nb = (h + BLOCK - 1) // BLOCK, (w + BLOCK - 1) // BLOCK
    _check("src", src, torch.int16, (b, h, w))
    _check("offsets", offsets, torch.int32, (b, s, nb))
    _check("params", params, torch.int32, (b, P_LEN))
    pat_stride = _check_pattern("pattern", pattern, b, GRAIN_H, GRAIN_W)
    if bit_depth not in (8, 10, 12):
        raise ValueError(f"bit depth {bit_depth} not in (8, 10, 12)")
    out = torch.empty_like(src)
    if b == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(src.device):
        err = lib.grain_luma(
            src.data_ptr(), out.data_ptr(), pattern.data_ptr(), pat_stride,
            offsets.data_ptr(), params.data_ptr(), b, h, w, bit_depth,
            _stream(src),
        )
    _raise_on(err, "grain_luma launch")
    _launched("grain_luma")
    return out


# the chroma-pair and fused kernels' counters of each layout's instantiation
_PAIR_LAYOUT = {(sx, sy): f"grain_chroma_pair.{sx}{sy}"
                for sx, sy in ((1, 1), (1, 0), (0, 0))}
_FUSED_LAYOUT = {(sx, sy): f"grain_fused.{sx}{sy}" for sx, sy in _PAIR_LAYOUT}


def _check_depth_and_subsampling(bit_depth: int, sub_x: int, sub_y: int) -> None:
    if (sub_x, sub_y) not in _PAIR_LAYOUT:
        raise ValueError(f"unsupported subsampling {(sub_x, sub_y)}")
    if bit_depth not in (8, 10, 12):
        raise ValueError(f"bit depth {bit_depth} not in (8, 10, 12)")


def apply_plane_chroma(
    src: torch.Tensor,  # (B, Hc, Wc) int16
    avg: torch.Tensor,  # (B, Hc, Wc) int16 averaged ungrained luma
    pattern: torch.Tensor,  # (B, ch, cw) int16
    offsets: torch.Tensor,  # (B, S, NB) int32, luma-block indexed
    params: torch.Tensor,  # (B, P_LEN) int32 from pack_plane_params "cb" or "cr"
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> torch.Tensor:
    """Grain of one chroma plane whose scaling input's luma average is
    given (``grain_pallas.apply_plane_chroma``); returns a new (B, Hc, Wc)
    int16. The stripes and blocks are those of ``offsets``, which must
    cover the plane."""
    if _on_cpu(src, avg, pattern, offsets, params):
        return apply_plane_chroma_reference(
            src, avg, pattern, offsets, params, bit_depth, sub_x, sub_y
        )
    _check_depth_and_subsampling(bit_depth, sub_x, sub_y)
    b, hc, wc = src.shape
    if offsets.dim() != 3:
        raise ValueError(f"offsets: expected (B, S, NB), got shape {tuple(offsets.shape)}")
    s, nb = offsets.shape[1], offsets.shape[2]
    if s * (BLOCK >> sub_y) < hc or nb * (BLOCK >> sub_x) < wc:
        raise ValueError(
            f"offsets of {s} stripes x {nb} blocks do not cover a {hc}x{wc} plane "
            f"at subsampling {(sub_x, sub_y)}"
        )
    _check("src", src, torch.int16, (b, hc, wc))
    _check("avg", avg, torch.int16, (b, hc, wc))
    _check("offsets", offsets, torch.int32, (b, s, nb))
    _check("params", params, torch.int32, (b, P_LEN))
    pat_stride = _check_pattern("pattern", pattern, b, *chroma_pattern_shape(sub_x, sub_y))
    out = torch.empty_like(src)
    if b == 0 or hc == 0 or wc == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(src.device):
        err = lib.grain_chroma(
            src.data_ptr(), avg.data_ptr(), out.data_ptr(), pattern.data_ptr(),
            pat_stride, offsets.data_ptr(), params.data_ptr(),
            b, hc, wc, s, nb, sub_x, sub_y, bit_depth, _stream(src),
        )
    _raise_on(err, "grain_chroma launch")
    _launched("grain_chroma")
    return out


def _check_pair(y, cb, cr, cb_pat, cr_pat, offsets, params2, bit_depth, sub_x, sub_y):
    """The checks of the chroma-pair kernel's CUDA arguments; returns the
    Cb and Cr patterns' frame strides."""
    _check_depth_and_subsampling(bit_depth, sub_x, sub_y)
    b, h, w = y.shape
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    s, nb = (h + BLOCK - 1) // BLOCK, (w + BLOCK - 1) // BLOCK
    gh, gw = chroma_pattern_shape(sub_x, sub_y)
    _check("y", y, torch.int16, (b, h, w))
    _check("cb", cb, torch.int16, (b, hc, wc))
    _check("cr", cr, torch.int16, (b, hc, wc))
    _check("offsets", offsets, torch.int32, (b, s, nb))
    _check("params2", params2, torch.int32, (2 * b, P_LEN))
    return (_check_pattern("cb_pat", cb_pat, b, gh, gw),
            _check_pattern("cr_pat", cr_pat, b, gh, gw))


def apply_planes_pair(
    y: torch.Tensor,  # (B, H, W) int16, ungrained
    cb: torch.Tensor,  # (B, Hc, Wc) int16
    cr: torch.Tensor,
    cb_pat: torch.Tensor,  # (B, ch, cw) int16
    cr_pat: torch.Tensor,
    offsets: torch.Tensor,  # (B, S, NB) int32
    params2: torch.Tensor,  # (2B, P_LEN) int32: cb rows, then cr rows
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cb and Cr grain in one pass; returns new (cb, cr) int16 planes."""
    if _on_cpu(y, cb, cr, cb_pat, cr_pat, offsets, params2):
        return apply_planes_pair_reference(
            y, cb, cr, cb_pat, cr_pat, offsets, params2, bit_depth, sub_x, sub_y
        )
    cb_stride, cr_stride = _check_pair(
        y, cb, cr, cb_pat, cr_pat, offsets, params2, bit_depth, sub_x, sub_y)
    b, h, w = y.shape
    out_cb = torch.empty_like(cb)
    out_cr = torch.empty_like(cr)
    if b == 0:
        return out_cb, out_cr
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.grain_chroma_pair(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(),
            out_cb.data_ptr(), out_cr.data_ptr(),
            cb_pat.data_ptr(), cb_stride, cr_pat.data_ptr(), cr_stride,
            offsets.data_ptr(), params2.data_ptr(),
            b, h, w, sub_x, sub_y, bit_depth, _stream(y),
        )
    _raise_on(err, "grain_chroma_pair launch")
    _launched("grain_chroma_pair", _PAIR_LAYOUT[sub_x, sub_y])
    return out_cb, out_cr


def apply_planes_fused(
    y: torch.Tensor,  # (B, H, W) int16, ungrained
    cb: torch.Tensor,  # (B, Hc, Wc) int16
    cr: torch.Tensor,
    luma_pat: torch.Tensor,  # (B, 73, 82) int16
    cb_pat: torch.Tensor,  # (B, ch, cw) int16
    cr_pat: torch.Tensor,
    offsets: torch.Tensor,  # (B, S, NB) int32
    params_y: torch.Tensor,  # (B, P_LEN) int32
    params2: torch.Tensor,  # (2B, P_LEN) int32: cb rows, then cr rows
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Luma, Cb and Cr grain in one pass that reads each luma sample once;
    returns new (y, cb, cr) int16 planes, equal to ``apply_plane_luma``
    then ``apply_planes_pair``."""
    if _on_cpu(y, cb, cr, luma_pat, cb_pat, cr_pat, offsets, params_y, params2):
        return apply_planes_fused_reference(
            y, cb, cr, luma_pat, cb_pat, cr_pat, offsets, params_y, params2, bit_depth,
            sub_x, sub_y,
        )
    cb_stride, cr_stride = _check_pair(
        y, cb, cr, cb_pat, cr_pat, offsets, params2, bit_depth, sub_x, sub_y)
    b, h, w = y.shape
    _check("params_y", params_y, torch.int32, (b, P_LEN))
    y_stride = _check_pattern("luma_pat", luma_pat, b, GRAIN_H, GRAIN_W)
    outs = tuple(torch.empty_like(t) for t in (y, cb, cr))
    if b == 0:
        return outs
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.grain_fused(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), *(t.data_ptr() for t in outs),
            luma_pat.data_ptr(), y_stride, cb_pat.data_ptr(), cb_stride,
            cr_pat.data_ptr(), cr_stride, offsets.data_ptr(), params_y.data_ptr(),
            params2.data_ptr(), b, h, w, sub_x, sub_y, bit_depth, _stream(y),
        )
    _raise_on(err, "grain_fused launch")
    _launched("grain_fused", _FUSED_LAYOUT[sub_x, sub_y])
    return outs


def generate_patterns_packed(
    p: GrainParamsBatch, bit_depth: int, sub_x: int = 1, sub_y: int = 1,
    monochrome: bool = False,
) -> torch.Tensor:
    """Grain patterns of a parameter batch, made on its device: a new
    (B, 73 * 82 [+ 2 ch cw]) int16 tensor in the layout of
    ``grain.pack_patterns`` (luma, then Cb and Cr unless monochrome)."""
    if _on_cpu(p.buffer):
        return generate_patterns_packed_reference(p, bit_depth, sub_x, sub_y, monochrome)
    return pattern_kernel(pattern_params(p), bit_depth, sub_x, sub_y, monochrome)


def pattern_kernel(
    rows: torch.Tensor,  # (B, Q_LEN) int32 from pattern_params, on a CUDA device
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
) -> torch.Tensor:
    """The pattern kernel's launch on ``pattern_params`` rows: the packed
    patterns of ``generate_patterns_packed``. CUDA tensors only."""
    if rows.device.type != "cuda":
        raise ValueError(f"pattern_kernel takes rows on a CUDA device, got {rows.device}")
    _check_depth_and_subsampling(bit_depth, sub_x, sub_y)
    b = rows.shape[0]
    _check("rows", rows, torch.int32, (b, Q_LEN))
    gauss = gaussian_table(rows.device)
    ch, cw = chroma_pattern_shape(sub_x, sub_y)
    n = GRAIN_H * GRAIN_W + (0 if monochrome else 2 * ch * cw)
    out = torch.empty((b, n), dtype=torch.int16, device=rows.device)
    if b == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(rows.device):
        err = lib.grain_pattern(
            rows.data_ptr(), gauss.data_ptr(), out.data_ptr(), n, b,
            sub_x, sub_y, bit_depth, int(monochrome), _stream(rows),
        )
    _raise_on(err, "grain_pattern launch")
    _launched("grain_pattern")
    return out


def grain_tables(
    buf: torch.Tensor,  # (B, PARAMS_WIDTH) int32 parameter buffer
    height: int,
    width: int,
    bit_depth: int,
    chroma: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """A batch's tables for frames of ``height`` x ``width``, in one
    launch: new (B, P_LEN) luma rows, (2B, P_LEN) Cb then Cr rows (None
    unless ``chroma``), (B, S, NB) block offsets and (B, Q_LEN) pattern
    rows, all int32, equal to ``grain_tables_reference``'s."""
    if buf.dtype != torch.int32:
        raise TypeError(f"buf: expected torch.int32, got {buf.dtype}")
    if buf.dim() != 2 or buf.shape[1] != PARAMS_WIDTH:
        raise ValueError(f"buf: expected shape (B, {PARAMS_WIDTH}), got {tuple(buf.shape)}")
    if bit_depth not in (8, 10, 12):
        raise ValueError(f"bit depth {bit_depth} not in (8, 10, 12)")
    if height < 0 or width < 0:
        raise ValueError(f"frames of {height}x{width}")
    if _on_cpu(buf):
        return grain_tables_reference(buf, height, width, bit_depth, chroma)
    if not buf.is_contiguous():
        raise ValueError("buf: must be contiguous")
    b = buf.shape[0]
    s, nb = (height + BLOCK - 1) // BLOCK, (width + BLOCK - 1) // BLOCK

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=buf.device)

    params_y, offsets, rows = empty(b, P_LEN), empty(b, s, nb), empty(b, Q_LEN)
    params2 = empty(2 * b, P_LEN) if chroma else None
    if b == 0:
        return params_y, params2, offsets, rows
    lib = _build.load()
    with torch.cuda.device(buf.device):
        err = lib.grain_tables(
            buf.data_ptr(), params_y.data_ptr(), None if params2 is None else params2.data_ptr(),
            offsets.data_ptr(), rows.data_ptr(), b, s, nb, bit_depth, _stream(buf),
        )
    _raise_on(err, "grain_tables launch")
    _launched("grain_tables")
    return params_y, params2, offsets, rows
