"""The two kernels of the estimate path (counterparts of the jitted device
program of grav1synth_tpu/ops/estimate.py), each beside its plain PyTorch
version.

- ``self_blur``  -> CUDA ``self_blur_kernel`` (K8; replaces the JAX
  package's ``_box_blur`` with the round and clip of ``frame_self_stats``)
- ``self_stats`` -> CUDA ``self_stats_kernel`` (K9; replaces
  ``diff_estimate._masked_normal_eqs`` and ``_binned_moments`` as
  ``frame_self_stats`` / ``frame_self_stats_chroma`` call them)

Both are exact. The blur is integer arithmetic. The statistics kernel sums
products of the integers q (and the pooled luma column) in int64, and the
plain version in float64, where every sum of one frame is an integer below
2^53 on real planes, so the two agree to the last bit there. Both finish
through ``_finish``: the same float64 scaling of the same integer sums.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it checks device, dtype, shape and contiguity, then launches the
kernel or raises, and counts the launch in ``utils.spans``'
``launch.<kernel>`` counter.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import spans
from .diff_kernels import FLAT_BLOCK, NUM_BINS, _n_design, _pixel_flat, offsets
from .grain_kernels import _check, _on_cpu, _raise_on, _stream

BLUR = 9  # pseudo-denoiser box width: wide enough that the high-pass
# barely touches lags 0..3, where the AR window lives
EDGE = BLUR // 2  # band on every side that the zero padding biases
AREA = BLUR * BLUR
LAGS = (0, 1, 2, 3)
# bytes of one float64 design chunk (B x P x rows x W) of the plain Gram
_CHUNK_BYTES = 1 << 28

# ---------------------------------------------------------------------------
# Plain PyTorch versions


def self_blur_reference(f: torch.Tensor, bit_depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) integer plane -> (den, q): the blurred plane rounded to
    int16 samples, clip(round(S / 81), 0, max), and the int32 residual
    times 81, q = 81 f - S. S is the sum over the 9x9 box around each
    sample, zero outside the plane ("SAME" padding): a prefix sum along
    each axis, then the difference of its ends, exact in int32 up to
    (H + 9) x 9 x 4095 < 2^31. ``S / 81`` never lies within 0.5/81 of a
    half-integer, and the float32 blur of the JAX package stays far inside
    that margin, so this ``den`` equals its ``round(_box_blur(f))``
    exactly."""
    f = f.to(torch.int32)
    s = F.pad(f, (EDGE + 1, EDGE)).cumsum(2, dtype=torch.int32)
    s = s[:, :, BLUR:] - s[:, :, :-BLUR]
    s = F.pad(s, (0, 0, EDGE + 1, EDGE)).cumsum(1, dtype=torch.int32)
    s = s[:, BLUR:] - s[:, :-BLUR]
    den = torch.clamp((s + AREA // 2) // AREA, 0, (1 << bit_depth) - 1).to(torch.int16)
    return den, AREA * f - s


def _band(h: int, w: int, device) -> torch.Tensor:
    """(h, w) bool: the samples at least EDGE from every side."""
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    return ((rows >= EDGE) & (rows < h - EDGE))[:, None] & (
        (cols >= EDGE) & (cols < w - EDGE)
    )[None, :]


def _masked_gram(cols, offs, interior: torch.Tensor, lag: int) -> torch.Tensor:
    """(B, P, P) float64 Gram of the design whose row k is ``cols[k]``
    shifted by ``offs[k]`` at every interior pixel (the (H - 2 lag,
    W - 2 lag) crop), times the 0/1 ``interior`` mask. Built over row
    chunks so the stacked design stays near _CHUNK_BYTES, as one (P, W)
    product per image row."""
    b, hp, wp = interior.shape
    p = len(cols)
    gram = torch.zeros((b, p, p), dtype=torch.float64, device=interior.device)
    if hp <= 0 or wp <= 0:
        return gram
    m = interior.to(torch.float64)
    step = max(1, _CHUNK_BYTES // (8 * b * p * wp))
    x = torch.empty((b, min(step, hp), p, wp), dtype=torch.float64, device=interior.device)
    for r0 in range(0, hp, step):
        n = min(step, hp - r0)
        for k, (c, (dr, dc)) in enumerate(zip(cols, offs)):
            # the masked shifted slice, written straight into its design row
            torch.mul(
                c[:, lag + dr + r0 : lag + dr + r0 + n, lag + dc : lag + dc + wp],
                m[:, r0 : r0 + n],
                out=x[:, :n, k],
            )
        xn = x[:, :n]
        gram += (xn @ xn.transpose(2, 3)).sum(1)
    return gram


def _finish(gram, n_ar, cnt, qsum, qsq, n_pool: Optional[int]) -> dict:
    """Integer-valued float64 sums -> the JAX package's statistics (leading
    batch dim): the Gram scaled by 1/81 per q column and 1/(81 n_pool) for
    the pooled luma column (``n_pool`` None for luma), row 0 (q itself) the
    right-hand side; the bin sums of q and q^2 over 81 and 81^2."""
    p = gram.shape[1]
    scale = [1.0 / AREA] * (p - (n_pool is not None)) + (
        [] if n_pool is None else [1.0 / (AREA * n_pool)]
    )
    sc = torch.tensor(scale, dtype=torch.float64, device=gram.device)
    gram = gram * sc[:, None] * sc[None, :]
    return dict(
        ata=gram[:, 1:, 1:],
        atb=gram[:, 0, 1:],
        n_ar=n_ar,
        bin_cnt=cnt,
        bin_sum=_divide(qsum, float(AREA)),
        bin_sumsq=_divide(qsq, float(AREA * AREA)),
    )


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. PyTorch's CUDA division by
    a Python number multiplies by its reciprocal, which can differ from the
    CPU's quotient in the last bit; a tensor divisor divides."""
    return x / torch.full_like(x, d)


def self_stats_reference(
    q: torch.Tensor,  # (B, H, W) int32 residual x 81
    den: torch.Tensor,  # (B, H, W) int16 blurred plane
    blocks: torch.Tensor,  # (B, H//16, W//16) uint8 flat-block map of den
    lsum: Optional[torch.Tensor],  # (B, H, W) int32 pooled luma q, or None
    n_pool: int,
    lag: int,
    bit_depth: int,
) -> dict:
    """The Gram by ``torch.matmul`` over row chunks of the shifted, masked
    float64 design, the moments by ``bincount``. Exact while every sum of a
    frame stays below 2^53."""
    b, h, w = q.shape
    dev = q.device
    f64 = torch.float64
    mask = _pixel_flat(blocks, h, w) & _band(h, w, dev)
    interior = mask[:, lag : h - lag, lag : w - lag]

    qf = q.to(f64)
    offs = offsets(lag)  # (0, 0), the residual itself, first
    design = [qf] * len(offs)
    if lsum is not None:
        design.append(lsum.to(f64))
        offs = offs + [(0, 0)]
    gram = _masked_gram(design, offs, interior, lag)

    # den is in [0, max], so clip(den * 64 // (max + 1)) is this shift
    bins = den.to(torch.int64) >> (bit_depth - 6)
    idx = (bins + NUM_BINS * torch.arange(b, device=dev)[:, None, None]).reshape(-1)
    mf = mask.reshape(-1).to(f64)
    qm = qf.reshape(-1) * mf

    def per_bin(weights):
        return torch.bincount(idx, weights=weights, minlength=b * NUM_BINS).reshape(
            b, NUM_BINS
        )

    return _finish(
        gram,
        interior.sum((1, 2)).to(f64),
        per_bin(mf),
        per_bin(qm),
        per_bin(qm * qf.reshape(-1)),
        None if lsum is None else n_pool,
    )


# ---------------------------------------------------------------------------
# CUDA wrappers


def self_blur(f: torch.Tensor, bit_depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int16 or uint8 plane -> (den int16, q int32), as
    ``self_blur_reference``."""
    if _on_cpu(f):
        return self_blur_reference(f, bit_depth)
    if f.dim() != 3:
        raise ValueError(f"f: expected (B, H, W), got shape {tuple(f.shape)}")
    b, h, w = f.shape
    if f.dtype not in (torch.int16, torch.uint8):
        raise TypeError(f"f: expected torch.int16 or torch.uint8, got {f.dtype}")
    _check("f", f, f.dtype, (b, h, w))
    if bit_depth not in (8, 10, 12):
        raise ValueError(f"bit depth {bit_depth} not in (8, 10, 12)")
    den = torch.empty((b, h, w), dtype=torch.int16, device=f.device)
    q = torch.empty((b, h, w), dtype=torch.int32, device=f.device)
    if den.numel() == 0:
        return den, q
    lib = _build.load()
    with torch.cuda.device(f.device):
        err = lib.estimate_self_blur(
            f.data_ptr(), int(f.dtype == torch.uint8), den.data_ptr(), q.data_ptr(),
            b, h, w, bit_depth, _stream(f),
        )
    _raise_on(err, "estimate_self_blur launch")
    spans.count("launch.self_blur")
    return den, q


def self_stats(
    q: torch.Tensor,  # (B, H, W) int32
    den: torch.Tensor,  # (B, H, W) int16
    blocks: torch.Tensor,  # (B, H//16, W//16) uint8
    lsum: Optional[torch.Tensor],  # (B, H, W) int32, or None
    n_pool: int,
    lag: int,
    bit_depth: int,
) -> dict:
    """Per-frame statistics of one plane from its blur: the lag-window
    normal equations of r = q / 81 in the flat blocks of ``den`` inside the
    edge band, plus, for chroma, the column ``lsum / (81 n_pool)``; and the
    residual's 64-bin moments on ``den`` over the same pixels. float64,
    leading batch dim (the layout of estimate.batch_self_stats). A plane
    without a full block, or narrower than the band, gives all-zero
    statistics.

    On the card the sums are exact for inputs in range, which the caller
    keeps to and nothing checks: ``q`` and ``den`` from ``self_blur`` of
    samples in [0, 2**bit_depth), ``lsum`` a sum of ``n_pool`` such q."""
    tensors = (q, den, blocks) + (() if lsum is None else (lsum,))
    if _on_cpu(*tensors):
        return self_stats_reference(q, den, blocks, lsum, n_pool, lag, bit_depth)
    b, h, w = q.shape
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    _check("q", q, torch.int32, (b, h, w))
    _check("den", den, torch.int16, (b, h, w))
    _check("blocks", blocks, torch.uint8, (b, hb, wb))
    if lsum is not None:
        _check("lsum", lsum, torch.int32, (b, h, w))
        if n_pool not in (1, 2, 4):
            raise ValueError(f"n_pool {n_pool} not in (1, 2, 4)")
    if lag not in LAGS:
        raise ValueError(f"lag {lag} not in {LAGS}")
    if bit_depth not in (8, 10, 12):
        raise ValueError(f"bit depth {bit_depth} not in (8, 10, 12)")
    p = _n_design(lag, lsum is not None)
    out = torch.zeros((b, p * (p + 1) // 2 + 1 + 3 * NUM_BINS), dtype=torch.int64, device=q.device)
    if b > 0 and h > 0 and w > 0:
        lib = _build.load()
        with torch.cuda.device(q.device):
            err = lib.estimate_self_stats(
                q.data_ptr(), den.data_ptr(), blocks.data_ptr(),
                None if lsum is None else lsum.data_ptr(), out.data_ptr(),
                b, h, w, hb, wb, lag, 1 if lsum is None else n_pool, bit_depth, _stream(q),
            )
        _raise_on(err, "estimate_self_stats launch")
        spans.count("launch.self_stats")
    return _unpack_self_stats(out, p, None if lsum is None else n_pool)


# (p, device) -> for each entry of a (p, p) Gram, the index of its pair in
# the kernel's row-major upper triangle
_PAIR_INDEX: Dict[Tuple[int, str], torch.Tensor] = {}


def _pair_index(p: int, device) -> torch.Tensor:
    key = (p, str(device))
    idx = _PAIR_INDEX.get(key)
    if idx is None:
        i = torch.arange(p)
        lo, hi = torch.minimum(i[:, None], i[None, :]), torch.maximum(i[:, None], i[None, :])
        # pairs (r, c), r <= c, row-major: row r starts at r p - r (r - 1) / 2
        idx = (lo * p - lo * (lo - 1) // 2 + hi - lo).reshape(-1).to(device)
        _PAIR_INDEX[key] = idx
    return idx


def _unpack_self_stats(out: torch.Tensor, p: int, n_pool: Optional[int]) -> dict:
    """The kernel's (B, P(P+1)/2 + 1 + 3 x 64) int64 sums (the row-major
    upper triangle of the Gram, n_ar, then the bins' counts, sums and sums
    of squares) -> the statistics (``_finish``; ``n_pool`` None for luma)."""
    b = out.shape[0]
    npair = p * (p + 1) // 2
    sums = out.to(torch.float64)
    gram = sums[:, _pair_index(p, out.device)].reshape(b, p, p)
    mom = sums[:, npair + 1 :].reshape(b, 3, NUM_BINS)
    return _finish(gram, sums[:, npair], mom[:, 0], mom[:, 1], mom[:, 2], n_pool)
