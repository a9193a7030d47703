"""The two kernels of the diff path (counterparts of the Pallas kernels in
grav1synth_tpu/ops/diff_pallas.py), each beside its plain PyTorch version.

- ``flat_block_activity`` -> CUDA ``flat_block_activity_kernel``
  (replaces ``diff_pallas._act_kernel`` and the column pooling that
  ``pallas_flat_blocks`` did after it)
- ``plane_stats``         -> CUDA ``plane_stats_kernel``
  (replaces ``diff_pallas._stats_kernel`` in its block-mask mode,
  ``pallas_plane_stats(..., mask_blocks=16)``)

Both are exact: the kernels sum int32 products in int64 and the plain
versions compute in float64, where every sum of one frame is an integer
below 2^53, so the two agree to the last bit. ``plane_stats`` returns the
JAX package's dict (ata, atb, n_ar, bin_cnt, bin_sum, bin_sumsq; leading
batch dim) in float64.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it checks device, dtype, shape and contiguity, then launches the
kernel or raises, and counts the launch in ``utils.spans``'
``launch.<kernel>`` counter.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import spans
from .grain_kernels import _check, _on_cpu, _raise_on, _stream

FLAT_BLOCK = 16
NUM_BINS = 64

def offsets(lag: int) -> List[Tuple[int, int]]:
    """(0,0) first, then the causal lag window (diff_pallas._offsets)."""
    out = [(0, 0)]
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            out.append((dr, dc))
    return out


def _n_design(lag: int, has_aux: bool) -> int:
    return len(offsets(lag)) + (1 if has_aux else 0)


def _unpack(gram, n_ar, cnt, bsum, bsumsq, has_aux: bool) -> dict:
    """Gram of the design rows (B, P, P) float64 -> the JAX package's
    statistics (diff_pallas.py:542-554): row 0 is the unshifted residual,
    the others the design columns; the aux row and column (x4-scaled)
    are divided back by 4, the aux-aux entry by 16."""
    ata = gram[:, 1:, 1:].clone()
    atb = gram[:, 0, 1:].clone()
    if has_aux:
        ata[:, -1, :] /= 4.0
        ata[:, :, -1] /= 4.0
        atb[:, -1] /= 4.0
    return dict(
        ata=ata, atb=atb, n_ar=n_ar, bin_cnt=cnt, bin_sum=bsum, bin_sumsq=bsumsq
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions


def flat_block_activity_reference(d: torch.Tensor) -> torch.Tensor:
    b, h, w = d.shape
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    v = d.to(torch.int32)
    gx = F.pad((v[:, :, 1:] - v[:, :, :-1]).abs(), (0, 1))
    gy = F.pad((v[:, 1:, :] - v[:, :-1, :]).abs(), (0, 0, 0, 1))
    act = (gx + gy)[:, : hb * FLAT_BLOCK, : wb * FLAT_BLOCK]
    return (
        act.reshape(b, hb, FLAT_BLOCK, wb, FLAT_BLOCK).sum((2, 4), dtype=torch.int32)
    )


def _pixel_flat(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, hb, wb) block map -> (B, h, w) bool, zero past the last full
    block row and column."""
    b, hb, wb = blocks.shape
    out = torch.zeros((b, h, w), dtype=torch.bool, device=blocks.device)
    out[:, : hb * FLAT_BLOCK, : wb * FLAT_BLOCK] = (
        (blocks != 0)
        .repeat_interleave(FLAT_BLOCK, 1)
        .repeat_interleave(FLAT_BLOCK, 2)
    )
    return out


def plane_stats_reference(
    s: torch.Tensor,  # (B, H, W) int16 source plane
    d: torch.Tensor,  # (B, H, W) int16 denoised plane
    blocks: torch.Tensor,  # (B, H//16, W//16) uint8 flat-block map
    aux4: Optional[torch.Tensor],  # (B, H, W) int16 x4 luma residual, or None
    lag: int,
    bit_depth: int,
) -> dict:
    b, h, w = s.shape
    dev = s.device
    f64 = torch.float64
    r = s.to(f64) - d.to(f64)
    flat = _pixel_flat(blocks, h, w)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    interior = ((rows >= lag) & (rows < h - lag))[:, None] & (
        (cols >= lag) & (cols < w - lag)
    )[None, :]
    m = (flat & interior).to(f64)
    rp = F.pad(r, (lag, lag, lag, lag))
    p = _n_design(lag, aux4 is not None)
    gram = torch.zeros((b, p, p), dtype=f64, device=dev)
    for i in range(b):
        design = [
            rp[i, lag + dr : lag + dr + h, lag + dc : lag + dc + w]
            for dr, dc in offsets(lag)
        ]
        if aux4 is not None:
            design.append(aux4[i].to(f64))
        x = (torch.stack(design) * m[i]).reshape(p, -1)
        gram[i] = x @ x.T

    bins = d.to(torch.int64) >> (bit_depth - 6)
    valid = flat & (bins >= 0) & (bins < NUM_BINS)
    cnt = torch.zeros((b, NUM_BINS), dtype=f64, device=dev)
    bsum = torch.zeros_like(cnt)
    bsumsq = torch.zeros_like(cnt)
    for i in range(b):
        idx = bins[i][valid[i]]
        ri = r[i][valid[i]]
        cnt[i] = torch.bincount(idx, minlength=NUM_BINS).to(f64)
        bsum[i] = torch.bincount(idx, weights=ri, minlength=NUM_BINS)
        bsumsq[i] = torch.bincount(idx, weights=ri * ri, minlength=NUM_BINS)
    return _unpack(gram, m.sum((1, 2)), cnt, bsum, bsumsq, aux4 is not None)


# ---------------------------------------------------------------------------
# CUDA wrappers


def flat_block_activity(d: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int16 denoised plane -> (B, H//16, W//16) int32: each
    full 16x16 block's sum of |horizontal| + |vertical| sample steps."""
    if _on_cpu(d):
        return flat_block_activity_reference(d)
    b, h, w = d.shape
    _check("d", d, torch.int16, (b, h, w))
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    out = torch.empty((b, hb, wb), dtype=torch.int32, device=d.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(d.device):
        err = lib.diff_flat_block_activity(
            d.data_ptr(), out.data_ptr(), b, h, w, _stream(d)
        )
    _raise_on(err, "diff_flat_block_activity launch")
    spans.count("launch.flat_block_activity")
    return out


def plane_stats(
    s: torch.Tensor,  # (B, H, W) int16
    d: torch.Tensor,  # (B, H, W) int16
    blocks: torch.Tensor,  # (B, H//16, W//16) uint8
    aux4: Optional[torch.Tensor],  # (B, H, W) int16, or None
    lag: int,
    bit_depth: int,
) -> dict:
    """Masked lag-window Gram and 64-bin residual moments of r = s - d,
    per frame (the production block-mask mode of
    ``diff_pallas.pallas_plane_stats``). A plane without a full block
    has an empty block map and gives all-zero statistics.

    On the card the sums are exact for samples in range, which the caller
    keeps to and nothing checks: ``s`` and ``d`` in [0, 2**bit_depth), as
    a decoder gives them, and ``aux4`` a sum of four residuals of such
    planes (|aux4| <= 4 * (2**bit_depth - 1)). The kernel adds runs of
    products in 32 bits on those bounds; samples outside them can overflow
    unseen, where ``plane_stats_reference`` stays exact."""
    tensors = (s, d, blocks) + (() if aux4 is None else (aux4,))
    if _on_cpu(*tensors):
        return plane_stats_reference(s, d, blocks, aux4, lag, bit_depth)
    b, h, w = s.shape
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    _check("s", s, torch.int16, (b, h, w))
    _check("d", d, torch.int16, (b, h, w))
    _check("blocks", blocks, torch.uint8, (b, hb, wb))
    if aux4 is not None:
        _check("aux4", aux4, torch.int16, (b, h, w))
    if lag not in (1, 2, 3):
        raise ValueError(f"lag {lag} not in (1, 2, 3)")
    if bit_depth not in (8, 10, 12):
        raise ValueError(f"bit depth {bit_depth} not in (8, 10, 12)")
    p = _n_design(lag, aux4 is not None)
    npair = p * (p + 1) // 2
    out = torch.zeros((b, npair + 1 + 3 * NUM_BINS), dtype=torch.int64, device=s.device)
    if b > 0 and h > 0 and w > 0:
        lib = _build.load()
        with torch.cuda.device(s.device):
            err = lib.diff_plane_stats(
                s.data_ptr(), d.data_ptr(), blocks.data_ptr(),
                None if aux4 is None else aux4.data_ptr(), out.data_ptr(),
                b, h, w, hb, wb, lag, bit_depth, _stream(s),
            )
        _raise_on(err, "diff_plane_stats launch")
        spans.count("launch.plane_stats")
    sums = out.to(torch.float64)
    iu = torch.triu_indices(p, p, device=s.device)
    gram = torch.zeros((b, p, p), dtype=torch.float64, device=s.device)
    gram[:, iu[0], iu[1]] = sums[:, :npair]
    gram[:, iu[1], iu[0]] = sums[:, :npair]
    mom = sums[:, npair + 1 :].reshape(b, 3, NUM_BINS)
    return _unpack(
        gram, sums[:, npair], mom[:, 0], mom[:, 1], mom[:, 2], aux4 is not None
    )
