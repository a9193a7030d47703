"""Plain PyTorch per-frame statistics of the diff and estimate paths, the
benchmark's reference for what the port's kernels produce.

Written from the definitions (the JAX package's ``diff_estimate`` and
``estimate`` programs), one frame at a time, with ``torch.matmul`` for the
Gram and ``bincount`` for the binned moments:

- the flat-block map of a denoised plane: each full 16x16 block's mean
  |horizontal| + |vertical| step, flat where it lies below 1.5 x the
  frame's median block value + 1e-3, in float32;
- diff (``pair_stats``): r = source - denoised; the Gram of the design
  [r at (0, 0), r at the causal lag window, the x4 luma-residual column on
  chroma] over the flat pixels at least ``lag`` from every side, and the
  count, sum and sum of squares of r in 64 bins of the denoised sample
  over every flat pixel;
- estimate (``self_stats``): the 9x9 box sum S with zero padding,
  den = clip(round(S / 81)) and q = 81 f - S; the Gram of q's design (the
  pooled luma q as the extra chroma column) over the flat pixels of den
  at least 4 from every side, and the binned moments of q over the same
  pixels, scaled by 1/81 per q column.

``dtype`` is float64 for the reference. The control computes the same in
float32 (TF32 off), the precision below the one the configurations state.
Every statistic comes back as numpy float64, one dict per frame, keyed as
the port's estimators key them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FLAT_BLOCK = 16
NUM_BINS = 64
BLUR = 9
EDGE = BLUR // 2
AREA = BLUR * BLUR
ROW_CHUNK = 256  # image rows per Gram product


def offsets(lag: int) -> List[Tuple[int, int]]:
    """(0, 0) first, then the causal lag window in raster order."""
    out = [(0, 0)]
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            out.append((dr, dc))
    return out


def flat_map(d: torch.Tensor) -> torch.Tensor:
    """(H, W) integer plane -> (H // 16, W // 16) bool flat-block map."""
    h, w = d.shape
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    if hb == 0 or wb == 0:
        return torch.zeros((hb, wb), dtype=torch.bool, device=d.device)
    v = d.to(torch.int32)
    gx = F.pad((v[:, 1:] - v[:, :-1]).abs(), (0, 1))
    gy = F.pad((v[1:, :] - v[:-1, :]).abs(), (0, 0, 0, 1))
    act = (gx + gy)[: hb * FLAT_BLOCK, : wb * FLAT_BLOCK]
    act = act.reshape(hb, FLAT_BLOCK, wb, FLAT_BLOCK).sum((1, 3), dtype=torch.int32)
    act = act.to(torch.float32) / (FLAT_BLOCK * FLAT_BLOCK)
    n = hb * wb
    srt = act.reshape(n).sort().values
    lo = (n - 1) // 2
    hw = 0.5 * (n - 1) - lo
    med = srt[lo] * (1.0 - hw) + srt[min(lo + 1, n - 1)] * hw
    return act < med * 1.5 + 1e-3


def pixel_map(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Block map -> (H, W) bool, False past the last full block."""
    hb, wb = blocks.shape
    out = torch.zeros((h, w), dtype=torch.bool, device=blocks.device)
    out[: hb * FLAT_BLOCK, : wb * FLAT_BLOCK] = blocks.repeat_interleave(
        FLAT_BLOCK, 0).repeat_interleave(FLAT_BLOCK, 1)
    return out


def band(h: int, w: int, edge: int, device) -> torch.Tensor:
    """(H, W) bool: the samples at least ``edge`` from every side."""
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    return ((rows >= edge) & (rows < h - edge))[:, None] & ((cols >= edge) & (cols < w - edge))[None, :]


def gram(columns, offs, mask: torch.Tensor, dtype) -> torch.Tensor:
    """(P, P) sum over the pixels of ``mask`` of x x^T, where x_k at pixel
    (y, x) is ``columns[k][y + dr_k, x + dc_k]``, zero outside the plane.
    ``mask`` must be False within max |offset| of every side."""
    h, w = mask.shape
    p = len(columns)
    pad = max(max(abs(dr), abs(dc)) for dr, dc in offs)
    padded = [F.pad(c.to(dtype), (pad, pad, pad, pad)) for c in columns]
    m = mask.to(dtype)
    g = torch.zeros((p, p), dtype=dtype, device=mask.device)
    for r0 in range(0, h, ROW_CHUNK):
        n = min(ROW_CHUNK, h - r0)
        x = torch.stack([
            c[pad + dr + r0 : pad + dr + r0 + n, pad + dc : pad + dc + w] * m[r0 : r0 + n]
            for c, (dr, dc) in zip(padded, offs)
        ]).reshape(p, -1)
        g += x @ x.T
    return g


def binned(key: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, dtype):
    """Count, sum and sum of squares of ``values`` over ``mask`` in the 64
    bins ``key`` gives."""
    idx = key[mask]
    v = values[mask].to(dtype)
    cnt = torch.bincount(idx, minlength=NUM_BINS).to(dtype)
    return (cnt, torch.bincount(idx, weights=v, minlength=NUM_BINS),
            torch.bincount(idx, weights=v * v, minlength=NUM_BINS))


def _host(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.to(torch.float64).cpu().numpy() for k, v in d.items()}


def pool_sum(p: torch.Tensor, hc: int, wc: int, sub_x: int, sub_y: int) -> torch.Tensor:
    """(H, W) luma -> (hc, wc) int32 sums over each chroma sample's
    collocated luma block, the last row and column repeated where the
    chroma plane reaches past the luma plane."""
    h, w = p.shape
    need_h, need_w = hc << sub_y, wc << sub_x
    p = p[:need_h, :need_w].to(torch.int32)
    if need_h > h:
        p = torch.cat([p, p[-1:].expand(need_h - h, p.shape[1])], 0)
    if need_w > w:
        p = torch.cat([p, p[:, -1:].expand(need_h, need_w - w)], 1)
    return p.reshape(hc, 1 << sub_y, wc, 1 << sub_x).sum((1, 3), dtype=torch.int32)


def pair_plane_stats(s, d, aux4, lag: int, bit_depth: int, dtype=torch.float64) -> dict:
    """One plane of a source/denoised pair (integer (H, W) tensors at the
    source's depth); ``aux4`` the x4 luma-residual column or None."""
    h, w = s.shape
    dev = s.device
    r = s.to(torch.int32) - d.to(torch.int32)
    flat = pixel_map(flat_map(d), h, w)
    mask = flat & band(h, w, lag, dev)
    offs = offsets(lag)
    cols = [r] * len(offs)
    if aux4 is not None:
        cols.append(aux4)
        offs = offs + [(0, 0)]
    g = gram(cols, offs, mask, dtype)
    key = d.to(torch.int64) >> (bit_depth - 6)
    valid = flat & (key >= 0) & (key < NUM_BINS)
    cnt, bsum, bsumsq = binned(key, r, valid, dtype)
    ata, atb = g[1:, 1:].clone(), g[0, 1:].clone()
    if aux4 is not None:
        ata[-1, :] /= 4.0
        ata[:, -1] /= 4.0
        atb[-1] /= 4.0
    return _host(dict(ata=ata, atb=atb, n_ar=mask.sum().to(dtype), bin_cnt=cnt,
                      bin_sum=bsum, bin_sumsq=bsumsq))


def pair_stats(src, den, lag: int, bit_depth: int, dtype=torch.float64):
    """A frame pair's statistics: ``src`` and ``den`` are [y] or [y, cb, cr]
    integer tensors on one device. Returns (y, cb, cr) dicts, chroma None
    for a luma-only pair."""
    y = pair_plane_stats(src[0], den[0], None, lag, bit_depth, dtype)
    if len(src) < 3:
        return y, None, None
    (h, w), (hc, wc) = src[0].shape, src[1].shape
    sub_x, sub_y = int(wc < w), int(hc < h)
    pooled = pool_sum(src[0], hc, wc, sub_x, sub_y) - pool_sum(den[0], hc, wc, sub_x, sub_y)
    aux4 = (pooled << (2 - sub_x - sub_y)).to(torch.int16)
    return (y,) + tuple(pair_plane_stats(src[k], den[k], aux4, lag, bit_depth, dtype)
                        for k in (1, 2))


def blur(f: torch.Tensor, bit_depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) integer plane -> (den, q): den = clip(round(S / 81), 0, max),
    q = 81 f - S, S the 9x9 box sum with zeros outside the plane."""
    f = f.to(torch.int64)
    s = F.pad(f, (EDGE, EDGE, EDGE, EDGE)).unfold(1, BLUR, 1).sum(2).unfold(0, BLUR, 1).sum(2)
    den = torch.clamp((s + AREA // 2) // AREA, 0, (1 << bit_depth) - 1)
    return den, AREA * f - s


def self_plane_stats(q, den, lsum, n_pool: int, lag: int, bit_depth: int,
                     dtype=torch.float64) -> dict:
    h, w = q.shape
    dev = q.device
    # the band is wider than any lag, so the Gram's pixels are the band's
    mask = pixel_map(flat_map(den), h, w) & band(h, w, EDGE, dev)
    offs = offsets(lag)
    cols = [q] * len(offs)
    if lsum is not None:
        cols.append(lsum)
        offs = offs + [(0, 0)]
    g = gram(cols, offs, mask, dtype)
    cnt, qsum, qsq = binned(den >> (bit_depth - 6), q, mask, dtype)
    p = g.shape[0]
    scale = [1.0 / AREA] * (p - (lsum is not None)) + ([] if lsum is None else [1.0 / (AREA * n_pool)])
    sc = torch.tensor(scale, dtype=dtype, device=dev)
    g = g * sc[:, None] * sc[None, :]
    return _host(dict(ata=g[1:, 1:], atb=g[0, 1:], n_ar=mask.sum().to(dtype), bin_cnt=cnt,
                      bin_sum=qsum / torch.full_like(qsum, float(AREA)),
                      bin_sumsq=qsq / torch.full_like(qsq, float(AREA * AREA))))


def self_stats(planes, lag: int, bit_depth: int, dtype=torch.float64):
    """A grainy frame's statistics: ``planes`` is [y] or [y, cb, cr] integer
    tensors on one device. Returns (y, cb, cr) dicts, chroma None for a
    luma-only frame."""
    den_y, q_y = blur(planes[0], bit_depth)
    y = self_plane_stats(q_y, den_y, None, 1, lag, bit_depth, dtype)
    if len(planes) < 3:
        return y, None, None
    (h, w), (hc, wc) = planes[0].shape, planes[1].shape
    sub_x, sub_y = int(wc < w), int(hc < h)
    lsum = pool_sum(q_y, hc, wc, sub_x, sub_y)
    out = [y]
    for k in (1, 2):
        den, q = blur(planes[k], bit_depth)
        out.append(self_plane_stats(q, den, lsum, (1 + sub_x) * (1 + sub_y), lag, bit_depth, dtype))
    return tuple(out)


def as_tensor(a, device) -> torch.Tensor:
    """A decoder's plane (uint8 or uint16 numpy, or a tensor) as an int32
    tensor on ``device``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a.astype(np.int32))
    return a.to(device=device, dtype=torch.int32)


def self_stats_frames(frames, bit_depth: int, lag: int, device="cpu", dtype=torch.float64):
    """Per-frame statistics of a list of plane lists, as lists: (y, cb, cr),
    cb and cr None when the frames are luma-only. ``fit.NoiseChunk``
    calibrates through this."""
    outs = [self_stats([as_tensor(p, device) for p in f], lag, bit_depth, dtype) for f in frames]
    y = [o[0] for o in outs]
    if outs[0][1] is None:
        return y, None, None
    return y, [o[1] for o in outs], [o[2] for o in outs]
