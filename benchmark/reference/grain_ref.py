"""Frozen copy of ``grav1synth_tpu_torch/ops/grain_ref.py`` at commit
301318fd362891bc8f8c0520c6b680db7a8800b4, the benchmark's reference for
the apply path: AV1 film grain synthesis (spec section 7.18.3) in numpy,
integer-exact, validated against dav1d. Only its imports changed: the
grain parameters and the Gaussian sequence come from this folder.

Pipeline per frame:
  1. generate_grain: LFSR-driven pseudo-Gaussian base noise, AR filter
     over a 82x73 luma pattern and 44x38 (420) chroma patterns.
  2. scaling LUT: piecewise-linear from the coded points.
  3. block application: 32x32 luma blocks with per-stripe reseeded
     random pattern offsets, optional 2-pixel overlap blending, scaling
     by the local signal value, and clipping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .types import GAUSSIAN_SEQUENCE, FilmGrainParams

GRAIN_W = 82
GRAIN_H = 73
BLOCK = 32


def round2(x, shift):
    """Spec Round2 for scalars/arrays (arithmetic, works on negatives)."""
    if shift == 0:
        return x
    add = 1 << (shift - 1)
    return (x + add) >> shift


class Lfsr:
    """The 16-bit LFSR from spec 7.18.3.2."""

    __slots__ = ("state",)

    def __init__(self, seed: int):
        self.state = seed & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.state
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.state = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _gaussian_block(lfsr: Lfsr, h: int, w: int, shift: int) -> np.ndarray:
    out = np.empty((h, w), dtype=np.int32)
    g = GAUSSIAN_SEQUENCE
    for y in range(h):
        for x in range(w):
            out[y, x] = g[lfsr.bits(11)]
    return round2(out, shift)


def _ar_filter_luma(grain: np.ndarray, coeffs: Sequence[int], lag: int,
                    ar_shift: int, gmin: int, gmax: int) -> None:
    if lag == 0 or not coeffs:
        return
    h, w = grain.shape
    # positions in raster order: deltaRow in [-lag, 0], deltaCol in
    # [-lag, lag], stopping before (0, 0)
    offs = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            offs.append((dr, dc))
    for y in range(3, h):
        for x in range(3, w - 3):
            s = 0
            for (dr, dc), c in zip(offs, coeffs):
                s += c * grain[y + dr, x + dc]
            v = grain[y, x] + round2(s, ar_shift)
            grain[y, x] = min(max(v, gmin), gmax)


def _ar_filter_chroma(
    grain: np.ndarray,
    luma: np.ndarray,
    coeffs: Sequence[int],
    lag: int,
    ar_shift: int,
    gmin: int,
    gmax: int,
    sub_x: int,
    sub_y: int,
    num_y_points: int,
) -> None:
    if not coeffs:
        return
    h, w = grain.shape
    offs = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            offs.append((dr, dc))
    luma_coeff = coeffs[len(offs)] if num_y_points > 0 else 0
    for y in range(3, h):
        for x in range(3, w - 3):
            s = 0
            for (dr, dc), c in zip(offs, coeffs):
                s += c * grain[y + dr, x + dc]
            if num_y_points > 0:
                luma_x = ((x - 3) << sub_x) + 3
                luma_y = ((y - 3) << sub_y) + 3
                acc = 0
                for i in range(sub_y + 1):
                    for j in range(sub_x + 1):
                        acc += int(luma[luma_y + i, luma_x + j])
                acc = round2(acc, sub_x + sub_y)
                s += luma_coeff * acc
            v = grain[y, x] + round2(s, ar_shift)
            grain[y, x] = min(max(v, gmin), gmax)


@dataclass
class GrainPatterns:
    luma: np.ndarray  # (73, 82) int32
    cb: Optional[np.ndarray]
    cr: Optional[np.ndarray]
    grain_min: int
    grain_max: int


def generate_grain(
    p: FilmGrainParams,
    bit_depth: int,
    monochrome: bool,
    sub_x: int,
    sub_y: int,
) -> GrainPatterns:
    """Spec 7.18.3.3: generate the luma/chroma grain patterns."""
    shift = 12 - bit_depth + p.grain_scale_shift
    grain_center = 128 << (bit_depth - 8)
    gmin, gmax = -grain_center, grain_center - 1
    num_y = len(p.scaling_points_y)
    num_cb = len(p.scaling_points_cb)
    num_cr = len(p.scaling_points_cr)

    if num_y > 0:
        luma = _gaussian_block(Lfsr(p.grain_seed), GRAIN_H, GRAIN_W, shift)
    else:
        luma = np.zeros((GRAIN_H, GRAIN_W), dtype=np.int32)
    _ar_filter_luma(luma, p.ar_coeffs_y, p.ar_coeff_lag, p.ar_coeff_shift, gmin, gmax)

    cb = cr = None
    if not monochrome:
        cw = 44 if sub_x else GRAIN_W
        ch = 38 if sub_y else GRAIN_H
        if num_cb > 0 or p.chroma_scaling_from_luma:
            cb = _gaussian_block(Lfsr(p.grain_seed ^ 0xB524), ch, cw, shift)
        else:
            cb = np.zeros((ch, cw), dtype=np.int32)
        if num_cr > 0 or p.chroma_scaling_from_luma:
            cr = _gaussian_block(Lfsr(p.grain_seed ^ 0x49D8), ch, cw, shift)
        else:
            cr = np.zeros((ch, cw), dtype=np.int32)
        if num_cb > 0 or p.chroma_scaling_from_luma:
            _ar_filter_chroma(
                cb, luma, p.ar_coeffs_cb, p.ar_coeff_lag, p.ar_coeff_shift,
                gmin, gmax, sub_x, sub_y, num_y,
            )
        if num_cr > 0 or p.chroma_scaling_from_luma:
            _ar_filter_chroma(
                cr, luma, p.ar_coeffs_cr, p.ar_coeff_lag, p.ar_coeff_shift,
                gmin, gmax, sub_x, sub_y, num_y,
            )
    return GrainPatterns(luma, cb, cr, gmin, gmax)


def build_scaling_lut(points: Sequence[Tuple[int, int]], bit_depth: int) -> np.ndarray:
    """Piecewise-linear scaling LUT (spec 7.18.3.5 init_scaling_function),
    expanded to the pixel-value domain for bit depths above 8 the way
    dav1d materializes it (interpolating between the 8-bit nodes)."""
    lut8 = np.zeros(256, dtype=np.int32)
    if points:
        for i in range(points[0][0]):
            lut8[i] = points[0][1]
        for j in range(len(points) - 1):
            x0, y0 = points[j]
            x1, y1 = points[j + 1]
            dx = x1 - x0
            dy = y1 - y0
            delta = dy * ((65536 + (dx >> 1)) // dx)
            for k in range(dx):
                v = y0 + ((k * delta + 32768) >> 16)
                lut8[x0 + k] = v
        for i in range(points[-1][0], 256):
            lut8[i] = points[-1][1]
    if bit_depth == 8:
        return lut8
    shift = bit_depth - 8
    pad = 1 << shift
    n = 256 << shift
    lut = np.zeros(n, dtype=np.int32)
    # rounded linear interpolation between consecutive 8-bit nodes; the
    # tail (beyond node 255) holds the last value
    for i in range(255):
        a, b = int(lut8[i]), int(lut8[i + 1])
        for r in range(pad):
            lut[(i << shift) + r] = a + (((b - a) * r + (pad >> 1)) >> shift)
    lut[255 << shift :] = lut8[255]
    return lut


def _block_offsets(
    seed: int, num_stripes: int, blocks_per_stripe: int
) -> np.ndarray:
    """Per (stripe, block) 8-bit offset randoms (spec 7.18.3.5: the
    RandomRegister is re-seeded per 32-luma-row stripe from the grain
    seed and the stripe index)."""
    out = np.empty((num_stripes, blocks_per_stripe), dtype=np.int32)
    for s in range(num_stripes):
        rr = seed & 0xFFFF
        rr ^= ((s * 37 + 178) & 255) << 8
        rr ^= (s * 173 + 105) & 255
        lf = Lfsr(rr)
        for b in range(blocks_per_stripe):
            out[s, b] = lf.bits(8)
    return out


# Overlap blend weights (spec 7.18.3.5): two samples at full resolution
# (27/17 then 17/27), a single sample (23/22) when the axis is subsampled.
_OVERLAP_W = {0: ((27, 17), (17, 27)), 1: ((23, 22),)}


def _overlap_blend(old: np.ndarray, new: np.ndarray, idx: int, sub: int) -> np.ndarray:
    w_old, w_new = _OVERLAP_W[sub][idx]
    return round2(old * w_old + new * w_new, 5)


def apply_grain_plane_luma(
    src: np.ndarray,
    patterns: GrainPatterns,
    p: FilmGrainParams,
    lut: np.ndarray,
    bit_depth: int,
) -> np.ndarray:
    """Apply grain to a luma plane. src int array (h, w); returns same."""
    h, w = src.shape
    grain_lut = patterns.luma
    gmin, gmax = patterns.grain_min, patterns.grain_max
    offsets = _block_offsets(
        p.grain_seed, (h + BLOCK - 1) // BLOCK, (w + BLOCK - 1) // BLOCK
    )
    maxval = (1 << bit_depth) - 1
    if p.clip_to_restricted_range:
        lo, hi = 16 << (bit_depth - 8), 235 << (bit_depth - 8)
    else:
        lo, hi = 0, maxval

    noise_plane = assemble_noise_plane(
        grain_lut, offsets, h, w, 0, 0, p.overlap_flag, gmin, gmax
    )
    scaling = lut[np.clip(src, 0, maxval)]
    noise = round2(scaling * noise_plane, p.scaling_shift)
    return np.clip(src + noise, lo, hi)


def assemble_noise_plane(
    grain_lut: np.ndarray,
    offsets: np.ndarray,
    h: int,
    w: int,
    sub_x: int,
    sub_y: int,
    overlap: bool,
    gmin: int,
    gmax: int,
) -> np.ndarray:
    """Assemble the per-pixel grain (pre-scaling) for a plane of (h, w)
    subsampled by (sub_x, sub_y), using per-32-luma-pixel-block offsets.

    offsets is (num_stripes, num_blocks) of 8-bit randoms; offx uses the
    high nibble, offy the low nibble (verified against dav1d)."""
    bw = BLOCK >> sub_x
    bh = BLOCK >> sub_y
    ov_cols = 2 >> sub_x  # overlap extent per axis
    ov_rows = 2 >> sub_y
    ns, nb = offsets.shape
    noise = np.zeros((h, w), dtype=np.int32)

    def off_xy(rand):
        offx = 3 + (2 >> sub_x) * (3 + (rand >> 4))
        offy = 3 + (2 >> sub_y) * (3 + (rand & 15))
        return offx, offy

    for s in range(ns):
        y0 = s * bh
        if y0 >= h:
            break
        rows = min(bh, h - y0)
        for b in range(nb):
            x0 = b * bw
            if x0 >= w:
                break
            cols = min(bw, w - x0)
            offx, offy = off_xy(offsets[s, b])
            g = grain_lut[offy : offy + rows, offx : offx + cols].astype(np.int64)
            if overlap and b > 0:
                # horizontal: leading columns blend with the left block's
                # grain continued at +bw
                loffx, loffy = off_xy(offsets[s, b - 1])
                for c in range(min(ov_cols, cols)):
                    lg = grain_lut[loffy : loffy + rows, loffx + bw + c].astype(
                        np.int64
                    )
                    g[:, c] = np.clip(
                        _overlap_blend(lg, g[:, c], c, sub_x), gmin, gmax
                    )
            if overlap and s > 0:
                # vertical: leading rows blend with the stripe above's
                # grain continued at +bh (the top grain first gets its own
                # horizontal blending)
                toffx, toffy = off_xy(offsets[s - 1, b])
                nrows = min(ov_rows, rows)
                tg = grain_lut[
                    toffy + bh : toffy + bh + nrows, toffx : toffx + cols
                ].astype(np.int64)
                if b > 0:
                    tloffx, tloffy = off_xy(offsets[s - 1, b - 1])
                    for c in range(min(ov_cols, cols)):
                        tlg = grain_lut[
                            tloffy + bh : tloffy + bh + nrows, tloffx + bw + c
                        ].astype(np.int64)
                        tg[:, c] = np.clip(
                            _overlap_blend(tlg, tg[:, c], c, sub_x), gmin, gmax
                        )
                for rr in range(nrows):
                    g[rr, :] = np.clip(
                        _overlap_blend(tg[rr, :], g[rr, :], rr, sub_y), gmin, gmax
                    )
            noise[y0 : y0 + rows, x0 : x0 + cols] = g
    return noise


def apply_grain_plane_chroma(
    src: np.ndarray,
    luma: np.ndarray,
    patterns: GrainPatterns,
    p: FilmGrainParams,
    plane: str,  # "cb" or "cr"
    lut: np.ndarray,
    bit_depth: int,
    sub_x: int,
    sub_y: int,
) -> np.ndarray:
    """Apply grain to a chroma plane, with the luma-derived scaling input
    (spec 7.18.3.5 chroma path)."""
    h, w = src.shape
    grain_lut = patterns.cb if plane == "cb" else patterns.cr
    gmin, gmax = patterns.grain_min, patterns.grain_max
    luma_h = h << sub_y
    luma_w = w << sub_x
    offsets = _block_offsets(
        p.grain_seed,
        (luma_h + BLOCK - 1) // BLOCK,
        (luma_w + BLOCK - 1) // BLOCK,
    )
    noise_plane = assemble_noise_plane(
        grain_lut, offsets, h, w, sub_x, sub_y, p.overlap_flag, gmin, gmax
    )
    maxval = (1 << bit_depth) - 1
    if p.clip_to_restricted_range:
        lo, hi = 16 << (bit_depth - 8), 240 << (bit_depth - 8)
    else:
        lo, hi = 0, maxval

    # average luma (horizontal only, even rows when vertically
    # subsampled). The spec clamps lumaX+1 to the actual luma width
    # (LumaSample coordinate clamp, 7.18.3.5), so for an odd-width luma
    # plane the final sample pairs with itself.
    real_luma_w = luma.shape[1]
    ly = luma[:: (1 << sub_y), :][:h].astype(np.int32)
    if sub_x:
        a = ly[:, 0 : 2 * w : 2]
        if 2 * w <= real_luma_w:
            b = ly[:, 1 : 2 * w : 2]
        else:  # odd luma width: last sample pairs with itself
            b = np.concatenate([ly[:, 1::2], a[:, -1:]], axis=1)
        avg = (a + b + 1) >> 1
    else:
        avg = ly[:, :w]

    if p.chroma_scaling_from_luma:
        val = avg
    else:
        if plane == "cb":
            mult, luma_mult, offset = p.cb_mult, p.cb_luma_mult, p.cb_offset
        else:
            mult, luma_mult, offset = p.cr_mult, p.cr_luma_mult, p.cr_offset
        combined = avg * (luma_mult - 128) + src.astype(np.int32) * (mult - 128)
        val = np.clip(
            (combined >> 6) + ((offset - 256) << (bit_depth - 8)), 0, maxval
        )
    scaling = lut[np.clip(val, 0, maxval)]
    noise = round2(scaling * noise_plane, p.scaling_shift)
    return np.clip(src + noise, lo, hi)


def apply_grain_frame(
    planes: List[np.ndarray],
    p: FilmGrainParams,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
) -> List[np.ndarray]:
    """Apply grain to a decoded frame (list of [y] or [y, cb, cr])."""
    monochrome = len(planes) == 1
    patterns = generate_grain(p, bit_depth, monochrome, sub_x, sub_y)
    y = planes[0].astype(np.int32)
    out = [y]
    if len(p.scaling_points_y) > 0:
        lut_y = build_scaling_lut(p.scaling_points_y, bit_depth)
        out[0] = apply_grain_plane_luma(y, patterns, p, lut_y, bit_depth)
    if not monochrome:
        for name, idx in (("cb", 1), ("cr", 2)):
            src = planes[idx].astype(np.int32)
            pts = p.scaling_points_cb if name == "cb" else p.scaling_points_cr
            if p.chroma_scaling_from_luma:
                pts = p.scaling_points_y
            if len(pts) == 0:
                out.append(src)
                continue
            lut = build_scaling_lut(pts, bit_depth)
            out.append(
                apply_grain_plane_chroma(
                    src, y, patterns, p, name, lut, bit_depth, sub_x, sub_y
                )
            )
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    return [o.astype(dtype) for o in out]
