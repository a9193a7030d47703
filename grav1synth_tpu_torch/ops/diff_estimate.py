"""Grain-table estimation from a grainy/denoised frame-pair stream on the
PyTorch port (counterpart of grav1synth_tpu/ops/diff_estimate.py).

The device half reduces each frame pair to per-frame statistics through
the two kernels of ``ops.diff_kernels``: the flat-block map of the
denoised plane (``flat_blocks``), then the masked lag-window Gram and
64-bin residual moments of every plane (``plane_stats``); chroma planes
get the collocated x4 luma-residual column (``chroma_lavg4``). The host
half, the per-chunk model fit, is numpy. It is a copy of the JAX
package's (``_PlaneStats`` through ``_frame_sigma``), because that module
imports JAX at load time; tests hold the copy equal to the original.
``DiffEstimator`` feeds batches through the device half with one upload
per plane and one download of all of a batch's statistics, and chunks
frames into grain-table segments exactly as the JAX package's does.
``mesh_pair_stats_per_frame``, ``sharded_diff_stats`` and
``DiffEstimator.diff_batch(mesh=...)`` shard the frames over a
``parallel.DeviceMesh``; the first two also over the processes of a
``parallel.distributed.ProcessMesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obu.types import FilmGrainParams, GrainTableSegment
from ..parallel.distributed import (
    ProcessMesh, all_sum, gather_frames, global_batch, split_mesh,
)
from ..parallel.mesh import shard_slices
from ..tables.aggregate import packet_bounds
from ..utils import spans
from . import grain_ref
from .diff_kernels import FLAT_BLOCK, NUM_BINS, flat_block_activity, offsets, plane_stats


def flat_blocks(d: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int16 denoised plane -> (B, H//16, W//16) uint8 flat-block
    map (1 = flat): block mean activity below 1.5 x the frame's median
    block activity + 1e-3, in float32 as diff_estimate._flat_blocks_batch
    computes it. The median is interpolated by hand as jnp.percentile
    does (low * (1 - w) + high * w); every value is exact in float32."""
    act = flat_block_activity(d).to(torch.float32) / (FLAT_BLOCK * FLAT_BLOCK)
    b, hb, wb = act.shape
    if act.numel() == 0:
        return torch.zeros((b, hb, wb), dtype=torch.uint8, device=d.device)
    n = hb * wb
    srt = act.reshape(b, n).sort(dim=1).values
    lo = (n - 1) // 2
    hw = 0.5 * (n - 1) - lo  # 0 or 0.5
    med = srt[:, lo] * (1.0 - hw) + srt[:, min(lo + 1, n - 1)] * hw
    thresh = (med * 1.5 + 1e-3)[:, None, None]
    return (act < thresh).to(torch.uint8)


def pool_sum(p: torch.Tensor, hc: int, wc: int, sub_x: int, sub_y: int) -> torch.Tensor:
    """(B, H, W) luma -> (B, hc, wc) int32 sums over each chroma sample's
    collocated 2x2, 2x1 or 1x1 luma block, the last row and column
    repeated where the chroma plane reaches past the luma plane (as
    jnp.pad mode="edge" does)."""
    b, h, w = p.shape
    need_h, need_w = hc << sub_y, wc << sub_x
    p = p[:, :need_h, :need_w]
    if need_h > h:
        p = torch.cat([p, p[:, -1:].expand(b, need_h - h, p.shape[2])], 1)
    if need_w > w:
        p = torch.cat([p, p[:, :, -1:].expand(b, need_h, need_w - w)], 2)
    return p.reshape(b, hc, 1 << sub_y, wc, 1 << sub_x).sum((2, 4), dtype=torch.int32)


def chroma_lavg4(
    s: torch.Tensor, d: torch.Tensor, hc: int, wc: int, sub_x: int, sub_y: int
) -> torch.Tensor:
    """x4-scaled collocated luma-residual average, int16, for the stats
    kernel's aux column: edge-padded 2x2, 2x1 or 1x1 sums of s and of d,
    their difference, shifted left by 2 - sub_x - sub_y
    (diff_estimate._chroma_lavg4)."""
    pooled = pool_sum(s, hc, wc, sub_x, sub_y) - pool_sum(d, hc, wc, sub_x, sub_y)
    return (pooled << (2 - (sub_x + sub_y))).to(torch.int16)


def pair_plane_stats(s, d, aux4, lag: int, bit_depth: int) -> dict:
    """Statistics of one plane of a frame-pair batch: flat blocks of d,
    then the stats kernel. uint8 inputs widen to int16 on the device."""
    s16, d16 = s.to(torch.int16), d.to(torch.int16)
    return plane_stats(s16, d16, flat_blocks(d16), aux4, lag, bit_depth)


def batch_pair_stats_per_frame(
    sy, dy, sc, dc, sr, dr,
    lag: int, bit_depth: int, sub_x: int, sub_y: int, has_chroma: bool,
):
    """A (B, H, W) frame-pair batch on one device -> PER-FRAME statistics
    of luma and, with ``has_chroma``, both chroma planes: (y, cb|None,
    cr|None), each a dict of float64 tensors with a leading batch dim
    (the contract of diff_estimate.batch_pair_stats_per_frame). Inputs
    may be uint8 or int16."""
    y = pair_plane_stats(sy, dy, None, lag, bit_depth)
    if not has_chroma:
        return y, None, None
    hc, wc = sc.shape[1:]
    lavg4 = chroma_lavg4(sy, dy, hc, wc, sub_x, sub_y)
    return (
        y,
        pair_plane_stats(sc, dc, lavg4, lag, bit_depth),
        pair_plane_stats(sr, dr, lavg4, lag, bit_depth),
    )


# ---------------------------------------------------------------------------
# Frame sharding over a device mesh


def _wire(a) -> torch.Tensor:
    """A plane batch as a tensor; uint16 samples reinterpreted as int16
    (value-preserving for every AV1 depth)."""
    if isinstance(a, np.ndarray) and a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.as_tensor(a)


def _shard_stats(shards, lag: int, bit_depth: int, sub_x: int, sub_y: int, has_chroma: bool):
    """Per-frame statistics of each shard on its own device: ``shards``
    holds each shard's [sy, dy(, sc, dc, sr, dr)] on that device."""
    return [
        batch_pair_stats_per_frame(
            *planes, *[None] * (6 - len(planes)), lag=lag, bit_depth=bit_depth,
            sub_x=sub_x, sub_y=sub_y, has_chroma=has_chroma,
        )
        for planes in shards
    ]


def _concat_on(home: torch.device, outs):
    """Per-shard (y, cb, cr) statistics, concatenated along frames on
    ``home``."""
    return tuple(
        None if outs[0][k] is None
        else {key: torch.cat([o[k][key].to(home) for o in outs]) for key in outs[0][k]}
        for k in range(3)
    )


def _split(mesh: Sequence[torch.device], planes) -> list:
    """Each shard's slices of full-batch planes, on its device."""
    planes = [_wire(a) for a in planes]
    return [
        [a[sl].to(dev, non_blocking=True) for a in planes]
        for dev, sl in zip(mesh, shard_slices(planes[0].shape[0], len(mesh)))
    ]


def mesh_pair_stats_per_frame(
    mesh, sy, dy, sc, dc, sr, dr, lag: int, bit_depth: int, sub_x: int, sub_y: int,
    has_chroma: bool,
):
    """``batch_pair_stats_per_frame`` with the frames sharded over a device
    mesh (diff_estimate.mesh_pair_stats_per_frame): each device reduces its
    shard, and the per-frame statistics are concatenated on ``mesh[0]``.
    The batch must divide evenly over the mesh. With a ``ProcessMesh`` the
    planes are this rank's frames, and every rank gets the whole batch's
    per-frame statistics in frame order, on its first local device (what
    ``process_allgather`` of the JAX function's outputs gives)."""
    devices, pm = split_mesh(mesh)
    planes = [sy, dy] + ([sc, dc, sr, dr] if has_chroma else [])
    outs = _shard_stats(_split(devices, planes), lag, bit_depth, sub_x, sub_y, has_chroma)
    stats = _concat_on(devices[0], outs)
    if pm is None:
        return stats
    dicts = [d for d in stats if d is not None]
    keys = [(i, key) for i, d in enumerate(dicts) for key in d]
    full = gather_frames([dicts[i][key] for i, key in keys])
    for (i, key), t in zip(keys, full):
        dicts[i][key] = t.to(devices[0])
    return stats


def sharded_diff_stats(mesh, src_planes, den_planes, lag: int, bit_depth: int):
    """Frame-parallel diff reduction (diff_estimate.sharded_diff_stats):
    each device sums its shard's statistics, and the per-shard sums are
    added on the host in float64. Every sum is exact (integer products, the
    chroma aux column in quarters), so the result equals the unsharded
    one. Returns (y, cb|None, cr|None) dicts of numpy float64 arrays. With
    a ``ProcessMesh`` the planes are this rank's frames, and the sums are
    every rank's, the same on every rank."""
    devices, pm = split_mesh(mesh)
    has_chroma = len(src_planes) >= 3 and len(den_planes) >= 3
    sub_x = sub_y = 0
    if has_chroma:
        (h, w), (hc, wc) = np.shape(src_planes[0])[1:], np.shape(src_planes[1])[1:]
        sub_y, sub_x = int(hc < h), int(wc < w)
    planes = [src_planes[0], den_planes[0]]
    if has_chroma:
        planes += [src_planes[1], den_planes[1], src_planes[2], den_planes[2]]
    outs = _shard_stats(_split(devices, planes), lag, bit_depth, sub_x, sub_y, has_chroma)
    sums = tuple(
        None if outs[0][k] is None
        else {
            key: np.asarray(sum(o[k][key].sum(0).cpu().numpy() for o in outs))
            for key in outs[0][k]
        }
        for k in range(3)
    )
    if pm is None:
        return sums
    global_batch(np.shape(src_planes[0])[0])
    keys = [(d, key) for d in sums if d is not None for key in d]
    flat = all_sum(torch.from_numpy(np.concatenate([d[key].ravel() for d, key in keys])))
    for (d, key), part in zip(keys, torch.split(flat, [d[key].size for d, key in keys])):
        d[key] = part.numpy().reshape(d[key].shape)
    return sums


# ---------------------------------------------------------------------------
# Host half: a copy of grav1synth_tpu/ops/diff_estimate.py:261-482


@dataclass
class _PlaneStats:
    ata: np.ndarray
    atb: np.ndarray
    n_ar: float = 0.0
    bin_cnt: np.ndarray = None
    bin_sum: np.ndarray = None
    bin_sumsq: np.ndarray = None

    @classmethod
    def zero(cls, k):
        return cls(
            ata=np.zeros((k, k)),
            atb=np.zeros(k),
            bin_cnt=np.zeros(NUM_BINS),
            bin_sum=np.zeros(NUM_BINS),
            bin_sumsq=np.zeros(NUM_BINS),
        )

    def add(self, stats) -> None:
        self.ata += np.asarray(stats["ata"], np.float64)
        self.atb += np.asarray(stats["atb"], np.float64)
        self.n_ar += float(stats["n_ar"])
        self.bin_cnt += np.asarray(stats["bin_cnt"], np.float64)
        self.bin_sum += np.asarray(stats["bin_sum"], np.float64)
        self.bin_sumsq += np.asarray(stats["bin_sumsq"], np.float64)

    def sigma_bins(self, scale8: float, min_count: float = 256.0):
        """Per-bin residual sigma in 8-bit units + validity mask."""
        valid = self.bin_cnt > min_count
        mean = np.where(valid, self.bin_sum / np.maximum(self.bin_cnt, 1), 0)
        var = np.where(
            valid,
            self.bin_sumsq / np.maximum(self.bin_cnt, 1) - mean**2,
            0,
        )
        return np.sqrt(np.maximum(var, 0)) / scale8, valid


@dataclass
class _ChunkStats:
    y: _PlaneStats
    cb: _PlaneStats
    cr: _PlaneStats
    frames: int = 0

    @classmethod
    def zero(cls, k):
        # chroma design gains the collocated-luma column
        return cls(
            y=_PlaneStats.zero(k),
            cb=_PlaneStats.zero(k + 1),
            cr=_PlaneStats.zero(k + 1),
        )


def _solve_coeffs(ps: _PlaneStats, shift: int) -> Optional[np.ndarray]:
    k = ps.ata.shape[0]
    ridge = np.eye(k) * (np.trace(ps.ata) / max(k, 1)) * 1e-6
    try:
        coeffs = np.linalg.solve(ps.ata + ridge, ps.atb)
    except np.linalg.LinAlgError:
        return None
    return np.clip(np.round(coeffs * (1 << shift)), -128, 127).astype(int)


def _curve_points(
    vals: np.ndarray, valid: np.ndarray, max_points: int
) -> List[Tuple[int, int]]:
    occ = np.nonzero(valid)[0]
    take = occ if len(occ) <= max_points else occ[
        np.round(np.linspace(0, len(occ) - 1, max_points)).astype(int)
    ]
    pts = []
    for b in take:
        x = int(min(255, round((b + 0.5) * 256 / NUM_BINS)))
        if pts and x <= pts[-1][0]:
            continue
        pts.append((x, int(round(vals[b]))))
    return pts


def _fit_params(
    stats: _ChunkStats, lag: int, bit_depth: int, seed: int,
    unit_sigma=None,
) -> Optional[FilmGrainParams]:
    """Solve the chunk's model: luma + chroma AR coefficients and
    per-plane scaling curves (joint scaling_shift, as the syntax shares
    one field across planes).

    ``unit_sigma``: optional (pattern_2d) -> float measuring the unit
    pattern's sigma. The single-input estimator passes the same
    high-pass its residuals went through, so the filter's attenuation
    of THIS grain's spectral character cancels exactly out of the
    scaling curve; diff leaves it None (plain std)."""
    if stats.frames == 0 or stats.y.n_ar < 1000:
        return None
    if unit_sigma is None:
        unit_sigma = lambda pat: float(pat.astype(np.float64).std())
    shift = 6  # ar_coeff_shift
    coded_y = _solve_coeffs(stats.y, shift)
    if coded_y is None:
        return None

    scale8 = 1 << (bit_depth - 8)
    sigma_y, valid_y = stats.y.sigma_bins(scale8)
    if not valid_y.any() or sigma_y[valid_y].max() < 0.05:
        return None

    # chroma fits are optional: enough flat pixels and non-trivial noise
    def chroma_fit(ps: _PlaneStats):
        if ps.n_ar < 1000:
            return None, None, None
        coded = _solve_coeffs(ps, shift)
        if coded is None:
            return None, None, None
        sigma, valid = ps.sigma_bins(scale8, min_count=64.0)
        if not valid.any() or sigma[valid].max() < 0.05:
            return None, None, None
        return coded, sigma, valid

    coded_cb, sigma_cb, valid_cb = chroma_fit(stats.cb)
    coded_cr, sigma_cr, valid_cr = chroma_fit(stats.cr)

    # measure each fitted unit pattern's sigma (chroma patterns include
    # the cross-plane luma term, so generate all planes together)
    probe = FilmGrainParams(
        grain_seed=seed,
        scaling_points_y=[(0, 1)],
        scaling_points_cb=[(0, 1)] if coded_cb is not None else [],
        scaling_points_cr=[(0, 1)] if coded_cr is not None else [],
        ar_coeff_lag=lag,
        ar_coeffs_y=[int(c) for c in coded_y],
        ar_coeffs_cb=[int(c) for c in coded_cb] if coded_cb is not None else [],
        ar_coeffs_cr=[int(c) for c in coded_cr] if coded_cr is not None else [],
        ar_coeff_shift=shift,
        scaling_shift=8,
    )
    pat = grain_ref.generate_grain(probe, 8, False, 1, 1)
    sigma_g = unit_sigma(pat.luma[3:, 3:-3])
    if sigma_g < 1e-3:
        return None
    sigma_g_cb = (
        unit_sigma(pat.cb[3:, 3:-3]) if coded_cb is not None else 0.0
    )
    sigma_g_cr = (
        unit_sigma(pat.cr[3:, 3:-3]) if coded_cr is not None else 0.0
    )

    # joint scaling_shift: every plane's curve must fit in 8 bits
    def plane_vals(sigma, valid, sg, ss):
        if sigma is None or sg < 1e-3:
            return None
        return np.where(valid, sigma * (1 << ss) / sg, 0)

    scaling_shift = 8
    while scaling_shift < 11:
        peaks = [np.nanmax(plane_vals(sigma_y, valid_y, sigma_g, scaling_shift))]
        for sigma, valid, sg in (
            (sigma_cb, valid_cb, sigma_g_cb),
            (sigma_cr, valid_cr, sigma_g_cr),
        ):
            v = plane_vals(sigma, valid, sg, scaling_shift)
            if v is not None:
                peaks.append(np.nanmax(v))
        if max(peaks) <= 255:
            break
        scaling_shift += 1

    pts_y = _curve_points(
        np.clip(sigma_y * (1 << scaling_shift) / sigma_g, 0, 255), valid_y, 14
    )
    if not pts_y:
        return None

    def chroma_points(sigma, valid, sg):
        if sigma is None or sg < 1e-3:
            return []
        vals = np.clip(sigma * (1 << scaling_shift) / sg, 0, 255)
        pts = _curve_points(vals, valid, 10)
        return pts if any(y > 0 for _, y in pts) else []

    pts_cb = chroma_points(sigma_cb, valid_cb, sigma_g_cb)
    pts_cr = chroma_points(sigma_cr, valid_cr, sigma_g_cr)

    k = coded_y.shape[0]
    return FilmGrainParams(
        grain_seed=seed,
        scaling_points_y=pts_y,
        scaling_points_cb=pts_cb,
        scaling_points_cr=pts_cr,
        scaling_shift=scaling_shift,
        ar_coeff_lag=lag,
        ar_coeffs_y=[int(c) for c in coded_y],
        ar_coeffs_cb=(
            [int(c) for c in coded_cb] if pts_cb else [0] * (k + 1)
        ),
        ar_coeffs_cr=(
            [int(c) for c in coded_cr] if pts_cr else [0] * (k + 1)
        ),
        ar_coeff_shift=shift,
        grain_scale_shift=0,
        # identity linearization of the chroma scaling input:
        # (avg_luma*(128-128) + chroma*(192-128)) >> 6 + (256-256) == chroma
        cb_mult=192, cb_luma_mult=128, cb_offset=256,
        cr_mult=192, cr_luma_mult=128, cr_offset=256,
        overlap_flag=True,
        clip_to_restricted_range=False,
    )


def _frame_sigma(stats) -> float:
    """Whole-frame flat-area residual sigma (8-bit-depth units of the
    source) from one frame's bin moments — the per-frame noise-strength
    signal driving scene-adaptive segmentation."""
    cnt = float(np.sum(np.asarray(stats["bin_cnt"], np.float64)))
    if cnt < 1:
        return 0.0
    s = float(np.sum(np.asarray(stats["bin_sum"], np.float64)))
    ss = float(np.sum(np.asarray(stats["bin_sumsq"], np.float64)))
    mean = s / cnt
    return float(np.sqrt(max(ss / cnt - mean * mean, 0.0)))


# ---------------------------------------------------------------------------
# The estimator


def _download(dicts: List[dict]) -> List[dict]:
    """All of a batch's per-frame statistics to the host in ONE copy:
    concatenated per frame on the device, split on the host into numpy
    arrays of the original shapes."""
    keys = [sorted(d) for d in dicts]
    bsz = next(iter(dicts[0].values())).shape[0]
    flat = torch.cat(
        [d[k].reshape(bsz, -1).to(torch.float64) for d, ks in zip(dicts, keys) for k in ks],
        dim=1,
    )
    host = flat.cpu().numpy()
    out, pos = [], 0
    for d, ks in zip(dicts, keys):
        unpacked = {}
        for k in ks:
            shape = tuple(d[k].shape[1:])
            n = int(np.prod(shape, dtype=np.int64))
            unpacked[k] = host[:, pos : pos + n].reshape((bsz,) + shape)
            pos += n
        out.append(unpacked)
    return out


def stage_planes(
    pinned: Dict[Hashable, torch.Tensor], device: torch.device, slot: Hashable, planes,
    nshift: int = 0,
) -> torch.Tensor:
    """Stack one plane of each frame and start its upload: one copy.

    Samples travel as int16 (every AV1 depth fits; uint16 decoder output
    is reinterpreted, which is value-preserving up to 12 bits) or, when
    8-bit and unshifted, as uint8; ``nshift`` shifts them left (or right
    when negative) in int16. On a CUDA device the planes are stacked
    straight into a pinned buffer kept in ``pinned`` per slot: the
    estimators end every batch in a download that waits for the stream,
    so the previous upload from a buffer has finished before the buffer
    is written again. The whole of it is the span ``stage.planes``."""
    with spans.span("stage.planes"):
        first = np.asarray(planes[0])
        shape = (len(planes),) + first.shape
        dtype = torch.uint8 if first.dtype == np.uint8 and nshift == 0 else torch.int16
        if device.type == "cuda":
            buf = pinned.get(slot)
            if buf is None or buf.dtype != dtype or tuple(buf.shape[1:]) != shape[1:] \
                    or buf.shape[0] < shape[0]:
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
                pinned[slot] = buf
            buf = buf[: shape[0]]
        else:
            buf = torch.empty(shape, dtype=dtype)
        # torch's copy_ spreads a large copy (and a cast) over the host's
        # cores, where numpy's stack runs on one
        for i, a in enumerate(planes):
            a = np.asarray(a)
            buf[i].copy_(torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a))
        if nshift > 0:
            buf.bitwise_left_shift_(nshift)
        elif nshift < 0:
            buf.bitwise_right_shift_(-nshift)
        if device.type == "cuda":
            return buf.to(device, non_blocking=True)
        return buf


class DiffEstimator:
    """Streaming source/denoised comparator producing a grain table
    (diff_estimate.DiffEstimator on ``device``).

    Mixed bit depths are normalised to the source's; a chunk closes when
    it reaches ``chunk_frames`` pairs or when the per-frame noise
    strength jumps away from the chunk's running level; adjacent chunks
    whose fitted models agree are merged back into one segment. The
    tables are the JAX package's."""

    def __init__(
        self,
        fps: Tuple[int, int],
        source_bit_depth: int = 8,
        denoised_bit_depth: int = 8,
        lag: int = 2,
        chunk_frames: int = 60,
        seed: int = 7391,
        min_chunk_frames: int = 8,
        sigma_jump: float = 0.35,
        device="cuda",
    ):
        self.fps = fps
        self.src_bd = source_bit_depth
        self.den_bd = denoised_bit_depth
        self.lag = lag
        self.chunk_frames = chunk_frames
        self.seed = seed
        self.min_chunk_frames = min_chunk_frames
        self.sigma_jump = sigma_jump
        self.device = torch.device(device)
        # pinned host buffers the planes are stacked into, one per plane
        # slot (and shard), reused from batch to batch (see _stage)
        self._pinned: Dict[Hashable, torch.Tensor] = {}
        self._k = len(offsets(lag)) - 1
        self._chunk = _ChunkStats.zero(self._k)
        self._chunk_start = 0
        self._frame_idx = 0
        self._segments: List[GrainTableSegment] = []
        self._chunk_sigmas: List[float] = []

    def _scene_cut(self, sigma: float) -> bool:
        """True when this frame's noise level departs from the chunk's
        running median by more than ``sigma_jump`` (relative) — only
        once the chunk is long enough to have a trustworthy level."""
        if len(self._chunk_sigmas) < self.min_chunk_frames:
            return False
        level = float(np.median(self._chunk_sigmas))
        scale8 = 1 << (self.src_bd - 8)
        return abs(sigma - level) > max(
            self.sigma_jump * level, 0.15 * scale8
        )

    def _stage(self, slot: Hashable, planes, denoised: bool, device=None) -> torch.Tensor:
        """Stack and upload ``planes`` to ``device`` (default: the
        estimator's) through the pinned buffer kept for ``slot``. Denoised
        planes are brought to the source's bit depth here."""
        device = self.device if device is None else device
        nshift = self.src_bd - self.den_bd if denoised else 0
        return stage_planes(self._pinned, device, slot, planes, nshift)

    def _add_frames(self, y_st, cb_st=None, cr_st=None) -> None:
        """Run per-frame host statistics through scene-cut detection and
        chunking, in frame order."""
        with spans.span("diff.chunk"):
            for i in range(next(iter(y_st.values())).shape[0]):
                stats = {k: v[i] for k, v in y_st.items()}
                sigma = _frame_sigma(stats)
                if self._scene_cut(sigma):
                    self._flush_chunk()
                self._chunk_sigmas.append(sigma)
                self._chunk.y.add(stats)
                if cb_st is not None:
                    self._chunk.cb.add({k: v[i] for k, v in cb_st.items()})
                if cr_st is not None:
                    self._chunk.cr.add({k: v[i] for k, v in cr_st.items()})
                self._chunk.frames += 1
                self._frame_idx += 1
                if self._frame_idx - self._chunk_start >= self.chunk_frames:
                    self._flush_chunk()

    def diff_frame(self, src_planes, den_planes) -> None:
        """One frame pair, as a batch of one through the same kernels. A
        chroma plane whose geometry differs between source and denoised
        is skipped (its statistics stay out of the chunk)."""
        h, w = np.shape(src_planes[0])
        if np.shape(den_planes[0]) != (h, w):
            raise ValueError(
                f"source/denoised dimensions differ: {(h, w)} vs {np.shape(den_planes[0])}"
            )
        ty = self._stage(0, src_planes[:1], False)
        tdy = self._stage(1, den_planes[:1], True)
        with spans.span("diff.launch"):
            dicts = [pair_plane_stats(ty, tdy, None, self.lag, self.src_bd)]
        planes = []
        if len(src_planes) >= 3 and len(den_planes) >= 3:
            hc, wc = np.shape(src_planes[1])
            sub_y = 1 if hc < h else 0
            sub_x = 1 if wc < w else 0
            lavg4 = None
            for idx in (1, 2):
                if np.shape(den_planes[idx]) != np.shape(src_planes[idx]):
                    planes.append(False)
                    continue
                if lavg4 is None:
                    with spans.span("diff.launch"):
                        lavg4 = chroma_lavg4(ty, tdy, hc, wc, sub_x, sub_y)
                tc = self._stage(2 * idx, src_planes[idx : idx + 1], False)
                tdc = self._stage(2 * idx + 1, den_planes[idx : idx + 1], True)
                with spans.span("diff.launch"):
                    dicts.append(pair_plane_stats(tc, tdc, lavg4, self.lag, self.src_bd))
                planes.append(True)
        with spans.span("diff.download"):
            host = iter(_download(dicts))
        y_st = next(host)
        cb_st = next(host) if planes and planes[0] else None
        cr_st = next(host) if len(planes) > 1 and planes[1] else None
        self._add_frames(y_st, cb_st, cr_st)

    def diff_batch(self, src_frames, den_frames, mesh=None) -> None:
        """Feed a batch of frame pairs through one pass of the kernels.

        ``src_frames``/``den_frames`` are sequences of per-frame plane
        lists with uniform geometry. Each plane goes up as one pinned
        int16 (or uint8) copy, all per-frame statistics come back in one
        copy, and then run through the same scene-cut/chunking logic as
        diff_frame, so the tables do not depend on the batch size.

        ``mesh`` (a ``parallel.DeviceMesh``) shards the frames over its
        devices: the batch is padded to a multiple of the mesh size with
        copies of its last pair, each shard is staged and uploaded to its
        own device, the per-frame statistics come together on ``mesh[0]``,
        and only the first ``len(src_frames)`` frames are used. The tables
        equal the unsharded ones."""
        if not src_frames:
            return
        f0s, f0d = src_frames[0], den_frames[0]
        if np.shape(f0d[0]) != np.shape(f0s[0]):
            raise ValueError(
                f"source/denoised dimensions differ: {np.shape(f0s[0])} vs {np.shape(f0d[0])}"
            )
        has_chroma = len(f0s) >= 3 and len(f0d) >= 3
        sub_x = sub_y = 0
        if has_chroma:
            if np.shape(f0d[1]) != np.shape(f0s[1]) or np.shape(f0d[2]) != np.shape(f0s[2]):
                # chroma geometry mismatch: the streaming path skips only
                # the mismatched plane per frame; route through it so
                # batched and streaming tables stay identical
                for sf, df in zip(src_frames, den_frames):
                    self.diff_frame(sf, df)
                return
            (h, w), (hc, wc) = np.shape(f0s[0]), np.shape(f0s[1])
            sub_y = 1 if hc < h else 0
            sub_x = 1 if wc < w else 0
        b = len(src_frames)
        if isinstance(mesh, ProcessMesh):
            raise TypeError("diff_batch is single-process: pass a DeviceMesh")
        mesh = (self.device,) if mesh is None else mesh
        pad = (-b) % len(mesh)
        src_frames = list(src_frames) + [src_frames[-1]] * pad
        den_frames = list(den_frames) + [den_frames[-1]] * pad
        # one staging buffer per shard and plane: a mesh may name a device
        # twice, and each shard's upload must keep its own source
        shards = [
            [
                self._stage(
                    (i, 2 * k + j), [f[k] for f in (den_frames if j else src_frames)[sl]],
                    j == 1, device=dev,
                )
                for k in range(3 if has_chroma else 1)
                for j in (0, 1)
            ]
            for i, (dev, sl) in enumerate(zip(mesh, shard_slices(b + pad, len(mesh))))
        ]
        with spans.span("diff.launch"):
            outs = _shard_stats(shards, self.lag, self.src_bd, sub_x, sub_y, has_chroma)
            y_st, cb_st, cr_st = _concat_on(mesh[0], outs)
        with spans.span("diff.download"):
            host = _download([y_st] + ([cb_st, cr_st] if has_chroma else []))
        self._add_frames(*({k: v[:b] for k, v in d.items()} for d in host))

    def add_stats(
        self, y_stats, cb_stats=None, cr_stats=None, frames: int = 1
    ) -> None:
        """Ingest pre-reduced statistics covering ``frames`` frame pairs:
        the batch joins the current chunk as one block (no per-frame
        scene-cut detection)."""
        self._chunk.y.add(y_stats)
        if cb_stats is not None:
            self._chunk.cb.add(cb_stats)
        if cr_stats is not None:
            self._chunk.cr.add(cr_stats)
        self._chunk.frames += frames
        self._frame_idx += frames
        if self._frame_idx - self._chunk_start >= self.chunk_frames:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if self._chunk.frames == 0:
            return
        with spans.span("diff.fit"):
            params = _fit_params(self._chunk, self.lag, self.src_bd, self.seed)
        start, _ = packet_bounds(self._chunk_start, *self.fps)
        _, end = packet_bounds(self._frame_idx - 1, *self.fps)
        if params is not None:
            merged = False
            if self._segments and self._segments[-1].end_time == start:
                if self._segments[-1].params.equal_ignoring_seed(params):
                    self._segments[-1].end_time = end
                    merged = True
            if not merged:
                self._segments.append(GrainTableSegment(start, end, params))
        self._chunk = _ChunkStats.zero(self._k)
        self._chunk_start = self._frame_idx
        self._chunk_sigmas = []

    def finish(self) -> List[GrainTableSegment]:
        self._flush_chunk()
        return self._segments
