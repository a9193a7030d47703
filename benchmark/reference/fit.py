"""The estimators' host half, the reference for the diff and estimate
paths' tables.

Frozen copies, at commit 301318fd362891bc8f8c0520c6b680db7a8800b4, of
``grav1synth_tpu_torch/ops/diff_estimate.py`` (``_PlaneStats`` through
``_frame_sigma``; ``DiffEstimator``'s scene cut, chunking and segment
merge as ``DiffChunks``) and ``grav1synth_tpu_torch/ops/estimate.py``
(``highpass_np``; ``NoiseEstimator``'s ingest, lag-0 fallback, curve
calibration and finish as ``NoiseChunk``). Only the device half is taken
out: both classes take per-frame statistics that ``stats`` computes, and
``NoiseChunk``'s calibration pushes its synthetic frames through
``stats.self_stats_frames``. Being a copy, it holds the port's tables to
the fit as it stood at that commit: it catches a later change to the fit,
not a fault the fit already had.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import grain_ref
from .types import FilmGrainParams, GrainTableSegment, packet_bounds

NUM_BINS = 64
BLUR = 9


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


class DiffChunks:
    """``DiffEstimator``'s host logic on per-frame statistics: a chunk
    closes when it reaches ``chunk_frames`` pairs or when the per-frame
    noise strength jumps away from the chunk's running level; adjacent
    chunks whose fitted models agree merge into one segment."""

    def __init__(self, fps: Tuple[int, int], source_bit_depth: int, lag: int,
                 n_coeffs: int, chunk_frames: int = 60, seed: int = 7391,
                 min_chunk_frames: int = 8, sigma_jump: float = 0.35):
        self.fps = fps
        self.src_bd = source_bit_depth
        self.lag = lag
        self.chunk_frames = chunk_frames
        self.seed = seed
        self.min_chunk_frames = min_chunk_frames
        self.sigma_jump = sigma_jump
        self._k = n_coeffs
        self._chunk = _ChunkStats.zero(self._k)
        self._chunk_start = 0
        self._frame_idx = 0
        self._segments: List[GrainTableSegment] = []
        self._chunk_sigmas: List[float] = []

    def _scene_cut(self, sigma: float) -> bool:
        if len(self._chunk_sigmas) < self.min_chunk_frames:
            return False
        level = float(np.median(self._chunk_sigmas))
        scale8 = 1 << (self.src_bd - 8)
        return abs(sigma - level) > max(
            self.sigma_jump * level, 0.15 * scale8
        )

    def add_frame(self, y_stats, cb_stats=None, cr_stats=None, fit=None) -> None:
        """One frame's statistics (dicts of numpy arrays), in frame order.
        ``fit`` replaces ``_fit_params`` (a memo of it, for instance)."""
        sigma = _frame_sigma(y_stats)
        if self._scene_cut(sigma):
            self._flush_chunk(fit)
        self._chunk_sigmas.append(sigma)
        self._chunk.y.add(y_stats)
        if cb_stats is not None:
            self._chunk.cb.add(cb_stats)
        if cr_stats is not None:
            self._chunk.cr.add(cr_stats)
        self._chunk.frames += 1
        self._frame_idx += 1
        if self._frame_idx - self._chunk_start >= self.chunk_frames:
            self._flush_chunk(fit)

    def _flush_chunk(self, fit=None) -> None:
        if self._chunk.frames == 0:
            return
        params = (fit or _fit_params)(self._chunk, self.lag, self.src_bd, self.seed)
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

    def finish(self, fit=None) -> List[GrainTableSegment]:
        self._flush_chunk(fit)
        return self._segments


def highpass_np(pat: np.ndarray) -> float:
    """sigma of (delta - h) * pat on host — the unit_sigma measure that
    cancels the blur's attenuation out of the fitted scaling curve."""
    f = pat.astype(np.float64)
    c = np.cumsum(np.cumsum(np.pad(f, ((1, 0), (1, 0))), 0), 1)
    k = BLUR
    box = (
        c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    ) / (k * k)
    r = f[k // 2 : -(k // 2), k // 2 : -(k // 2)] - box
    return float(r.std())


class NoiseChunk:
    """``NoiseEstimator``'s host logic on per-frame statistics: one chunk
    over the whole stream, per-frame sigmas, and the fit with its lag-0
    fallback and closed-loop curve calibration. ``push_stats`` takes the
    statistics of synthetic frames (the calibration's) as ``push_batch``
    would give them: ``push_stats(frames, bit_depth, lag) -> (y, cb, cr)``
    lists of per-frame dicts, cb and cr None for luma-only frames."""

    def __init__(self, fps: Tuple[int, int], bit_depth: int, n_coeffs: int,
                 push_stats: Callable, seed: int = 7391, lag: int = 2,
                 calibrate: bool = True):
        self.fps = fps
        self.bit_depth = bit_depth
        self.seed = seed
        self.lag = lag
        self.calibrate = calibrate
        self.push_stats = push_stats
        self.per_frame_sigma: List[float] = []
        self._k = n_coeffs
        self._chunk = _ChunkStats.zero(self._k)
        self._sub = (1, 1)

    def _ingest(self, stats, cb_stats=None, cr_stats=None) -> float:
        sigma = _frame_sigma(stats) / (1 << (self.bit_depth - 8))
        self.per_frame_sigma.append(float(sigma))
        self._chunk.y.add(stats)
        if cb_stats is not None:
            self._chunk.cb.add(cb_stats)
        if cr_stats is not None:
            self._chunk.cr.add(cr_stats)
        self._chunk.frames += 1
        return float(sigma)

    def push_batch(self, frames) -> None:
        """Synthetic frames ([y, cb, cr] plane lists or luma planes) through
        ``push_stats``, then ingested in order."""
        planes = [list(f) if isinstance(f, (list, tuple)) else [f] for f in frames]
        if len(planes[0]) >= 3:
            h, w = np.shape(planes[0][0])
            hc, wc = np.shape(planes[0][1])
            self._sub = (1 if wc < w else 0, 1 if hc < h else 0)
        y, cb, cr = self.push_stats(planes, self.bit_depth, self.lag)
        for i in range(len(planes)):
            self._ingest(y[i], None if cb is None else cb[i], None if cr is None else cr[i])

    def _fallback_lag0(self) -> List[GrainTableSegment]:
        """Sigma-curve-only table from the bin moments (pre-AR-fit
        behavior, kept as the degenerate-fit escape hatch)."""
        scale8 = 1 << (self.bit_depth - 8)
        sigma, valid = self._chunk.y.sigma_bins(scale8, min_count=512.0)
        if not valid.any() or sigma[valid].max() < 0.1:
            return []
        probe = FilmGrainParams(grain_seed=self.seed, scaling_points_y=[(0, 1)])
        pat = grain_ref.generate_grain(probe, 8, True, 1, 1)
        sigma_g = highpass_np(pat.luma[3:, 3:-3])
        for shift in range(8, 12):
            if (sigma * (1 << shift) / sigma_g).max() <= 255 or shift == 11:
                break
        vals = np.clip(sigma * (1 << shift) / sigma_g, 0, 255)
        pts = _curve_points(vals, valid, 14)
        if not pts:
            return []
        params = FilmGrainParams(
            grain_seed=self.seed,
            scaling_points_y=pts,
            scaling_shift=shift,
            ar_coeff_lag=0,
            ar_coeffs_cb=[0],
            ar_coeffs_cr=[0],
            overlap_flag=True,
        )
        start, _ = packet_bounds(0, *self.fps)
        _, end = packet_bounds(self._chunk.frames - 1, *self.fps)
        return [GrainTableSegment(start, end, params)]

    def _calibrate_curves(self, params: FilmGrainParams) -> FilmGrainParams:
        """Closed-loop curve calibration: synthesize the FITTED grain onto
        a flat intensity sweep, push it through this very pipeline
        (calibrate=False, same device), and rescale each plane's curve
        points by the per-point ratio of intended to recovered sigma."""
        h, w = 160, 256
        bd = self.bit_depth
        shift = bd - 8
        sub_x, sub_y = self._sub
        xx = np.mgrid[0:h, 0:w][1]
        ramp = (xx / (w - 1) * 255).astype(np.int32) << shift
        hc, wc = h >> sub_y, w >> sub_x
        ramp_c = (
            (np.mgrid[0:hc, 0:wc][1] / (wc - 1) * 255).astype(np.int32)
            << shift
        )
        mono = not (
            params.scaling_points_cb
            or params.scaling_points_cr
            or params.chroma_scaling_from_luma
        )
        frames = []
        for i in range(6):
            p = dataclasses.replace(
                params, grain_seed=(params.grain_seed + i * 173) & 0xFFFF
            )
            planes = [ramp.copy()] + (
                [] if mono else [ramp_c.copy(), ramp_c.copy()]
            )
            frames.append(
                grain_ref.apply_grain_frame(planes, p, bd, sub_x, sub_y)
            )
        est2 = NoiseChunk(
            self.fps, bd, self._k, self.push_stats, seed=self.seed, lag=self.lag,
            calibrate=False,
        )
        est2.push_batch(
            [f if not mono else f[0] for f in frames]
        )
        segs2 = est2.finish()
        if not segs2:
            return params
        rec = segs2[0].params

        def curve(prm, plane, xs):
            pts = getattr(prm, f"scaling_points_{plane}")
            if not pts:
                return None
            pat = grain_ref.generate_grain(prm, 8, False, 1, 1)
            pp = {"y": pat.luma, "cb": pat.cb, "cr": pat.cr}[plane]
            sg = float(pp[3:, 3 : pp.shape[1] - 3].astype(np.float64).std())
            lut = grain_ref.build_scaling_lut(pts, 8)
            return np.array(
                [lut[x] * sg / (1 << prm.scaling_shift) for x in xs]
            )

        out = dataclasses.replace(params)
        for plane in ("y", "cb", "cr"):
            pts = getattr(params, f"scaling_points_{plane}")
            if not pts:
                continue
            xs = [x for x, _ in pts]
            want = curve(params, plane, xs)
            have = curve(rec, plane, xs)
            if want is None or have is None:
                continue
            # per-point gain correction, bounded: a ratio far outside
            # [0.4, 4.0] means the recovery run itself degenerated
            kappa = np.clip(
                np.where(have > 1e-3, want / np.maximum(have, 1e-3), 1.0),
                0.4, 4.0,
            )
            new_pts = [
                (x, int(np.clip(round(y * k), 0, 255)))
                for (x, y), k in zip(pts, kappa)
            ]
            setattr(out, f"scaling_points_{plane}", new_pts)
        return out

    def finish(self) -> List[GrainTableSegment]:
        if self._chunk.frames == 0:
            return []
        params = _fit_params(
            self._chunk, self.lag, self.bit_depth, self.seed,
            unit_sigma=highpass_np,
        )
        if params is None:
            return self._fallback_lag0()
        if self.calibrate:
            params = self._calibrate_curves(params)
        start, _ = packet_bounds(0, *self.fps)
        _, end = packet_bounds(self._chunk.frames - 1, *self.fps)
        return [GrainTableSegment(start, end, params)]
