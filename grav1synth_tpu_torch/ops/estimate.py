"""Single-input noise estimation on the PyTorch port (counterpart of
grav1synth_tpu/ops/estimate.py).

A 9x9 box blur is the pseudo-denoiser. Its residual in the flat blocks of
the blurred plane feeds the diff path's statistics: the masked lag-window
normal equations and 64-bin residual moments, per frame. Chroma planes
gain the collocated luma-residual average as one more design column.

The device half (``batch_self_stats``, ``batch_self_stats_chroma`` and
``NoiseEstimator.push_batch``) is the JAX package's jitted program as
three launches a plane, through ``ops.estimate_kernels``: the 9x9 blur
(``self_blur``, K8: the integer blur ``den`` and residual ``q = 81 f - S``,
exact where the JAX package rounds), the flat map of ``den``
(``diff_estimate.flat_blocks``, the flat-block kernel K5) and the masked
lag-window Gram and 64-bin moments (``self_stats``, K9). Chroma planes take
``lsum``, the luma ``q`` pooled over each chroma sample's collocated block
(``pool_sum``, plain PyTorch), made once a batch for Cb and Cr.

The host half, ``NoiseEstimator`` with ``highpass_np``, the lag-0
fallback and the closed-loop curve calibration, is a copy of the JAX
package's (``estimate.py:63-74``, ``:179-406``), because that module
imports JAX at load time; tests hold the copy equal to the original. It
uses the fit already copied into ``diff_estimate``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..obu.types import FilmGrainParams, GrainTableSegment
from ..tables.aggregate import packet_bounds
from ..utils import spans
from . import grain_ref
from .diff_estimate import (
    _ChunkStats,
    _curve_points,
    _download,
    _fit_params,
    _frame_sigma,
    flat_blocks,
    pool_sum,
    stage_planes,
)
from .diff_kernels import offsets
from .estimate_kernels import BLUR, self_blur, self_stats


def _plane_stats(den, q, lag: int, bit_depth: int, lsum=None, n_pool: int = 1) -> dict:
    """Per-frame statistics of one plane from its blur: the flat map of
    ``den`` (the flat-block kernel on the card), then ``self_stats``."""
    return self_stats(q, den, flat_blocks(den), lsum, n_pool, lag, bit_depth)


def batch_self_stats(y: torch.Tensor, lag: int, bit_depth: int) -> dict:
    """(B, H, W) luma -> per-frame statistics (estimate.batch_self_stats)."""
    den, q = self_blur(y, bit_depth)
    return _plane_stats(den, q, lag, bit_depth)


def _chroma_stats(c, lsum, lag: int, bit_depth: int, sub_x: int, sub_y: int) -> dict:
    den, q = self_blur(c, bit_depth)
    return _plane_stats(den, q, lag, bit_depth, lsum, (1 + sub_x) * (1 + sub_y))


def batch_self_stats_chroma(
    c: torch.Tensor, y: torch.Tensor, lag: int, bit_depth: int, sub_x: int, sub_y: int
) -> dict:
    """(B, Hc, Wc) chroma + (B, H, W) luma -> per-frame statistics
    (estimate.batch_self_stats_chroma)."""
    lsum = pool_sum(self_blur(y, bit_depth)[1], c.shape[1], c.shape[2], sub_x, sub_y)
    return _chroma_stats(c, lsum, lag, bit_depth, sub_x, sub_y)


# ---------------------------------------------------------------------------
# Host half: a copy of grav1synth_tpu/ops/estimate.py:63-74 and :179-406


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


class NoiseEstimator:
    """Streaming single-input estimator -> per-frame sigmas + a table
    (estimate.NoiseEstimator on ``device``).

    finish() fits AR coefficients (lag >= 1) and a scaling curve with
    the diff pipeline's solver; when the AR fit degenerates it falls back
    to a lag-0 sigma-curve table. Each push_batch uploads each plane as
    one pinned copy and downloads all of the batch's statistics in one
    copy. The tables are the JAX package's."""

    def __init__(
        self,
        fps: Tuple[int, int],
        bit_depth: int = 8,
        seed: int = 7391,
        lag: int = 2,
        calibrate: bool = True,
        device="cuda",
    ):
        self.fps = fps
        self.bit_depth = bit_depth
        self.seed = seed
        self.lag = lag
        self.calibrate = calibrate
        self.device = torch.device(device)
        self.per_frame_sigma: List[float] = []
        self._k = len(offsets(lag)) - 1
        self._chunk = _ChunkStats.zero(self._k)
        self._sub = (1, 1)  # last seen chroma subsampling (calibration)
        # pinned host buffers the planes are stacked into, one per plane
        self._pinned: Dict[int, torch.Tensor] = {}

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

    def push_frame(self, y) -> float:
        """Returns this frame's flat-area residual sigma (8-bit units).
        ``y`` is a luma plane, or a [y, cb, cr] plane list for a chroma-
        aware estimate."""
        self.push_batch([y])
        return self.per_frame_sigma[-1]

    def push_batch(self, frames) -> None:
        """One pass over the device for a batch of frames (luma planes,
        or [y, cb, cr] plane lists for chroma-aware estimation)."""
        if not len(frames):
            return
        planes = [
            list(f) if isinstance(f, (list, tuple)) else [f] for f in frames
        ]
        y = stage_planes(self._pinned, self.device, 0, [p[0] for p in planes])
        with spans.span("estimate.launch"):
            den_y, q_y = self_blur(y, self.bit_depth)
            dicts = [_plane_stats(den_y, q_y, self.lag, self.bit_depth)]
        has_chroma = all(
            len(p) >= 3 and p[1] is not None and p[2] is not None
            for p in planes
        )
        if has_chroma:
            h, w = y.shape[1:]
            hc, wc = np.shape(planes[0][1])
            sub_y = 1 if hc < h else 0
            sub_x = 1 if wc < w else 0
            self._sub = (sub_x, sub_y)
            with spans.span("estimate.launch"):
                lsum = pool_sum(q_y, hc, wc, sub_x, sub_y)  # once for Cb and Cr
            for k in (1, 2):
                c = stage_planes(self._pinned, self.device, k, [p[k] for p in planes])
                with spans.span("estimate.launch"):
                    dicts.append(_chroma_stats(c, lsum, self.lag, self.bit_depth, sub_x, sub_y))
        with spans.span("estimate.download"):
            host = _download(dicts)
        per = host[0]
        per_cb, per_cr = (host[1], host[2]) if has_chroma else (None, None)
        with spans.span("estimate.ingest"):
            for i in range(len(planes)):
                self._ingest(
                    {k: v[i] for k, v in per.items()},
                    None if per_cb is None else {k: v[i] for k, v in per_cb.items()},
                    None if per_cr is None else {k: v[i] for k, v in per_cr.items()},
                )

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
        est2 = NoiseEstimator(
            self.fps, bd, seed=self.seed, lag=self.lag, calibrate=False,
            device=self.device,
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
