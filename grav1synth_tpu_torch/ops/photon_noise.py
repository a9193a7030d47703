"""Physically-modeled photon-noise grain parameters from an ISO value.

First-party replacement for the av1-grain crate's
generate_photon_noise_params (reference grav1synth src/main.rs:288-304)
— itself a port of libaom's tools/photon_noise_table.c. This module
implements that exact algorithm so tables agree numerically with the
libaom/av1-grain model:

- A full-frame (36x24mm) sensor is assumed; the frame resolution sets
  the pixel pitch and hence the photon count per pixel.
- Focal-plane mid-tone (18% card) exposure is H = 10/ISO lux-seconds;
  with the daylight photon flux constant (11260 photons/lux-s/um^2)
  and 20% effective quantum efficiency that fixes the electron counts,
  with full-scale at mid_tone/0.18.
- Noise in electrons at each signal level: input-referred read noise,
  photon shot noise (Poisson), and photo-response non-uniformity,
  summed in quadrature.
- The electron-domain sigma maps to the encoded domain through the
  transfer function's local secant slope over [linear - 2*sigma,
  linear + 2*sigma] (not the tangent: the secant stays finite at the
  gamma curve's zero-derivative black point), for BT.1886 (gamma 2.4)
  or SMPTE 2084 PQ.
- 14 scaling points at code values spanning the pixel range, with
  scaling value round(range * 7.88 * encoded_sigma) capped at 255,
  scaling_shift fixed at 8, lag-0 grain. 7.88 is the libaom constant
  relating an encoded-domain sigma to AV1 scaling units at shift 8
  (the exact Gaussian-table value would be 4096/std(gaussian_sequence)
  = 8.007; the published tables use 7.88, and parity wins).
- Limited (MPEG) vs full (JPEG) range — the reference feeds the
  stream's color range into the model (main.rs:296-304): in limited
  range the 14 points sit at code values 16 + round(219*i/13) and the
  code-value sigma scales by 219 instead of 255.

Validated end-to-end in tests/test_photon_noise.py: golden tables per
(ISO, resolution, transfer, range) cell, plus a statistical check that
the dav1d-validated synthesis engine reproduces the modeled sigma on
flat frames.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from ..obu.types import FilmGrainParams, GrainTableSegment

# sensor / exposure model constants (libaom tools/photon_noise_table.c)
PHOTONS_PER_LUX_SECOND_PER_UM2 = 11260.0
EFFECTIVE_QUANTUM_EFFICIENCY = 0.20
PHOTO_RESPONSE_NON_UNIFORMITY = 0.005
INPUT_REFERRED_READ_NOISE = 1.5
SENSOR_AREA_UM2 = 36_000.0 * 24_000.0
MID_GRAY = 0.18

# encoded-sigma -> AV1 scaling-value factor at scaling_shift=8
SCALING_PER_SIGMA = 7.88

NUM_Y_POINTS = 14
NUM_UV_POINTS = 10
DEFAULT_SEED = 7391


# -- transfer functions -----------------------------------------------------


class Bt1886:
    """BT.1886 display EOTF (gamma 2.4), normalized to [0, 1]."""

    @staticmethod
    def to_linear(e: float) -> float:
        return math.pow(max(0.0, min(e, 1.0)), 2.4)

    @staticmethod
    def from_linear(l: float) -> float:
        return math.pow(max(0.0, min(l, 1.0)), 1.0 / 2.4)


class Smpte2084:
    """SMPTE 2084 (PQ) EOTF, normalized so 1.0 = peak (10000 nits)."""

    M1 = 2610.0 / 16384
    M2 = 128.0 * 2523.0 / 4096
    C1 = 3424.0 / 4096
    C2 = 32.0 * 2413.0 / 4096
    C3 = 32.0 * 2392.0 / 4096

    @classmethod
    def to_linear(cls, e: float) -> float:
        e = max(0.0, min(e, 1.0))
        ep = math.pow(e, 1.0 / cls.M2)
        num = max(ep - cls.C1, 0.0)
        den = cls.C2 - cls.C3 * ep
        return math.pow(num / max(den, 1e-10), 1.0 / cls.M1)

    @classmethod
    def from_linear(cls, l: float) -> float:
        l = max(0.0, min(l, 1.0))
        lm = math.pow(l, cls.M1)
        return math.pow((cls.C1 + cls.C2 * lm) / (1.0 + cls.C3 * lm), cls.M2)


def _transfer(name: str):
    return Smpte2084 if name == "smpte2084" else Bt1886


# -- the model ---------------------------------------------------------------


def _encoded_sigma(
    e: float, max_electrons: float, transfer
) -> float:
    """Noise sigma in encoded-signal units at encoded level ``e``."""
    linear = transfer.to_linear(e)
    electrons = max_electrons * linear
    noise_electrons = math.sqrt(
        INPUT_REFERRED_READ_NOISE * INPUT_REFERRED_READ_NOISE
        + electrons
        + (PHOTO_RESPONSE_NON_UNIFORMITY * electrons) ** 2
    )
    linear_noise = noise_electrons / max_electrons
    # secant slope of the OETF over +-2 sigma: finite at the black
    # point where the tangent diverges (libaom photon_noise_table.c)
    lo = max(0.0, linear - 2.0 * linear_noise)
    hi = min(1.0, linear + 2.0 * linear_noise)
    if hi <= lo:
        return 0.0
    slope = (transfer.from_linear(hi) - transfer.from_linear(lo)) / (hi - lo)
    return linear_noise * slope


def _max_electrons(iso: float, width: int, height: int) -> float:
    pixel_area_um2 = SENSOR_AREA_UM2 / (width * height)
    mid_tone_exposure_lux_s = 10.0 / iso
    mid_tone_electrons = (
        mid_tone_exposure_lux_s
        * PHOTONS_PER_LUX_SECOND_PER_UM2
        * pixel_area_um2
        * EFFECTIVE_QUANTUM_EFFICIENCY
    )
    return mid_tone_electrons / MID_GRAY


def _noise_points(
    iso: float,
    width: int,
    height: int,
    transfer,
    full_range: bool,
    n_points: int,
) -> List[Tuple[int, int]]:
    """n scaling points (code value, scaling value) of the photon-noise
    curve, in 8-bit code-value terms."""
    max_electrons = _max_electrons(iso, width, height)
    # limited (studio/MPEG) range: luma code values span [16, 235]
    cv_base, cv_span = (0.0, 255.0) if full_range else (16.0, 219.0)
    points = []
    for i in range(n_points):
        e = i / (n_points - 1.0)
        sigma = _encoded_sigma(e, max_electrons, transfer)
        x = int(round(cv_base + cv_span * e))
        v = int(min(255.0, round(cv_span * SCALING_PER_SIGMA * sigma)))
        points.append((x, v))
    return points


def generate_photon_noise_params(
    iso: float,
    width: int,
    height: int,
    transfer_function: str = "bt1886",  # or "smpte2084"
    chroma: bool = False,
    full_range: bool = False,
    seed: int = DEFAULT_SEED,
) -> FilmGrainParams:
    """Build lag-0 grain parameters whose scaling curve models photon
    noise at the given ISO for this resolution (the libaom
    photon_noise_table.c / av1-grain NoiseGenArgs model; reference call
    site src/main.rs:288-304 including the full_range input)."""
    transfer = _transfer(transfer_function)
    pts_y = _noise_points(iso, width, height, transfer, full_range, NUM_Y_POINTS)

    p = FilmGrainParams(
        grain_seed=seed & 0xFFFF,
        scaling_points_y=pts_y,
        scaling_shift=8,
        ar_coeff_lag=0,
        ar_coeffs_y=[],
        ar_coeffs_cb=[0],
        ar_coeffs_cr=[0],
        ar_coeff_shift=6,
        grain_scale_shift=0,
        overlap_flag=True,
        clip_to_restricted_range=False,
    )
    if chroma:
        # chroma planes carry the same physical model, evaluated at the
        # syntax's 10-point budget; neutral mults (luma_mult=128 ->
        # luma term zero, mult=192 -> unit source gain, offset=256 ->
        # zero bias) make each chroma plane's own intensity drive the
        # lookup
        pts_uv = _noise_points(
            iso, width, height, transfer, full_range, NUM_UV_POINTS
        )
        p.scaling_points_cb = list(pts_uv)
        p.scaling_points_cr = list(pts_uv)
        p.cb_mult = 192
        p.cb_luma_mult = 128
        p.cb_offset = 256
        p.cr_mult = 192
        p.cr_luma_mult = 128
        p.cr_offset = 256
    return p


def photon_noise_segment(
    iso: float,
    width: int,
    height: int,
    transfer_function: str = "bt1886",
    chroma: bool = False,
    full_range: bool = False,
    seed: int = DEFAULT_SEED,
) -> GrainTableSegment:
    """Whole-file segment (the generate pipeline's contract: one segment
    spanning [0, u64::MAX), reference main.rs:288-306)."""
    params = generate_photon_noise_params(
        iso, width, height, transfer_function, chroma, full_range, seed
    )
    return GrainTableSegment(0, 2**63 - 1, params)


def modeled_sigma_8bit(
    iso: float,
    width: int,
    height: int,
    code_value: float,
    transfer_function: str = "bt1886",
    full_range: bool = False,
) -> float:
    """Physical-model noise sigma (8-bit code-value units) at a pixel
    code value — the quantity the scaling curve encodes; used by the
    end-to-end statistical validation."""
    transfer = _transfer(transfer_function)
    cv_base, cv_span = (0.0, 255.0) if full_range else (16.0, 219.0)
    e = min(1.0, max(0.0, (code_value - cv_base) / cv_span))
    return cv_span * _encoded_sigma(e, _max_electrons(iso, width, height), transfer)
