"""The reference's data types and spec tables.

``FilmGrainParams`` and ``GrainTableSegment`` are frozen copies of
``grav1synth_tpu_torch/obu/types.py``, ``packet_bounds`` of
``grav1synth_tpu_torch/tables/aggregate.py`` and ``gaussian_sequence.json``
of ``grav1synth_tpu_torch/ops/_gaussian_raw.json``, all at commit
301318fd362891bc8f8c0520c6b680db7a8800b4. ``GAUSSIAN_SEQUENCE`` is the
2048-entry pseudo-Gaussian table of AV1 spec section 7.18.3.3.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "gaussian_sequence.json")) as _f:
    GAUSSIAN_SEQUENCE = np.asarray(json.load(_f), dtype=np.int16)

if GAUSSIAN_SEQUENCE.shape != (2048,):
    raise ValueError(f"the Gaussian sequence has {GAUSSIAN_SEQUENCE.shape} entries, not 2048")

TICKS_PER_SECOND = 10_000_000


@dataclass
class FilmGrainParams:
    """One frame's (or one table segment's) grain model.

    Field semantics follow AV1 spec 5.9.30 / 6.8.20; ``scaling_shift``
    is grain_scaling_minus_8 + 8 and ``ar_coeff_shift`` is
    ar_coeff_shift_minus_6 + 6. AR coefficients are stored centered
    (coded value - 128).
    """

    grain_seed: int = 0
    scaling_points_y: List[Tuple[int, int]] = field(default_factory=list)
    scaling_points_cb: List[Tuple[int, int]] = field(default_factory=list)
    scaling_points_cr: List[Tuple[int, int]] = field(default_factory=list)
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: List[int] = field(default_factory=list)
    ar_coeffs_cb: List[int] = field(default_factory=list)
    ar_coeffs_cr: List[int] = field(default_factory=list)
    ar_coeff_shift: int = 6
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    chroma_scaling_from_luma: bool = False
    grain_scale_shift: int = 0
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False

    def equal_ignoring_seed(self, other: "FilmGrainParams") -> bool:
        """Parameter equality with grain_seed excluded: the aggregation
        rule for extending a table segment."""
        return (
            self.scaling_points_y == other.scaling_points_y
            and self.scaling_points_cb == other.scaling_points_cb
            and self.scaling_points_cr == other.scaling_points_cr
            and self.scaling_shift == other.scaling_shift
            and self.ar_coeff_lag == other.ar_coeff_lag
            and self.ar_coeffs_y == other.ar_coeffs_y
            and self.ar_coeffs_cb == other.ar_coeffs_cb
            and self.ar_coeffs_cr == other.ar_coeffs_cr
            and self.ar_coeff_shift == other.ar_coeff_shift
            and self.cb_mult == other.cb_mult
            and self.cb_luma_mult == other.cb_luma_mult
            and self.cb_offset == other.cb_offset
            and self.cr_mult == other.cr_mult
            and self.cr_luma_mult == other.cr_luma_mult
            and self.cr_offset == other.cr_offset
            and self.chroma_scaling_from_luma == other.chroma_scaling_from_luma
            and self.grain_scale_shift == other.grain_scale_shift
            and self.overlap_flag == other.overlap_flag
            and self.clip_to_restricted_range == other.clip_to_restricted_range
        )


@dataclass
class GrainTableSegment:
    """A time range [start_time, end_time) in 1/10^7-second ticks sharing
    one set of grain parameters (the filmgrn1 'E' record)."""

    start_time: int
    end_time: int
    params: FilmGrainParams


def packet_bounds(index: int, fps_num: int, fps_den: int) -> Tuple[int, int]:
    """[start, end) ticks of frame ``index`` on the fps grid (exact integer
    ceilings of the rational products)."""
    start = 0 if index == 0 else -(-fps_den * TICKS_PER_SECOND * index // fps_num)
    end = -(-fps_den * TICKS_PER_SECOND * (index + 1) // fps_num)
    return start, end
