"""Typed models for the AV1 syntax elements the framework operates on.

Capability parity with the reference's data types (grav1synth
src/parser/grain.rs:12-81, sequence.rs:22-157, frame.rs:65-73,
obu.rs:271-309), re-designed as plain dataclasses. Grain parameters are
held in numpy-friendly lists so the device layer can batch them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# AV1 spec constants (section 6.8.20 film grain params semantics)
MAX_Y_POINTS = 14
MAX_UV_POINTS = 10
MAX_Y_COEFFS = 24  # 2 * 3 * (3 + 1)
MAX_UV_COEFFS = 25  # luma count + 1
# Seed increment applied per frame when applying a segment's parameters so
# consecutive frames decorrelate (aomenc convention; see reference
# frame.rs:625-629 and av1-grain DEFAULT_GRAIN_SEED).
DEFAULT_GRAIN_SEED = 10063


class ObuType(enum.IntEnum):
    SEQUENCE_HEADER = 1
    TEMPORAL_DELIMITER = 2
    FRAME_HEADER = 3
    TILE_GROUP = 4
    METADATA = 5
    FRAME = 6
    REDUNDANT_FRAME_HEADER = 7
    TILE_LIST = 8
    PADDING = 15
    # reserved values parse to plain ints via _missing_
    RESERVED = -1

    @classmethod
    def _missing_(cls, value):  # reserved obu types pass through unparsed
        obj = int.__new__(cls, value)
        obj._name_ = f"RESERVED_{value}"
        obj._value_ = value
        return obj


class FrameType(enum.IntEnum):
    KEY = 0
    INTER = 1
    INTRA_ONLY = 2
    SWITCH = 3

    @property
    def is_intra(self) -> bool:
        return self in (FrameType.KEY, FrameType.INTRA_ONLY)


class GrainAction(enum.Enum):
    """Per-frame film grain state (reference FilmGrainHeader enum)."""

    DISABLE = "disable"
    COPY_REF = "copy_ref"
    UPDATE = "update"


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
        """Parameter equality with grain_seed excluded — the aggregation
        rule for extending a table segment (reference grain.rs:83-106)."""
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
class GrainHeader:
    """Per-frame grain outcome from parsing.

    ``ref_idx``/``seed`` support decoder-side grain resolution (the
    render pipeline): COPY_REF carries film_grain_params_ref_idx and
    the freshly-read 16-bit seed that replaces the copied one (spec
    5.9.30 tempGrainSeed rule); show_existing_frame COPY_REF carries
    frame_to_show_map_idx and no seed (the saved seed is kept)."""

    action: GrainAction
    params: Optional[FilmGrainParams] = None  # set iff action == UPDATE
    ref_idx: Optional[int] = None  # set iff action == COPY_REF
    seed: Optional[int] = None  # fresh seed (UPDATE and inter COPY_REF)


@dataclass
class GrainTableSegment:
    """A time range [start_time, end_time) in 1/10^7-second ticks sharing
    one set of grain parameters (the filmgrn1 'E' record)."""

    start_time: int
    end_time: int
    params: FilmGrainParams


@dataclass
class TimingInfo:
    equal_picture_interval: bool


@dataclass
class DecoderModelInfo:
    buffer_delay_length_minus_1: int
    buffer_removal_time_length_minus_1: int
    frame_presentation_time_length_minus_1: int


@dataclass
class ColorConfig:
    bit_depth: int = 8
    color_primaries: int = 2  # unspecified
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range_full: bool = False
    num_planes: int = 3
    separate_uv_delta_q: bool = False
    subsampling: Tuple[int, int] = (1, 1)

    @property
    def monochrome(self) -> bool:
        return self.num_planes == 1


SELECT_SCREEN_CONTENT_TOOLS = 2
SELECT_INTEGER_MV = 2


@dataclass
class SequenceHeader:
    reduced_still_picture_header: bool = False
    frame_id_numbers_present: bool = False
    additional_frame_id_len_minus_1: int = 0
    delta_frame_id_len_minus_2: int = 0
    film_grain_params_present: bool = False
    force_screen_content_tools: int = SELECT_SCREEN_CONTENT_TOOLS
    force_integer_mv: int = SELECT_INTEGER_MV
    order_hint_bits: int = 0
    frame_width_bits: int = 1
    frame_height_bits: int = 1
    max_frame_width: int = 1
    max_frame_height: int = 1
    decoder_model_info: Optional[DecoderModelInfo] = None
    decoder_model_present_for_op: List[bool] = field(default_factory=lambda: [False])
    operating_points_cnt_minus_1: int = 0
    operating_point_idc: List[int] = field(default_factory=lambda: [0])
    cur_operating_point_idc: int = 0
    timing_info: Optional[TimingInfo] = None
    enable_ref_frame_mvs: bool = False
    enable_warped_motion: bool = False
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    use_128x128_superblock: bool = False
    color_config: ColorConfig = field(default_factory=ColorConfig)
    # Absolute bit offset (within the OBU payload) of the
    # film_grain_params_present flag — recorded for surgical rewrite.
    fgp_present_bit_offset: int = 0

    @property
    def enable_order_hint(self) -> bool:
        return self.order_hint_bits > 0


@dataclass
class ObuExtension:
    temporal_id: int
    spatial_id: int


@dataclass
class ObuHeader:
    obu_type: ObuType
    has_size_field: bool
    extension: Optional[ObuExtension] = None

    @property
    def size_bytes(self) -> int:
        return 2 if self.extension is not None else 1


@dataclass
class TileInfo:
    tile_cols: int = 1
    tile_rows: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0


@dataclass
class FrameHeader:
    """Result of parsing one frame's uncompressed header.

    ``grain_bit_range`` is the (start, end) absolute bit span of the
    film_grain_params() syntax inside the packet buffer; start == end when
    the syntax is absent (grain not present / frame not shown+showable),
    which is then the insertion point for apply-mode rewrites. ``None``
    for show_existing_frame frames (grain is inherited, never rewritten).
    """

    show_frame: bool = False
    showable_frame: bool = False
    show_existing_frame: bool = False
    frame_type: FrameType = FrameType.KEY
    grain: GrainHeader = field(default_factory=lambda: GrainHeader(GrainAction.DISABLE))
    tile_info: TileInfo = field(default_factory=TileInfo)
    grain_bit_range: Optional[Tuple[int, int]] = None
    # decoder-state fields the render pipeline tracks (spec 7.20):
    # which reference slots this frame refreshes, and for
    # show_existing_frame the slot being displayed
    refresh_frame_flags: int = 0
    frame_to_show_map_idx: Optional[int] = None
