"""uncompressed_header() walk: the full conditional traversal that
reaches film_grain_params at the tail of every AV1 frame header.

AV1 spec 5.9. Behavior parity with reference grav1synth
src/parser/frame.rs:73-699 (and helpers to :1991), with two deliberate
spec-correctness upgrades over the reference:

- frame-level ``force_integer_mv`` is derived per spec 5.9.2 (the
  reference gates allow_high_precision_mv on the sequence-level value);
- reference slot sizes (RefFrameWidth/Height, RefUpscaledWidth) are
  tracked per spec 7.20 so frame_size_with_refs() resolves real
  dimensions (the reference substitutes max frame size).

Like the reference, set_frame_refs() (spec 7.8) is simplified: short
ref signaling resets ref_frame_idx to 0 (reference frame.rs:425-430);
this only influences skip-mode eligibility via order hints and has held
across the dav1d conformance corpus.

The parse records the absolute bit span of the film_grain_params()
syntax so the rewriter can splice replacement grain bits without
re-serializing the rest of the header (the reference instead mirrors
every consumed byte during write-mode parses).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..bitio import BitReader
from .grain import parse_film_grain_params
from .types import (
    FrameHeader,
    FrameType,
    GrainAction,
    GrainHeader,
    ObuHeader,
    SELECT_INTEGER_MV,
    SELECT_SCREEN_CONTENT_TOOLS,
    SequenceHeader,
    TileInfo,
)

REFS_PER_FRAME = 7
NUM_REF_FRAMES = 8
REFRESH_ALL_FRAMES = 0xFF
PRIMARY_REF_NONE = 7

SUPERRES_DENOM_BITS = 3
SUPERRES_DENOM_MIN = 9
SUPERRES_NUM = 8

MAX_TILE_WIDTH = 4096
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64
MAX_TILE_AREA = 4096 * 2304

MAX_SEGMENTS = 8
SEG_LVL_MAX = 8
SEG_LVL_ALT_Q = 0
SEGMENTATION_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEGMENTATION_FEATURE_SIGNED = (True, True, True, True, True, False, False, False)

TOTAL_REFS_PER_FRAME = 8
RESTORE_NONE = 0

GM_ABS_ALPHA_BITS = 12
GM_ABS_TRANS_ONLY_BITS = 9
GM_ABS_TRANS_BITS = 12
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3


@dataclass
class RefSlots:
    """Decoder reference-slot state threaded across frames (spec 7.20).

    Only what header *parsing* depends on is modeled: order hints drive
    skip-mode eligibility; sizes drive frame_size_with_refs and tile
    derivation.
    """

    order_hint: List[int] = field(default_factory=lambda: [0] * NUM_REF_FRAMES)
    valid: List[bool] = field(default_factory=lambda: [False] * NUM_REF_FRAMES)
    frame_width: List[int] = field(default_factory=lambda: [0] * NUM_REF_FRAMES)
    frame_height: List[int] = field(default_factory=lambda: [0] * NUM_REF_FRAMES)
    upscaled_width: List[int] = field(default_factory=lambda: [0] * NUM_REF_FRAMES)
    render_width: List[int] = field(default_factory=lambda: [0] * NUM_REF_FRAMES)
    render_height: List[int] = field(default_factory=lambda: [0] * NUM_REF_FRAMES)


def parse_uncompressed_header(
    r: BitReader,
    seq: SequenceHeader,
    obu_header: ObuHeader,
    refs: RefSlots,
    prev_tile_info: Optional[TileInfo],
) -> FrameHeader:
    """Parse one uncompressed_header(); advances ``r`` to just past
    film_grain_params (byte alignment / trailing bits are the caller's
    concern). Mutates ``refs`` per the spec reference-update rules."""
    hdr = FrameHeader()
    id_len = (
        seq.additional_frame_id_len_minus_1 + seq.delta_frame_id_len_minus_2 + 3
        if seq.frame_id_numbers_present
        else None
    )

    if seq.reduced_still_picture_header:
        frame_type = FrameType.KEY
        show_frame = True
        showable_frame = True
        show_existing_frame = False
        error_resilient_mode = False
    else:
        show_existing_frame = r.bool_("show_existing_frame")
        if show_existing_frame:
            frame_to_show_map_idx = r.f(3, "frame_to_show_map_idx")
            # temporal_point_info for equal_picture_interval==0 streams
            if seq.decoder_model_info is not None and not (
                seq.timing_info is not None and seq.timing_info.equal_picture_interval
            ):
                r.f(
                    seq.decoder_model_info.frame_presentation_time_length_minus_1 + 1,
                    "frame_presentation_time",
                )
            if id_len is not None:
                r.f(id_len, "display_frame_id")
            hdr.show_frame = True
            hdr.show_existing_frame = True
            hdr.frame_type = FrameType.KEY
            hdr.grain = GrainHeader(
                GrainAction.COPY_REF, ref_idx=frame_to_show_map_idx
            )
            hdr.frame_to_show_map_idx = frame_to_show_map_idx
            hdr.tile_info = prev_tile_info if prev_tile_info is not None else TileInfo()
            hdr.grain_bit_range = None
            return hdr
        frame_type = FrameType(r.f(2, "frame_type"))
        show_frame = r.bool_("show_frame")
        if show_frame and seq.decoder_model_info is not None and not (
            seq.timing_info is not None and seq.timing_info.equal_picture_interval
        ):
            r.f(
                seq.decoder_model_info.frame_presentation_time_length_minus_1 + 1,
                "frame_presentation_time",
            )
        if show_frame:
            showable_frame = frame_type != FrameType.KEY
        else:
            showable_frame = r.bool_("showable_frame")
        if frame_type == FrameType.SWITCH or (
            frame_type == FrameType.KEY and show_frame
        ):
            error_resilient_mode = True
        else:
            error_resilient_mode = r.bool_("error_resilient_mode")

    hdr.frame_type = frame_type
    hdr.show_frame = show_frame
    hdr.showable_frame = showable_frame
    hdr.show_existing_frame = False

    if frame_type == FrameType.KEY and show_frame:
        for i in range(NUM_REF_FRAMES):
            refs.valid[i] = False
            refs.order_hint[i] = 0

    disable_cdf_update = r.bool_("disable_cdf_update")
    if seq.force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS:
        allow_screen_content_tools = r.bool_("allow_screen_content_tools")
    else:
        allow_screen_content_tools = seq.force_screen_content_tools == 1

    # frame-level force_integer_mv per spec 5.9.2
    if allow_screen_content_tools:
        if seq.force_integer_mv == SELECT_INTEGER_MV:
            force_integer_mv = r.f(1, "force_integer_mv")
        else:
            force_integer_mv = seq.force_integer_mv
    else:
        force_integer_mv = 0
    if frame_type.is_intra:
        force_integer_mv = 1

    if seq.frame_id_numbers_present:
        r.f(id_len, "current_frame_id")

    if frame_type == FrameType.SWITCH:
        frame_size_override_flag = True
    elif seq.reduced_still_picture_header:
        frame_size_override_flag = False
    else:
        frame_size_override_flag = r.bool_("frame_size_override_flag")

    order_hint = r.f(seq.order_hint_bits, "order_hint") if seq.order_hint_bits else 0

    if frame_type.is_intra or error_resilient_mode:
        primary_ref_frame = PRIMARY_REF_NONE
    else:
        primary_ref_frame = r.f(3, "primary_ref_frame")

    if seq.decoder_model_info is not None:
        if r.bool_("buffer_removal_time_present_flag"):
            for op in range(seq.operating_points_cnt_minus_1 + 1):
                if seq.decoder_model_present_for_op[op]:
                    op_idc = seq.operating_point_idc[op]
                    t_id = obu_header.extension.temporal_id if obu_header.extension else 0
                    s_id = obu_header.extension.spatial_id if obu_header.extension else 0
                    in_t = (op_idc >> t_id) & 1
                    in_s = (op_idc >> (s_id + 8)) & 1
                    if op_idc == 0 or (in_t and in_s):
                        r.f(
                            seq.decoder_model_info.buffer_removal_time_length_minus_1 + 1,
                            f"buffer_removal_time[{op}]",
                        )

    if frame_type == FrameType.SWITCH or (frame_type == FrameType.KEY and show_frame):
        refresh_frame_flags = REFRESH_ALL_FRAMES
    else:
        refresh_frame_flags = r.f(8, "refresh_frame_flags")

    if (not frame_type.is_intra or refresh_frame_flags != REFRESH_ALL_FRAMES) and (
        error_resilient_mode and seq.enable_order_hint
    ):
        for i in range(NUM_REF_FRAMES):
            read_hint = r.f(seq.order_hint_bits, f"ref_order_hint[{i}]")
            if read_hint != refs.order_hint[i]:
                refs.valid[i] = False
            refs.order_hint[i] = read_hint

    allow_intrabc = False
    allow_high_precision_mv = False
    ref_frame_idx = [0] * REFS_PER_FRAME

    if frame_type.is_intra:
        frame_width, frame_height, upscaled_width = _frame_size(
            r, seq, frame_size_override_flag
        )
        render_width, render_height = _render_size(
            r, frame_width, frame_height, upscaled_width
        )
        if allow_screen_content_tools and upscaled_width == frame_width:
            allow_intrabc = r.bool_("allow_intrabc")
    else:
        frame_refs_short_signaling = False
        if seq.enable_order_hint:
            frame_refs_short_signaling = r.bool_("frame_refs_short_signaling")
            if frame_refs_short_signaling:
                r.f(3, "last_frame_idx")
                r.f(3, "gold_frame_idx")
                # set_frame_refs() simplified (see module docstring)
        for i in range(REFS_PER_FRAME):
            if not frame_refs_short_signaling:
                ref_frame_idx[i] = r.f(3, f"ref_frame_idx[{i}]")
                if seq.frame_id_numbers_present:
                    r.f(
                        seq.delta_frame_id_len_minus_2 + 2,
                        f"delta_frame_id_minus_1[{i}]",
                    )
        if frame_size_override_flag and not error_resilient_mode:
            frame_width, frame_height, upscaled_width, render_width, render_height = (
                _frame_size_with_refs(
                    r, seq, frame_size_override_flag, refs, ref_frame_idx
                )
            )
        else:
            frame_width, frame_height, upscaled_width = _frame_size(
                r, seq, frame_size_override_flag
            )
            render_width, render_height = _render_size(
                r, frame_width, frame_height, upscaled_width
            )
        if force_integer_mv:
            allow_high_precision_mv = False
        else:
            allow_high_precision_mv = r.bool_("allow_high_precision_mv")
        _interpolation_filter(r)
        r.bool_("is_motion_mode_switchable")
        if error_resilient_mode or not seq.enable_ref_frame_mvs:
            pass  # use_ref_frame_mvs = False; no bits either way beyond this
        else:
            r.bool_("use_ref_frame_mvs")

    mi_cols = 2 * ((frame_width + 7) >> 3)
    mi_rows = 2 * ((frame_height + 7) >> 3)

    if not (seq.reduced_still_picture_header or disable_cdf_update):
        r.bool_("disable_frame_end_update_cdf")

    tile_info = _tile_info(r, seq.use_128x128_superblock, mi_cols, mi_rows)
    q = _quantization_params(
        r, seq.color_config.num_planes, seq.color_config.separate_uv_delta_q
    )
    seg_data = _segmentation_params(r, primary_ref_frame)
    delta_q_present = _delta_q_params(r, q["base_q_idx"])
    _delta_lf_params(r, delta_q_present, allow_intrabc)

    coded_lossless = all(
        _qindex(seg_id, q["base_q_idx"], seg_data) == 0
        and q["deltaq_y_dc"] == 0
        and q["deltaq_u_ac"] == 0
        and q["deltaq_u_dc"] == 0
        and q["deltaq_v_ac"] == 0
        and q["deltaq_v_dc"] == 0
        for seg_id in range(MAX_SEGMENTS)
    )
    all_lossless = coded_lossless and frame_width == upscaled_width

    _loop_filter_params(r, coded_lossless, allow_intrabc, seq.color_config.num_planes)
    _cdef_params(
        r, coded_lossless, allow_intrabc, seq.enable_cdef, seq.color_config.num_planes
    )
    _lr_params(
        r,
        all_lossless,
        allow_intrabc,
        seq.enable_restoration,
        seq.use_128x128_superblock,
        seq.color_config.num_planes,
        seq.color_config.subsampling,
    )
    if not coded_lossless:
        r.bool_("tx_mode_select")
    reference_select = False if frame_type.is_intra else r.bool_("reference_select")
    _skip_mode_params(
        r,
        frame_type.is_intra,
        reference_select,
        seq.order_hint_bits,
        order_hint,
        refs.order_hint,
        ref_frame_idx,
    )
    if not (
        frame_type.is_intra or error_resilient_mode or not seq.enable_warped_motion
    ):
        r.bool_("allow_warped_motion")
    r.bool_("reduced_tx_set")
    _global_motion_params(r, frame_type.is_intra, allow_high_precision_mv)

    # --- film grain: record the exact bit span for surgical rewrite ---
    film_grain_allowed = show_frame or showable_frame
    grain_start = r.pos
    hdr.grain = parse_film_grain_params(
        r,
        seq.film_grain_params_present and film_grain_allowed,
        frame_type,
        seq.color_config,
    )
    hdr.grain_bit_range = (grain_start, r.pos)

    hdr.refresh_frame_flags = refresh_frame_flags

    # reference-slot updates (spec 7.20 subset)
    for i in range(NUM_REF_FRAMES):
        if (refresh_frame_flags >> i) & 1:
            refs.valid[i] = True
            refs.order_hint[i] = order_hint
            refs.frame_width[i] = frame_width
            refs.frame_height[i] = frame_height
            refs.upscaled_width[i] = upscaled_width
            refs.render_width[i] = render_width
            refs.render_height[i] = render_height

    hdr.tile_info = tile_info
    return hdr


# --------------------------------------------------------------------------
# frame size helpers (spec 5.9.5-5.9.8)


def _superres_params(r: BitReader, seq: SequenceHeader, upscaled_width: int) -> int:
    """Returns FrameWidth after superres downscale of ``upscaled_width``."""
    if seq.enable_superres:
        use_superres = r.bool_("use_superres")
    else:
        use_superres = False
    if use_superres:
        denom = r.f(SUPERRES_DENOM_BITS, "coded_denom") + SUPERRES_DENOM_MIN
    else:
        denom = SUPERRES_NUM
    return (upscaled_width * SUPERRES_NUM + denom // 2) // denom


def _frame_size(
    r: BitReader, seq: SequenceHeader, override: bool
) -> Tuple[int, int, int]:
    if override:
        width = r.f(seq.frame_width_bits, "frame_width_minus_1") + 1
        height = r.f(seq.frame_height_bits, "frame_height_minus_1") + 1
    else:
        width = seq.max_frame_width
        height = seq.max_frame_height
    upscaled_width = width
    width = _superres_params(r, seq, upscaled_width)
    return width, height, upscaled_width


def _render_size(
    r: BitReader, frame_width: int, frame_height: int, upscaled_width: int
) -> Tuple[int, int]:
    if r.bool_("render_and_frame_size_different"):
        rw = r.f(16, "render_width_minus_1") + 1
        rh = r.f(16, "render_height_minus_1") + 1
        return rw, rh
    return upscaled_width, frame_height


def _frame_size_with_refs(
    r: BitReader,
    seq: SequenceHeader,
    override: bool,
    refs: RefSlots,
    ref_frame_idx: List[int],
) -> Tuple[int, int, int, int, int]:
    found_idx = None
    for i in range(REFS_PER_FRAME):
        if r.bool_(f"found_ref[{i}]"):
            found_idx = ref_frame_idx[i]
            break
    if found_idx is not None:
        upscaled_width = refs.upscaled_width[found_idx]
        frame_height = refs.frame_height[found_idx]
        render_width = refs.render_width[found_idx]
        render_height = refs.render_height[found_idx]
        frame_width = _superres_params(r, seq, upscaled_width)
        return frame_width, frame_height, upscaled_width, render_width, render_height
    frame_width, frame_height, upscaled_width = _frame_size(r, seq, override)
    render_width, render_height = _render_size(
        r, frame_width, frame_height, upscaled_width
    )
    return frame_width, frame_height, upscaled_width, render_width, render_height


def _interpolation_filter(r: BitReader) -> None:
    if not r.bool_("is_filter_switchable"):
        r.f(2, "interpolation_filter")


# --------------------------------------------------------------------------
# tile info (spec 5.9.15)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _tile_info(
    r: BitReader, use_128x128_superblock: bool, mi_cols: int, mi_rows: int
) -> TileInfo:
    if use_128x128_superblock:
        sb_cols = (mi_cols + 31) >> 5
        sb_rows = (mi_rows + 31) >> 5
        sb_shift = 5
    else:
        sb_cols = (mi_cols + 15) >> 4
        sb_rows = (mi_rows + 15) >> 4
        sb_shift = 4
    sb_size = sb_shift + 2
    max_tile_width_sb = MAX_TILE_WIDTH >> sb_size
    max_tile_area_sb = MAX_TILE_AREA >> (2 * sb_size)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, MAX_TILE_COLS))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
    min_log2_tiles = max(
        min_log2_tile_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols)
    )

    if r.bool_("uniform_tile_spacing_flag"):
        tile_cols_log2 = min_log2_tile_cols
        while tile_cols_log2 < max_log2_tile_cols:
            if r.bool_("increment_tile_cols_log2"):
                tile_cols_log2 += 1
            else:
                break
        tile_width_sb = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2
        tile_cols = sb_cols // tile_width_sb

        min_log2_tile_rows = max(min_log2_tiles - tile_cols_log2, 0)
        tile_rows_log2 = min_log2_tile_rows
        while tile_rows_log2 < max_log2_tile_rows:
            if r.bool_("increment_tile_rows_log2"):
                tile_rows_log2 += 1
            else:
                break
        tile_height_sb = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2
        tile_rows = sb_rows // tile_height_sb
    else:
        widest_tile_sb = 0
        start_sb = 0
        i = 0
        while start_sb < sb_cols:
            max_width = min(sb_cols - start_sb, max_tile_width_sb)
            width_in_sbs = r.ns(max_width, f"width_in_sbs_minus_1[{i}]") + 1
            widest_tile_sb = max(width_in_sbs, widest_tile_sb)
            start_sb += width_in_sbs
            i += 1
        tile_cols = i
        max_tile_height_sb = max(max_tile_area_sb // widest_tile_sb, 1)
        start_sb = 0
        i = 0
        while start_sb < sb_rows:
            max_height = min(sb_rows - start_sb, max_tile_height_sb)
            height_in_sbs = r.ns(max_height, f"height_in_sbs_minus_1[{i}]") + 1
            start_sb += height_in_sbs
            i += 1
        tile_rows = i
        tile_cols_log2 = _tile_log2(1, tile_cols)
        tile_rows_log2 = _tile_log2(1, tile_rows)

    if tile_cols_log2 > 0 or tile_rows_log2 > 0:
        r.f(tile_rows_log2 + tile_cols_log2, "context_update_tile_id")
        r.f(2, "tile_size_bytes_minus_1")
    return TileInfo(tile_cols, tile_rows, tile_cols_log2, tile_rows_log2)


# --------------------------------------------------------------------------
# quantization / segmentation / filters (spec 5.9.12-5.9.20)


def _read_delta_q(r: BitReader, name: str) -> int:
    if r.bool_(name + "_coded"):
        return r.su(1 + 6, name)
    return 0


def _quantization_params(r: BitReader, num_planes: int, separate_uv_delta_q: bool):
    base_q_idx = r.f(8, "base_q_idx")
    deltaq_y_dc = _read_delta_q(r, "delta_q_y_dc")
    deltaq_u_dc = deltaq_u_ac = deltaq_v_dc = deltaq_v_ac = 0
    if num_planes > 1:
        diff_uv_delta = r.bool_("diff_uv_delta") if separate_uv_delta_q else False
        deltaq_u_dc = _read_delta_q(r, "delta_q_u_dc")
        deltaq_u_ac = _read_delta_q(r, "delta_q_u_ac")
        if diff_uv_delta:
            deltaq_v_dc = _read_delta_q(r, "delta_q_v_dc")
            deltaq_v_ac = _read_delta_q(r, "delta_q_v_ac")
        else:
            deltaq_v_dc = deltaq_u_dc
            deltaq_v_ac = deltaq_u_ac
    if r.bool_("using_qmatrix"):
        r.f(4, "qm_y")
        r.f(4, "qm_u")
        if separate_uv_delta_q:
            r.f(4, "qm_v")
    return {
        "base_q_idx": base_q_idx,
        "deltaq_y_dc": deltaq_y_dc,
        "deltaq_u_dc": deltaq_u_dc,
        "deltaq_u_ac": deltaq_u_ac,
        "deltaq_v_dc": deltaq_v_dc,
        "deltaq_v_ac": deltaq_v_ac,
    }


def _segmentation_params(r: BitReader, primary_ref_frame: int):
    seg_data = None
    if r.bool_("segmentation_enabled"):
        seg_data = [[None] * SEG_LVL_MAX for _ in range(MAX_SEGMENTS)]
        if primary_ref_frame == PRIMARY_REF_NONE:
            segmentation_update_data = True
        else:
            if r.bool_("segmentation_update_map"):
                r.bool_("segmentation_temporal_update")
            segmentation_update_data = r.bool_("segmentation_update_data")
        if segmentation_update_data:
            for i in range(MAX_SEGMENTS):
                for j in range(SEG_LVL_MAX):
                    if r.bool_(f"feature_enabled[{i}][{j}]"):
                        bits = SEGMENTATION_FEATURE_BITS[j]
                        if SEGMENTATION_FEATURE_SIGNED[j]:
                            value = r.su(1 + bits, f"feature_value[{i}][{j}]")
                        else:
                            value = r.f(bits, f"feature_value[{i}][{j}]")
                        seg_data[i][j] = value
    return seg_data


def _qindex(segment_id: int, base_q_idx: int, seg_data) -> int:
    if seg_data is not None and seg_data[segment_id][SEG_LVL_ALT_Q] is not None:
        q = base_q_idx + seg_data[segment_id][SEG_LVL_ALT_Q]
        return max(0, min(255, q))
    return base_q_idx


def _delta_q_params(r: BitReader, base_q_idx: int) -> bool:
    delta_q_present = r.bool_("delta_q_present") if base_q_idx > 0 else False
    if delta_q_present:
        r.f(2, "delta_q_res")
    return delta_q_present


def _delta_lf_params(r: BitReader, delta_q_present: bool, allow_intrabc: bool) -> None:
    if delta_q_present:
        delta_lf_present = False if allow_intrabc else r.bool_("delta_lf_present")
        if delta_lf_present:
            r.f(2, "delta_lf_res")
            r.bool_("delta_lf_multi")


def _loop_filter_params(
    r: BitReader, coded_lossless: bool, allow_intrabc: bool, num_planes: int
) -> None:
    if coded_lossless or allow_intrabc:
        return
    l0 = r.f(6, "loop_filter_level[0]")
    l1 = r.f(6, "loop_filter_level[1]")
    if num_planes > 1 and (l0 > 0 or l1 > 0):
        r.f(6, "loop_filter_level[2]")
        r.f(6, "loop_filter_level[3]")
    r.f(3, "loop_filter_sharpness")
    if r.bool_("loop_filter_delta_enabled"):
        if r.bool_("loop_filter_delta_update"):
            for i in range(TOTAL_REFS_PER_FRAME):
                if r.bool_(f"update_ref_delta[{i}]"):
                    r.su(1 + 6, f"loop_filter_ref_deltas[{i}]")
            for i in range(2):
                if r.bool_(f"update_mode_delta[{i}]"):
                    r.su(1 + 6, f"loop_filter_mode_deltas[{i}]")


def _cdef_params(
    r: BitReader,
    coded_lossless: bool,
    allow_intrabc: bool,
    enable_cdef: bool,
    num_planes: int,
) -> None:
    if coded_lossless or allow_intrabc or not enable_cdef:
        return
    r.f(2, "cdef_damping_minus_3")
    cdef_bits = r.f(2, "cdef_bits")
    for i in range(1 << cdef_bits):
        r.f(4, f"cdef_y_pri_strength[{i}]")
        r.f(2, f"cdef_y_sec_strength[{i}]")
        if num_planes > 1:
            r.f(4, f"cdef_uv_pri_strength[{i}]")
            r.f(2, f"cdef_uv_sec_strength[{i}]")


def _lr_params(
    r: BitReader,
    all_lossless: bool,
    allow_intrabc: bool,
    enable_restoration: bool,
    use_128x128_superblock: bool,
    num_planes: int,
    subsampling: Tuple[int, int],
) -> None:
    if all_lossless or allow_intrabc or not enable_restoration:
        return
    uses_lr = False
    uses_chroma_lr = False
    for i in range(num_planes):
        lr_type = r.f(2, f"lr_type[{i}]")
        if lr_type != RESTORE_NONE:
            uses_lr = True
            if i > 0:
                uses_chroma_lr = True
    if uses_lr:
        if use_128x128_superblock:
            r.bool_("lr_unit_shift")
        else:
            if r.bool_("lr_unit_shift"):
                r.bool_("lr_unit_extra_shift")
        if subsampling[0] and subsampling[1] and uses_chroma_lr:
            r.bool_("lr_uv_shift")


# --------------------------------------------------------------------------
# skip mode (spec 5.9.22) and global motion (spec 5.9.24-5.9.26)


def _relative_dist(a: int, b: int, order_hint_bits: int) -> int:
    if order_hint_bits == 0:
        return 0
    diff = a - b
    m = 1 << (order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def _skip_mode_params(
    r: BitReader,
    frame_is_intra: bool,
    reference_select: bool,
    order_hint_bits: int,
    order_hint: int,
    slot_order_hint: List[int],
    ref_frame_idx: List[int],
) -> None:
    if frame_is_intra or not reference_select or order_hint_bits == 0:
        skip_mode_allowed = False
    else:
        forward_idx = backward_idx = -1
        forward_hint = backward_hint = -1
        for i in range(REFS_PER_FRAME):
            ref_hint = slot_order_hint[ref_frame_idx[i]]
            if _relative_dist(ref_hint, order_hint, order_hint_bits) < 0:
                if (
                    forward_idx < 0
                    or _relative_dist(ref_hint, forward_hint, order_hint_bits) > 0
                ):
                    forward_idx = i
                    forward_hint = ref_hint
            elif _relative_dist(ref_hint, order_hint, order_hint_bits) > 0:
                if (
                    backward_idx < 0
                    or _relative_dist(ref_hint, backward_hint, order_hint_bits) < 0
                ):
                    backward_idx = i
                    backward_hint = ref_hint
        if forward_idx < 0:
            skip_mode_allowed = False
        elif backward_idx >= 0:
            skip_mode_allowed = True
        else:
            second_forward_idx = -1
            second_forward_hint = -1
            for i in range(REFS_PER_FRAME):
                ref_hint = slot_order_hint[ref_frame_idx[i]]
                if _relative_dist(ref_hint, forward_hint, order_hint_bits) < 0:
                    if (
                        second_forward_idx < 0
                        or _relative_dist(
                            ref_hint, second_forward_hint, order_hint_bits
                        )
                        > 0
                    ):
                        second_forward_idx = i
                        second_forward_hint = ref_hint
            skip_mode_allowed = second_forward_idx >= 0
    if skip_mode_allowed:
        r.bool_("skip_mode_present")


def _decode_subexp(r: BitReader, num_syms: int) -> int:
    i = 0
    mk = 0
    k = 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return r.ns(num_syms - mk, "subexp_final_bits") + mk
        if r.bool_("subexp_more_bits"):
            i += 1
            mk += a
        else:
            return r.f(b2, "subexp_bits") + mk


def _read_global_param(
    r: BitReader, gm_type: int, allow_high_precision_mv: bool, idx: int
) -> None:
    abs_bits = GM_ABS_ALPHA_BITS
    if idx < 2:
        if gm_type == TRANSLATION:
            abs_bits = GM_ABS_TRANS_ONLY_BITS - (0 if allow_high_precision_mv else 1)
        else:
            abs_bits = GM_ABS_TRANS_BITS
    mx = 1 << abs_bits
    # decode_signed_subexp_with_ref over [-mx, mx+1): bit consumption depends
    # only on the symbol count; the decoded value is not needed for parsing.
    _decode_subexp(r, 2 * mx + 1)


def _global_motion_params(
    r: BitReader, frame_is_intra: bool, allow_high_precision_mv: bool
) -> None:
    if frame_is_intra:
        return
    for ref in range(1, 8):  # LAST..ALTREF
        gm_type = IDENTITY
        if r.bool_(f"is_global[{ref}]"):
            if r.bool_(f"is_rot_zoom[{ref}]"):
                gm_type = ROTZOOM
            else:
                gm_type = TRANSLATION if r.bool_(f"is_translation[{ref}]") else AFFINE
        if gm_type >= ROTZOOM:
            _read_global_param(r, gm_type, allow_high_precision_mv, 2)
            _read_global_param(r, gm_type, allow_high_precision_mv, 3)
            if gm_type == AFFINE:
                _read_global_param(r, gm_type, allow_high_precision_mv, 4)
                _read_global_param(r, gm_type, allow_high_precision_mv, 5)
        if gm_type >= TRANSLATION:
            _read_global_param(r, gm_type, allow_high_precision_mv, 0)
            _read_global_param(r, gm_type, allow_high_precision_mv, 1)
