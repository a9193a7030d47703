"""sequence_header_obu() syntax parser.

AV1 spec 5.5. Behavior parity with reference grav1synth
src/parser/sequence.rs:163-457; the write path differs by design: we
record the absolute bit offset of film_grain_params_present and flip it
by offset (obu.py), instead of mirroring bytes during the parse.
"""

from __future__ import annotations

from ..bitio import BitReader
from .types import (
    ColorConfig,
    DecoderModelInfo,
    SELECT_INTEGER_MV,
    SELECT_SCREEN_CONTENT_TOOLS,
    SequenceHeader,
    TimingInfo,
)

# Color metadata constants used by the sRGB shortcut (spec 6.4.2)
CP_BT_709 = 1
TC_SRGB = 13
MC_IDENTITY = 0


def parse_sequence_header(r: BitReader, payload_start_bit: int) -> SequenceHeader:
    """Parse a sequence header OBU payload.

    ``payload_start_bit`` is the absolute bit position where the payload
    begins (used to record the grain-flag offset relative to it).
    """
    s = SequenceHeader()
    seq_profile = r.f(3, "seq_profile")
    r.bool_("still_picture")
    s.reduced_still_picture_header = r.bool_("reduced_still_picture_header")

    if s.reduced_still_picture_header:
        r.f(5, "seq_level_idx[0]")
        s.operating_points_cnt_minus_1 = 0
        s.operating_point_idc = [0]
        s.decoder_model_present_for_op = [False]
        s.decoder_model_info = None
        s.timing_info = None
    else:
        timing_info_present = r.bool_("timing_info_present_flag")
        initial_display_delay_present = False
        if timing_info_present:
            s.timing_info = _timing_info(r)
            if r.bool_("decoder_model_info_present_flag"):
                s.decoder_model_info = _decoder_model_info(r)
        initial_display_delay_present = r.bool_("initial_display_delay_present_flag")
        s.operating_points_cnt_minus_1 = r.f(5, "operating_points_cnt_minus_1")
        s.operating_point_idc = []
        s.decoder_model_present_for_op = []
        for i in range(s.operating_points_cnt_minus_1 + 1):
            s.operating_point_idc.append(r.f(12, f"operating_point_idc[{i}]"))
            seq_level_idx = r.f(5, f"seq_level_idx[{i}]")
            if seq_level_idx > 7:
                r.bool_(f"seq_tier[{i}]")
            if s.decoder_model_info is not None:
                present = r.bool_(f"decoder_model_present_for_this_op[{i}]")
                if present:
                    n = s.decoder_model_info.buffer_delay_length_minus_1 + 1
                    r.f(n, "decoder_buffer_delay")
                    r.f(n, "encoder_buffer_delay")
                    r.bool_("low_delay_mode_flag")
                s.decoder_model_present_for_op.append(present)
            else:
                s.decoder_model_present_for_op.append(False)
            if initial_display_delay_present:
                if r.bool_(f"initial_display_delay_present_for_this_op[{i}]"):
                    r.f(4, f"initial_display_delay_minus_1[{i}]")

    # operating point selection is fixed to 0 (reference sequence.rs:660-662)
    s.cur_operating_point_idc = s.operating_point_idc[0]

    s.frame_width_bits = r.f(4, "frame_width_bits_minus_1") + 1
    s.frame_height_bits = r.f(4, "frame_height_bits_minus_1") + 1
    s.max_frame_width = r.f(s.frame_width_bits, "max_frame_width_minus_1") + 1
    s.max_frame_height = r.f(s.frame_height_bits, "max_frame_height_minus_1") + 1

    if s.reduced_still_picture_header:
        s.frame_id_numbers_present = False
    else:
        s.frame_id_numbers_present = r.bool_("frame_id_numbers_present_flag")
    if s.frame_id_numbers_present:
        s.delta_frame_id_len_minus_2 = r.f(4, "delta_frame_id_length_minus_2")
        s.additional_frame_id_len_minus_1 = r.f(3, "additional_frame_id_length_minus_1")

    s.use_128x128_superblock = r.bool_("use_128x128_superblock")
    r.bool_("enable_filter_intra")
    r.bool_("enable_intra_edge_filter")

    if s.reduced_still_picture_header:
        s.force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS
        s.force_integer_mv = SELECT_INTEGER_MV
        s.order_hint_bits = 0
        s.enable_ref_frame_mvs = False
        s.enable_warped_motion = False
    else:
        r.bool_("enable_interintra_compound")
        r.bool_("enable_masked_compound")
        s.enable_warped_motion = r.bool_("enable_warped_motion")
        r.bool_("enable_dual_filter")
        enable_order_hint = r.bool_("enable_order_hint")
        if enable_order_hint:
            r.bool_("enable_jnt_comp")
            s.enable_ref_frame_mvs = r.bool_("enable_ref_frame_mvs")
        if r.bool_("seq_choose_screen_content_tools"):
            s.force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS
        else:
            s.force_screen_content_tools = r.f(1, "seq_force_screen_content_tools")
        if s.force_screen_content_tools > 0:
            if r.bool_("seq_choose_integer_mv"):
                s.force_integer_mv = SELECT_INTEGER_MV
            else:
                s.force_integer_mv = r.f(1, "seq_force_integer_mv")
        else:
            s.force_integer_mv = SELECT_INTEGER_MV
        if enable_order_hint:
            s.order_hint_bits = r.f(3, "order_hint_bits_minus_1") + 1
        else:
            s.order_hint_bits = 0

    s.enable_superres = r.bool_("enable_superres")
    s.enable_cdef = r.bool_("enable_cdef")
    s.enable_restoration = r.bool_("enable_restoration")
    s.color_config = _color_config(r, seq_profile)
    s.fgp_present_bit_offset = r.pos - payload_start_bit
    s.film_grain_params_present = r.bool_("film_grain_params_present")
    return s


def _timing_info(r: BitReader) -> TimingInfo:
    r.f(32, "num_units_in_display_tick")
    r.f(32, "time_scale")
    equal_picture_interval = r.bool_("equal_picture_interval")
    if equal_picture_interval:
        r.uvlc("num_ticks_per_picture_minus_1")
    return TimingInfo(equal_picture_interval)


def _decoder_model_info(r: BitReader) -> DecoderModelInfo:
    buffer_delay_length_minus_1 = r.f(5, "buffer_delay_length_minus_1")
    r.f(32, "num_units_in_decoding_tick")
    return DecoderModelInfo(
        buffer_delay_length_minus_1,
        r.f(5, "buffer_removal_time_length_minus_1"),
        r.f(5, "frame_presentation_time_length_minus_1"),
    )


def _color_config(r: BitReader, seq_profile: int) -> ColorConfig:
    cc = ColorConfig()
    high_bitdepth = r.bool_("high_bitdepth")
    if seq_profile == 2 and high_bitdepth:
        cc.bit_depth = 12 if r.bool_("twelve_bit") else 10
    else:
        cc.bit_depth = 10 if high_bitdepth else 8

    if seq_profile == 1:
        monochrome = False
    else:
        monochrome = r.bool_("mono_chrome")
    cc.num_planes = 1 if monochrome else 3

    if r.bool_("color_description_present_flag"):
        cc.color_primaries = r.f(8, "color_primaries")
        cc.transfer_characteristics = r.f(8, "transfer_characteristics")
        cc.matrix_coefficients = r.f(8, "matrix_coefficients")

    if monochrome:
        cc.color_range_full = bool(r.f(1, "color_range"))
        cc.subsampling = (1, 1)
        cc.separate_uv_delta_q = False
        return cc

    if (
        cc.color_primaries == CP_BT_709
        and cc.transfer_characteristics == TC_SRGB
        and cc.matrix_coefficients == MC_IDENTITY
    ):
        cc.color_range_full = True
        cc.subsampling = (0, 0)
    else:
        cc.color_range_full = bool(r.f(1, "color_range"))
        if seq_profile == 0:
            cc.subsampling = (1, 1)
        elif seq_profile == 1:
            cc.subsampling = (0, 0)
        else:
            if cc.bit_depth == 12:
                ss_x = r.f(1, "subsampling_x")
                ss_y = r.f(1, "subsampling_y") if ss_x else 0
                cc.subsampling = (ss_x, ss_y)
            else:
                cc.subsampling = (1, 0)
        if cc.subsampling == (1, 1):
            r.f(2, "chroma_sample_position")
    cc.separate_uv_delta_q = r.bool_("separate_uv_delta_q")
    return cc
