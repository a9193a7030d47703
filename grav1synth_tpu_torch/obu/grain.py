"""film_grain_params() syntax: parse and serialize.

AV1 spec 5.9.30. Behavior parity with reference grav1synth
src/parser/grain.rs:136-295 (parse) and src/parser/frame.rs:705-835
(serialize); one symmetric module instead of the reference's split
read/write mirror.
"""

from __future__ import annotations

from ..bitio import BitReader, BitWriter
from .types import (
    ColorConfig,
    FilmGrainParams,
    FrameType,
    GrainAction,
    GrainHeader,
)


def parse_film_grain_params(
    r: BitReader,
    allowed: bool,
    frame_type: FrameType,
    cc: ColorConfig,
) -> GrainHeader:
    """Parse grain syntax for one frame.

    ``allowed`` is film_grain_params_present && (show_frame || showable):
    when false the syntax is entirely absent and grain is disabled
    (spec 5.9.30 first conditional).
    """
    if not allowed:
        return GrainHeader(GrainAction.DISABLE)

    if not r.bool_("apply_grain"):
        return GrainHeader(GrainAction.DISABLE)

    p = FilmGrainParams()
    p.grain_seed = r.f(16, "grain_seed")

    if frame_type == FrameType.INTER:
        update_grain = r.bool_("update_grain")
    else:
        update_grain = True
    if not update_grain:
        ref_idx = r.f(3, "film_grain_params_ref_idx")
        return GrainHeader(
            GrainAction.COPY_REF, ref_idx=ref_idx, seed=p.grain_seed
        )

    num_y_points = r.f(4, "num_y_points")
    for i in range(num_y_points):
        x = r.f(8, f"point_y_value[{i}]")
        y = r.f(8, f"point_y_scaling[{i}]")
        p.scaling_points_y.append((x, y))

    if cc.monochrome:
        p.chroma_scaling_from_luma = False
    else:
        p.chroma_scaling_from_luma = r.bool_("chroma_scaling_from_luma")

    if cc.monochrome or p.chroma_scaling_from_luma or (
        cc.subsampling == (1, 1) and num_y_points == 0
    ):
        num_cb_points = num_cr_points = 0
    else:
        num_cb_points = r.f(4, "num_cb_points")
        for i in range(num_cb_points):
            x = r.f(8, f"point_cb_value[{i}]")
            y = r.f(8, f"point_cb_scaling[{i}]")
            p.scaling_points_cb.append((x, y))
        num_cr_points = r.f(4, "num_cr_points")
        for i in range(num_cr_points):
            x = r.f(8, f"point_cr_value[{i}]")
            y = r.f(8, f"point_cr_scaling[{i}]")
            p.scaling_points_cr.append((x, y))

    p.scaling_shift = r.f(2, "grain_scaling_minus_8") + 8
    p.ar_coeff_lag = r.f(2, "ar_coeff_lag")
    num_pos_luma = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    if num_y_points > 0:
        for i in range(num_pos_luma):
            p.ar_coeffs_y.append(r.f(8, f"ar_coeffs_y_plus_128[{i}]") - 128)
        num_pos_chroma = num_pos_luma + 1
    else:
        num_pos_chroma = num_pos_luma
    if p.chroma_scaling_from_luma or num_cb_points > 0:
        for i in range(num_pos_chroma):
            p.ar_coeffs_cb.append(r.f(8, f"ar_coeffs_cb_plus_128[{i}]") - 128)
    if p.chroma_scaling_from_luma or num_cr_points > 0:
        for i in range(num_pos_chroma):
            p.ar_coeffs_cr.append(r.f(8, f"ar_coeffs_cr_plus_128[{i}]") - 128)

    p.ar_coeff_shift = r.f(2, "ar_coeff_shift_minus_6") + 6
    p.grain_scale_shift = r.f(2, "grain_scale_shift")
    if num_cb_points > 0:
        p.cb_mult = r.f(8, "cb_mult")
        p.cb_luma_mult = r.f(8, "cb_luma_mult")
        p.cb_offset = r.f(9, "cb_offset")
    if num_cr_points > 0:
        p.cr_mult = r.f(8, "cr_mult")
        p.cr_luma_mult = r.f(8, "cr_luma_mult")
        p.cr_offset = r.f(9, "cr_offset")
    p.overlap_flag = r.bool_("overlap_flag")
    p.clip_to_restricted_range = r.bool_("clip_to_restricted_range")
    return GrainHeader(GrainAction.UPDATE, p, seed=p.grain_seed)


def _exact_len(coeffs, n: int, name: str):
    """Coefficient lists must have exactly the syntax-mandated length;
    short lists are zero-padded (grain tables often omit the implicit
    chroma luma-coefficient when lag is 0), long lists truncated."""
    if len(coeffs) < n:
        return list(coeffs) + [0] * (n - len(coeffs))
    return coeffs[:n]


def write_film_grain_params(
    w: BitWriter,
    p: FilmGrainParams,
    frame_type: FrameType,
    cc: ColorConfig,
) -> None:
    """Serialize grain syntax with apply_grain=1 (and update_grain=1 for
    inter frames, matching reference frame.rs:726-731)."""
    w.put_bool(True)  # apply_grain
    w.put(p.grain_seed & 0xFFFF, 16)
    if frame_type == FrameType.INTER:
        w.put_bool(True)  # update_grain

    num_y_points = len(p.scaling_points_y)
    w.put(num_y_points, 4)
    for x, y in p.scaling_points_y:
        w.put(x, 8)
        w.put(y, 8)

    if cc.monochrome:
        chroma_scaling_from_luma = False
    else:
        chroma_scaling_from_luma = p.chroma_scaling_from_luma
        w.put_bool(chroma_scaling_from_luma)

    if cc.monochrome or chroma_scaling_from_luma or (
        cc.subsampling == (1, 1) and num_y_points == 0
    ):
        num_cb_points = num_cr_points = 0
    else:
        num_cb_points = len(p.scaling_points_cb)
        num_cr_points = len(p.scaling_points_cr)
        w.put(num_cb_points, 4)
        for x, y in p.scaling_points_cb:
            w.put(x, 8)
            w.put(y, 8)
        w.put(num_cr_points, 4)
        for x, y in p.scaling_points_cr:
            w.put(x, 8)
            w.put(y, 8)

    w.put(p.scaling_shift - 8, 2)
    w.put(p.ar_coeff_lag, 2)
    num_pos_luma = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    if num_y_points > 0:
        for c in _exact_len(p.ar_coeffs_y, num_pos_luma, "ar_coeffs_y"):
            w.put(c + 128, 8)
        num_pos_chroma = num_pos_luma + 1
    else:
        num_pos_chroma = num_pos_luma
    if chroma_scaling_from_luma or num_cb_points > 0:
        for c in _exact_len(p.ar_coeffs_cb, num_pos_chroma, "ar_coeffs_cb"):
            w.put(c + 128, 8)
    if chroma_scaling_from_luma or num_cr_points > 0:
        for c in _exact_len(p.ar_coeffs_cr, num_pos_chroma, "ar_coeffs_cr"):
            w.put(c + 128, 8)

    w.put(p.ar_coeff_shift - 6, 2)
    w.put(p.grain_scale_shift, 2)
    if num_cb_points > 0:
        w.put(p.cb_mult, 8)
        w.put(p.cb_luma_mult, 8)
        w.put(p.cb_offset, 9)
    if num_cr_points > 0:
        w.put(p.cr_mult, 8)
        w.put(p.cr_luma_mult, 8)
        w.put(p.cr_offset, 9)
    w.put_bool(p.overlap_flag)
    w.put_bool(p.clip_to_restricted_range)
