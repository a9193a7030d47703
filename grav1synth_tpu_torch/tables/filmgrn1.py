"""filmgrn1 grain-table interchange format: parse + serialize.

The aomenc/av1an-compatible text format (reference grav1synth
src/main.rs:631-696 writer; the parser replaces the av1-grain crate's
parse_grain_table). Layout per segment:

    filmgrn1
    E <start_ts> <end_ts> 1 <grain_seed> 1        # ts in 1/10^7 s
    \tp <ar_coeff_lag> <ar_coeff_shift> <grain_scale_shift>
        <scaling_shift> <chroma_scaling_from_luma> <overlap_flag>
        <cb_mult> <cb_luma_mult> <cb_offset> <cr_mult> <cr_luma_mult>
        <cr_offset>
    \tsY <n>  <x0> <y0> ...
    \tsCb <n> ... / \tsCr <n> ...
    \tcY ... / \tcCb ... / \tcCr ...              # signed AR coeffs
"""

from __future__ import annotations

from typing import Iterable, List, TextIO

from ..obu.types import FilmGrainParams, GrainTableSegment

MAGIC = "filmgrn1"


class GrainTableError(ValueError):
    pass


def write_segment(seg: GrainTableSegment, out: TextIO) -> None:
    p = seg.params
    out.write(f"E {seg.start_time} {seg.end_time} 1 {p.grain_seed} 1\n")
    out.write(
        "\tp {} {} {} {} {} {} {} {} {} {} {} {}\n".format(
            p.ar_coeff_lag,
            p.ar_coeff_shift,
            p.grain_scale_shift,
            p.scaling_shift,
            int(p.chroma_scaling_from_luma),
            int(p.overlap_flag),
            p.cb_mult,
            p.cb_luma_mult,
            p.cb_offset,
            p.cr_mult,
            p.cr_luma_mult,
            p.cr_offset,
        )
    )
    # note: the extra space after the sY count matches the reference's
    # output byte-for-byte (main.rs:659)
    out.write(f"\tsY {len(p.scaling_points_y)} ")
    for x, y in p.scaling_points_y:
        out.write(f" {x} {y}")
    out.write("\n")
    out.write(f"\tsCb {len(p.scaling_points_cb)}")
    for x, y in p.scaling_points_cb:
        out.write(f" {x} {y}")
    out.write("\n")
    out.write(f"\tsCr {len(p.scaling_points_cr)}")
    for x, y in p.scaling_points_cr:
        out.write(f" {x} {y}")
    out.write("\n")
    for label, coeffs in (
        ("cY", p.ar_coeffs_y),
        ("cCb", p.ar_coeffs_cb),
        ("cCr", p.ar_coeffs_cr),
    ):
        out.write(f"\t{label}")
        for c in coeffs:
            out.write(f" {c}")
        out.write("\n")


def write_table(segments: Iterable[GrainTableSegment], out: TextIO) -> None:
    out.write(MAGIC + "\n")
    for seg in segments:
        write_segment(seg, out)


def dump_table(segments: Iterable[GrainTableSegment], path: str) -> None:
    with open(path, "w") as fh:
        write_table(segments, fh)


def parse_table(text: str) -> List[GrainTableSegment]:
    """Parse a filmgrn1 table (tolerant of whitespace variations)."""
    lines = [ln.strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if not lines or lines[0].split()[0] != MAGIC:
        raise GrainTableError("missing filmgrn1 magic")
    segments: List[GrainTableSegment] = []
    i = 1
    while i < len(lines):
        tok = lines[i].split()
        if tok[0] != "E":
            raise GrainTableError(f"expected E record at line {i + 1}: {lines[i]!r}")
        if len(tok) < 6:
            raise GrainTableError(f"short E record: {lines[i]!r}")
        start, end = int(tok[1]), int(tok[2])
        seed = int(tok[4])
        apply_grain = int(tok[3])
        update_params = int(tok[5])
        p = FilmGrainParams(grain_seed=seed)
        i += 1
        if not (apply_grain and update_params):
            # degenerate segment (grain disabled); keep defaults
            segments.append(GrainTableSegment(start, end, p))
            continue
        fields = {}
        while i < len(lines) and lines[i].split()[0] in (
            "p",
            "sY",
            "sCb",
            "sCr",
            "cY",
            "cCb",
            "cCr",
        ):
            t = lines[i].split()
            fields[t[0]] = t[1:]
            i += 1
        try:
            pv = [int(v) for v in fields["p"]]
            (
                p.ar_coeff_lag,
                p.ar_coeff_shift,
                p.grain_scale_shift,
                p.scaling_shift,
                csfl,
                overlap,
                p.cb_mult,
                p.cb_luma_mult,
                p.cb_offset,
                p.cr_mult,
                p.cr_luma_mult,
                p.cr_offset,
            ) = pv[:12]
            p.chroma_scaling_from_luma = bool(csfl)
            p.overlap_flag = bool(overlap)

            def points(key, limit):
                vals = [int(v) for v in fields.get(key, ["0"])]
                n = vals[0]
                if n > limit:
                    raise GrainTableError(f"{key} has {n} points (max {limit})")
                pts = vals[1 : 1 + 2 * n]
                if len(pts) < 2 * n:
                    raise GrainTableError(f"{key} truncated")
                return [(pts[2 * k], pts[2 * k + 1]) for k in range(n)]

            p.scaling_points_y = points("sY", 14)
            p.scaling_points_cb = points("sCb", 10)
            p.scaling_points_cr = points("sCr", 10)
            p.ar_coeffs_y = [int(v) for v in fields.get("cY", [])]
            p.ar_coeffs_cb = [int(v) for v in fields.get("cCb", [])]
            p.ar_coeffs_cr = [int(v) for v in fields.get("cCr", [])]
        except KeyError as e:
            raise GrainTableError(f"segment missing record {e}") from None
        # clip_to_restricted_range is not represented in the table
        # format; applied grain defaults to full processing (the
        # reference sets it true when converting av1-grain segments,
        # main.rs/grain.rs From impl)
        p.clip_to_restricted_range = True
        segments.append(GrainTableSegment(start, end, p))
    return segments


def load_table(path: str) -> List[GrainTableSegment]:
    with open(path) as fh:
        return parse_table(fh.read())
