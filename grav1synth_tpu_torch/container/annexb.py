"""Raw AV1 elementary-stream framings: Annex B and low-overhead Section 5.

The reference only reads containerized streams via FFmpeg (reader.rs);
this module makes the framework self-contained for the two raw
bitstream formats the AV1 spec defines:

- **Annex B** (length-delimited, spec B.1-B.3): a sequence of temporal
  units, each ``temporal_unit_size`` (leb128) followed by frame units
  (``frame_unit_size`` + OBUs, each ``obu_length`` + open_bitstream_unit).
  OBUs here normally omit their internal size field — the external
  ``obu_length`` delimits them — so parsing needs explicit extents
  (Av1Parser.parse_packet(extents=...)).
- **Low-overhead Section 5** (spec 5.2): back-to-back OBUs with
  internal size fields; temporal units begin at temporal-delimiter
  OBUs. This is the payload framing IVF/MKV/MP4 carry, stored bare.

Structure is preserved exactly on rewrite: frame-unit grouping,
per-OBU size-field presence, and leb128 encodings of untouched OBUs
round-trip byte-identically; only resized OBUs get re-encoded lengths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..bitio import leb128_encode

OBU_TEMPORAL_DELIMITER = 2
OBU_SEQUENCE_HEADER = 1
_VALID_OBU_TYPES = frozenset({1, 2, 3, 4, 5, 6, 7, 8, 15})


class AnnexBError(ValueError):
    pass


def _read_leb128(data: bytes, pos: int) -> Tuple[int, int]:
    """(value, new_pos); spec 4.10.5 (<= 8 bytes, value < 2^32)."""
    value = 0
    for i in range(8):
        if pos + i >= len(data):
            raise AnnexBError("truncated leb128")
        b = data[pos + i]
        value |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            if value >= 1 << 32:
                raise AnnexBError("leb128 value exceeds 32 bits")
            return value, pos + i + 1
    raise AnnexBError("leb128 longer than 8 bytes")


@dataclass
class TemporalUnit:
    """One Annex B temporal unit: frame units of raw OBU byte strings
    (header + payload, WITHOUT the external obu_length prefix)."""

    frame_units: List[List[bytes]] = field(default_factory=list)

    def obus(self) -> List[bytes]:
        return [o for fu in self.frame_units for o in fu]

    def regroup(self, new_obus: List[bytes]) -> "TemporalUnit":
        """Same frame-unit shape, new OBU bytes (post-rewrite)."""
        out: List[List[bytes]] = []
        i = 0
        for fu in self.frame_units:
            out.append(new_obus[i : i + len(fu)])
            i += len(fu)
        assert i == len(new_obus)
        return TemporalUnit(out)


def parse_annexb(data: bytes) -> List[TemporalUnit]:
    """Split a length-delimited stream into temporal units (spec B.2)."""
    tus: List[TemporalUnit] = []
    pos = 0
    while pos < len(data):
        tu_size, pos = _read_leb128(data, pos)
        tu_end = pos + tu_size
        if tu_size == 0 or tu_end > len(data):
            raise AnnexBError(f"temporal_unit_size {tu_size} overruns stream")
        tu = TemporalUnit()
        while pos < tu_end:
            fu_size, pos = _read_leb128(data, pos)
            fu_end = pos + fu_size
            if fu_size == 0 or fu_end > tu_end:
                raise AnnexBError(f"frame_unit_size {fu_size} overruns TU")
            fu: List[bytes] = []
            while pos < fu_end:
                obu_len, pos = _read_leb128(data, pos)
                if obu_len == 0 or pos + obu_len > fu_end:
                    raise AnnexBError(f"obu_length {obu_len} overruns FU")
                fu.append(data[pos : pos + obu_len])
                pos += obu_len
            tu.frame_units.append(fu)
        tus.append(tu)
    return tus


def serialize_annexb(tus: List[TemporalUnit]) -> bytes:
    out = bytearray()
    for tu in tus:
        body = bytearray()
        for fu in tu.frame_units:
            fu_body = bytearray()
            for obu in fu:
                fu_body += leb128_encode(len(obu))
                fu_body += obu
            body += leb128_encode(len(fu_body))
            body += fu_body
        out += leb128_encode(len(body))
        out += body
    return bytes(out)


def _obu_header_ok(b0: int, size_field: Optional[bool] = None) -> bool:
    if b0 & 0x80 or b0 & 0x01:  # forbidden bit, reserved bit
        return False
    if ((b0 >> 3) & 0xF) not in _VALID_OBU_TYPES:
        return False
    if size_field is not None and bool(b0 & 0x02) != size_field:
        return False
    return True


def detect_annexb(data: bytes) -> bool:
    """Probe: a plausible tu_size/fu_size/obu_length chain reaching a
    valid OBU header (the same shape FFmpeg's annexb probe checks).
    Section-5 streams fail it: their leading temporal delimiter
    (0x12 0x00) decodes to fu_size == 0."""
    try:
        tu_size, pos = _read_leb128(data, 0)
        tu_end = pos + tu_size
        if tu_size == 0 or tu_end > len(data):
            return False
        fu_size, pos = _read_leb128(data, pos)
        fu_end = pos + fu_size
        if fu_size == 0 or fu_end > tu_end:
            return False
        obu_len, pos = _read_leb128(data, pos)
        if obu_len == 0 or pos + obu_len > fu_end:
            return False
        return _obu_header_ok(data[pos])
    except (AnnexBError, IndexError):
        return False


def detect_section5(data: bytes) -> bool:
    """Probe for a bare low-overhead stream: the first OBU must be a
    temporal delimiter or sequence header with a size field (spec 5.2
    requires size fields when the framing carries no lengths)."""
    if len(data) < 2 or not _obu_header_ok(data[0], size_field=True):
        return False
    obu_type = (data[0] >> 3) & 0xF
    if obu_type not in (OBU_TEMPORAL_DELIMITER, OBU_SEQUENCE_HEADER):
        return False
    try:
        pos = 2 if data[0] & 0x04 else 1  # skip extension byte
        size, pos = _read_leb128(data, pos)
    except AnnexBError:
        return False
    if obu_type == OBU_TEMPORAL_DELIMITER and size != 0:
        return False
    return pos + size <= len(data)


def split_section5_tus(data: bytes) -> List[bytes]:
    """Split a bare Section-5 stream into temporal-unit packets at
    temporal-delimiter OBUs. Every OBU must carry a size field except
    the stream's final one (delimited by EOF)."""
    boundaries: List[int] = []
    pos = 0
    n = len(data)
    while pos < n:
        b0 = data[pos]
        if not _obu_header_ok(b0):
            raise AnnexBError(f"invalid OBU header byte {b0:#x} at {pos}")
        obu_type = (b0 >> 3) & 0xF
        if obu_type == OBU_TEMPORAL_DELIMITER:
            boundaries.append(pos)
        hdr = pos + (2 if b0 & 0x04 else 1)
        if b0 & 0x02:
            size, payload = _read_leb128(data, hdr)
            pos = payload + size
            if pos > n:
                raise AnnexBError("OBU size overruns stream")
        else:
            pos = n  # size-field-less: last OBU, runs to EOF
    if not boundaries or boundaries[0] != 0:
        boundaries.insert(0, 0)
    boundaries.append(n)
    return [
        data[boundaries[i] : boundaries[i + 1]]
        for i in range(len(boundaries) - 1)
        if boundaries[i + 1] > boundaries[i]
    ]


def tu_to_section5(data: bytes, extents: List[Tuple[int, int]]) -> bytes:
    """Re-frame a temporal unit as Section-5 bytes (for decoders that
    only accept size-field framing): size-field-less OBUs get the field
    set and a minimal leb128 size inserted; sized OBUs copy verbatim."""
    out = bytearray()
    for s, e in extents:
        b0 = data[s]
        hdr_len = 2 if b0 & 0x04 else 1
        if b0 & 0x02:
            out += data[s:e]
        else:
            out.append(b0 | 0x02)
            out += data[s + 1 : s + hdr_len]
            out += leb128_encode(e - s - hdr_len)
            out += data[s + hdr_len : e]
    return bytes(out)


def obu_extents(tu: TemporalUnit) -> Tuple[bytes, List[Tuple[int, int]]]:
    """Concatenate a TU's OBUs and return (bytes, per-OBU extents) for
    Av1Parser.parse_packet(extents=...)."""
    parts = tu.obus()
    ext: List[Tuple[int, int]] = []
    pos = 0
    for p in parts:
        ext.append((pos, pos + len(p)))
        pos += len(p)
    return b"".join(parts), ext
