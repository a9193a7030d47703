"""OBU framing: packet-level parse and surgical rewrite.

AV1 spec 5.2/5.3. Behavior parity with reference grav1synth
src/parser/obu.rs:22-378 and parser.rs:26-173, re-designed:

- Parse is read-only and records *rewrite anchors* (absolute bit offsets
  of the film_grain_params span, the sequence header's
  film_grain_params_present bit, and the byte-aligned tile-data tail).
- Rewrite is a separate pass that splices new grain bits between copied
  byte ranges and re-encodes the OBU's LEB128 size (the reference
  instead mirrors bytes during a templated write-mode parse).

This makes the parser single-purpose and the rewriter O(bytes-copied),
and it keeps both paths testable in isolation.

Capability superset: top-level TileGroup OBUs (standalone FrameHeader
streams) are parsed rather than rejected (reference obu.rs:217-221
panics on them).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..bitio import BitReader, BitReaderError, BitWriter, leb128_encode
from .frame import RefSlots, parse_uncompressed_header
from .grain import write_film_grain_params
from .sequence import parse_sequence_header
from .types import (
    DEFAULT_GRAIN_SEED,
    FilmGrainParams,
    FrameHeader,
    FrameType,
    GrainAction,
    GrainTableSegment,
    ObuExtension,
    ObuHeader,
    ObuType,
    SequenceHeader,
    TileInfo,
)


@dataclass
class ParsedObu:
    """One OBU's location within a packet plus its rewrite anchors."""

    header: ObuHeader
    start_byte: int  # offset of the OBU header within the packet
    payload_start: int  # offset of the payload
    payload_end: int  # offset one past the payload
    leb_size_pos: Optional[int] = None  # offset of the leb128 size field
    leb_size_len: int = 0
    # sequence header anchors
    seq: Optional[SequenceHeader] = None
    fgp_bit_abs: Optional[int] = None  # absolute bit pos of fgp_present flag
    # frame anchors
    frame: Optional[FrameHeader] = None
    grain_bit_range: Optional[Tuple[int, int]] = None  # absolute bits in packet
    tail_start_byte: Optional[int] = None  # tile data after alignment (Frame)
    is_redundant_frame_header: bool = False


class Av1Parser:
    """Stateful packet-walking AV1 parser (one per stream).

    Threads the cross-frame decoder state the header walk depends on
    (reference parser.rs:26-43 field block): seen_frame_header,
    sequence header, reference slots, previous tile info.
    """

    def __init__(self) -> None:
        self.sequence_header: Optional[SequenceHeader] = None
        self.seen_frame_header = False
        self.refs = RefSlots()
        self.last_tile_info: Optional[TileInfo] = None
        # field hook (name, obu_relative_bit_pos, nbits, value) and
        # section hook (name); auto-wired to the trace_headers logger
        # when it is enabled, matching the reference's always-on-under-
        # RUST_LOG behavior (trace.rs:41 log_enabled guard)
        self.trace = None
        self.trace_section = None
        from ..utils.trace import install_tracer, tracing_enabled

        if tracing_enabled():
            install_tracer(self)

    def parse_packet(
        self,
        data: bytes,
        packet_ts: int = 0,
        extents: Optional[List[Tuple[int, int]]] = None,
    ) -> List[ParsedObu]:
        """Parse every OBU in a temporal-unit packet.

        ``extents`` supplies explicit per-OBU (start, end) byte ranges
        for framings that carry OBU lengths outside the OBU itself
        (Annex B ``obu_length``, spec B.2): a size-field-less OBU then
        ends at its extent instead of at the packet end."""
        out: List[ParsedObu] = []
        if extents is not None:
            for start, end in extents:
                out.append(self._parse_one(data, start, packet_ts, end))
            return out
        pos = 0
        n = len(data)
        while pos < n:
            obu = self._parse_one(data, pos, packet_ts)
            out.append(obu)
            pos = obu.payload_end
        return out

    # ------------------------------------------------------------------

    def _parse_one(
        self, data: bytes, start: int, packet_ts: int, end: Optional[int] = None
    ) -> ParsedObu:
        r = BitReader(data, start_bit=start * 8)
        if self.trace is not None:
            # bit positions are OBU-anchored (reference TraceCtx
            # base_offset, trace.rs:12-30 / obu.rs:115)
            base = start * 8
            hook = self.trace
            r.trace = lambda name, pos, nbits, value: hook(
                name, pos - base, nbits, value
            )
        if self.trace_section is not None:
            self.trace_section("OBU header")
        r.zero_bit("obu_forbidden_bit")
        obu_type = ObuType(r.f(4, "obu_type"))
        extension_flag = r.bool_("obu_extension_flag")
        has_size_field = r.bool_("obu_has_size_field")
        r.zero_bit("obu_reserved_1bit")
        extension = None
        if extension_flag:
            extension = ObuExtension(
                temporal_id=r.f(3, "temporal_id"), spatial_id=r.f(2, "spatial_id")
            )
            r.f(3, "extension_header_reserved_3bits")
        header = ObuHeader(obu_type, has_size_field, extension)

        leb_size_pos = None
        leb_size_len = 0
        if has_size_field:
            leb_size_pos = r.byte_pos()
            obu_size = r.leb128("obu_size")
            leb_size_len = r.byte_pos() - leb_size_pos
        else:
            obu_size = (end if end is not None else len(data)) - r.byte_pos()

        payload_start = r.byte_pos()
        payload_end = payload_start + obu_size
        if payload_end > len(data):
            raise BitReaderError(
                f"OBU size {obu_size} overruns packet ({payload_end} > {len(data)})"
            )
        p = ParsedObu(
            header=header,
            start_byte=start,
            payload_start=payload_start,
            payload_end=payload_end,
            leb_size_pos=leb_size_pos,
            leb_size_len=leb_size_len,
        )
        r.end = payload_end * 8

        # operating-point layer filtering (reference obu.rs:90-113)
        if (
            obu_type not in (ObuType.SEQUENCE_HEADER, ObuType.TEMPORAL_DELIMITER)
            and extension is not None
            and self.sequence_header is not None
        ):
            op_idc = self.sequence_header.cur_operating_point_idc
            if op_idc != 0:
                in_t = (op_idc >> extension.temporal_id) & 1
                in_s = (op_idc >> (extension.spatial_id + 8)) & 1
                if not (in_t and in_s):
                    return p  # dropped layer: passthrough

        if self.trace_section is not None:
            section = {
                ObuType.SEQUENCE_HEADER: "Sequence Header",
                ObuType.TEMPORAL_DELIMITER: "Temporal Delimiter",
                ObuType.FRAME: "Frame",
                ObuType.FRAME_HEADER: "Frame Header",
                ObuType.TILE_GROUP: "Tile Group",
            }.get(obu_type)
            if section is not None:
                self.trace_section(section)
        if obu_type == ObuType.SEQUENCE_HEADER:
            seq = parse_sequence_header(r, payload_start * 8)
            p.seq = seq
            p.fgp_bit_abs = payload_start * 8 + seq.fgp_present_bit_offset
            self.sequence_header = seq
        elif obu_type == ObuType.TEMPORAL_DELIMITER:
            self.seen_frame_header = False
        elif obu_type in (ObuType.FRAME, ObuType.FRAME_HEADER):
            self._parse_frame(r, p, obu_type, header)
        elif obu_type == ObuType.TILE_GROUP:
            # standalone tile group (after a FrameHeader OBU)
            tile_info = self.last_tile_info or TileInfo()
            self._parse_tile_group_header(r, tile_info)
        # all other types: passthrough
        return p

    def _parse_frame(
        self, r: BitReader, p: ParsedObu, obu_type: ObuType, header: ObuHeader
    ) -> None:
        if self.sequence_header is None:
            raise BitReaderError("frame OBU before sequence header")
        if self.seen_frame_header:
            # redundant copy of the TU's frame header: passthrough
            p.is_redundant_frame_header = True
            return
        hdr = parse_uncompressed_header(
            r, self.sequence_header, header, self.refs, self.last_tile_info
        )
        p.frame = hdr
        p.grain_bit_range = hdr.grain_bit_range
        self.last_tile_info = hdr.tile_info
        self.seen_frame_header = not hdr.show_existing_frame
        if obu_type == ObuType.FRAME:
            r.byte_alignment()
            p.tail_start_byte = r.byte_pos()
            if not hdr.show_existing_frame:
                self._parse_tile_group_header(r, hdr.tile_info)
        # FRAME_HEADER: trailing bits + padding skipped via payload_end

    def _parse_tile_group_header(self, r: BitReader, tile_info: TileInfo) -> None:
        """Reads only the tile group header to track frame boundaries
        (reference tile_group.rs:31-69)."""
        num_tiles = tile_info.tile_cols * tile_info.tile_rows
        tile_start_and_end_present = False
        if num_tiles > 1:
            tile_start_and_end_present = r.bool_("tile_start_and_end_present_flag")
        if num_tiles == 1 or not tile_start_and_end_present:
            tg_end = num_tiles - 1
        else:
            tile_bits = tile_info.tile_cols_log2 + tile_info.tile_rows_log2
            r.f(tile_bits, "tg_start")
            tg_end = r.f(tile_bits, "tg_end")
        if tg_end == num_tiles - 1:
            self.seen_frame_header = False


# ==========================================================================
# Rewrite pass


class GrainRewriter:
    """Splices new film-grain syntax into parsed packets.

    ``segments=None`` removes grain entirely (clears the sequence-level
    flag and strips per-frame syntax); a segment list applies parameters
    selected by packet timestamp, with the per-frame seed decorrelation
    rule seed_k = base + k * DEFAULT_GRAIN_SEED (mod 2^16), k counted per
    segment in processing order (reference frame.rs:625-629); computing k
    from a frame index keeps multi-shard output deterministic.
    """

    def __init__(self, segments: Optional[List[GrainTableSegment]]):
        self.segments = segments
        self._match_counts = [0] * (len(segments) if segments else 0)

    @property
    def applying(self) -> bool:
        return self.segments is not None

    def _select_params(self, packet_ts: int) -> Optional[FilmGrainParams]:
        assert self.segments is not None
        for i, seg in enumerate(self.segments):
            if seg.start_time <= packet_ts < seg.end_time:
                self._match_counts[i] += 1
                k = self._match_counts[i]
                # shallow copy: only the seed differs per frame, and the
                # shared point/coefficient lists are never mutated
                params = dataclasses.replace(
                    seg.params,
                    grain_seed=(seg.params.grain_seed + k * DEFAULT_GRAIN_SEED)
                    & 0xFFFF,
                )
                return params
        return None

    def seed_match_counts(self) -> List[int]:
        """Per-segment frame-match counters. For deterministic sharded
        rewriting, a shard covering frames after another shard seeds its
        rewriter with the predecessor's counts via set_match_counts."""
        return list(self._match_counts)

    def set_match_counts(self, counts: List[int]) -> None:
        self._match_counts = list(counts)

    def rewrite_packet(
        self,
        data: bytes,
        parsed: List[ParsedObu],
        packet_ts: int,
        seq: Optional[SequenceHeader],
    ) -> bytes:
        return b"".join(self.rewrite_obus(data, parsed, packet_ts, seq))

    def rewrite_obus(
        self,
        data: bytes,
        parsed: List[ParsedObu],
        packet_ts: int,
        seq: Optional[SequenceHeader],
    ) -> List[bytes]:
        """Per-OBU rewritten bytes, for framings that must re-encode
        external per-OBU lengths (Annex B obu_length, spec B.2)."""
        return [self._rewrite_obu(data, p, packet_ts, seq) for p in parsed]

    # ------------------------------------------------------------------

    def _rewrite_obu(
        self,
        data: bytes,
        p: ParsedObu,
        packet_ts: int,
        seq: Optional[SequenceHeader],
    ) -> bytes:
        obu_bytes = data[p.start_byte : p.payload_end]

        if p.seq is not None and p.fgp_bit_abs is not None:
            # flip film_grain_params_present in place (bit surgery; same
            # length, no size fixup needed)
            buf = bytearray(obu_bytes)
            rel_bit = p.fgp_bit_abs - p.start_byte * 8
            byte_i, bit_i = rel_bit >> 3, rel_bit & 7
            mask = 0x80 >> bit_i
            if self.applying:
                buf[byte_i] |= mask
            else:
                buf[byte_i] &= ~mask & 0xFF
            return bytes(buf)

        if p.frame is None or p.grain_bit_range is None:
            return obu_bytes  # passthrough (incl. show_existing_frame)

        hdr = p.frame
        allowed = hdr.show_frame or hdr.showable_frame
        gs, ge = p.grain_bit_range

        # Build the replacement payload bit-accurately.
        w = BitWriter()
        prefix_bytes = gs >> 3
        prefix_bits = gs & 7
        # whole bytes before the grain span
        head = data[p.payload_start : prefix_bytes]
        # partial bits of the boundary byte
        if prefix_bits:
            partial = data[prefix_bytes] >> (8 - prefix_bits)
        else:
            partial = 0

        new_params: Optional[FilmGrainParams] = None
        if self.applying and allowed:
            new_params = self._select_params(packet_ts)

        # Emit: partial bits, then replacement grain syntax
        if prefix_bits:
            w.put(partial, prefix_bits)
        if self.applying and allowed:
            if new_params is not None:
                assert seq is not None
                write_film_grain_params(
                    w, new_params, hdr.frame_type, seq.color_config
                )
            else:
                w.put_bool(False)  # apply_grain = 0
        # else (removing, or frame not shown/showable): no grain syntax at all

        if p.header.obu_type == ObuType.FRAME:
            w.byte_align(0)
            tail = data[p.tail_start_byte : p.payload_end]
            new_payload = bytes(head) + w.getvalue() + tail
        else:  # FRAME_HEADER: regenerate trailing bits
            w.align_trailing_bits()
            new_payload = bytes(head) + w.getvalue()

        # OBU size fixup
        old_size = p.payload_end - p.payload_start
        new_size = len(new_payload)
        hdr_bytes = data[p.start_byte : p.payload_start]
        if new_size != old_size:
            if p.leb_size_pos is None:
                # low-overhead framing: the OBU inherited its size from
                # the packet end (spec 5.2: only the last OBU of a TU
                # may omit the field), so resizing is expressed by
                # ADDING a size field — set obu_has_size_field in the
                # header byte and insert the LEB128 size. Conformant
                # for any decoder; later passes see a sized OBU.
                hdr_prefix = bytearray(data[p.start_byte : p.payload_start])
                hdr_prefix[0] |= 0x02  # obu_has_size_field
                hdr_bytes = bytes(hdr_prefix) + leb128_encode(new_size)
            else:
                hdr_prefix = data[p.start_byte : p.leb_size_pos]
                hdr_bytes = hdr_prefix + leb128_encode(new_size)
        return bytes(hdr_bytes) + new_payload
