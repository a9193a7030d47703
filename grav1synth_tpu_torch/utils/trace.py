"""Bitstream field tracing — the FFmpeg trace_headers-style debug log.

Parity with the reference trace subsystem (grav1synth
src/parser/trace.rs:12-197, README.md:44-52), which itself mimics
FFmpeg's ``trace_headers`` bitstream filter:

- every named syntax element logs one line
  ``<bit pos, left-justified 12><name><binary, right-justified so the
  line reaches column 72> = <value>`` (trace.rs:37-49), with bit
  positions anchored at the containing OBU's first byte
  (TraceCtx base_offset, trace.rs:12-30, anchored at obu.rs:115);
- per-OBU section headers ("OBU header", "Sequence Header", "Frame",
  "Frame Header", "Temporal Delimiter"; obu.rs:50,118,150,179,223);
- per-packet lines ``Packet: N bytes, pts P, dts D.``
  (parser.rs:135-141) and the write-mode re-parse banner
  ``=== Re-parsing modified packet: ... ===`` (parser.rs:368-373).

Everything goes to the ``trace_headers`` logger; enable with
GRAV1_LOG=trace_headers=debug. Zero overhead when off: the parser only
installs hooks when tracing is enabled (or install_tracer is called),
and BitReader only invokes a hook when one is set.

tests/test_trace.py diffs this output field-for-field against
libavcodec's own trace_headers BSF (via the native shim) on real
streams — the external oracle the reference never had.
"""

from __future__ import annotations

import logging

trace_log = logging.getLogger("trace_headers")

NAME_COL = 60  # name + binary are padded to this width (trace.rs:44)


def trace_field(name: str, pos: int, nbits: int, value: int) -> None:
    """One syntax element in FFmpeg trace_headers format."""
    binary = format(value & ((1 << nbits) - 1), f"0{nbits}b") if nbits else ""
    pad = max(NAME_COL - len(name), len(binary))
    trace_log.debug("%-12d%s%*s = %d", pos, name, pad, binary, value)


def trace_section(name: str) -> None:
    trace_log.debug("%s", name)


def trace_packet(nbytes: int, pts: int, dts: int) -> None:
    trace_log.debug("Packet: %d bytes, pts %d, dts %d.", nbytes, pts, dts)


def trace_reparse(nbytes: int, pts: int, dts: int) -> None:
    trace_log.debug(
        "=== Re-parsing modified packet: %d bytes, pts %d, dts %d ===",
        nbytes,
        pts,
        dts,
    )


def field_tracer(base_offset: int = 0):
    """Returns a BitReader trace hook anchored at ``base_offset`` bits."""

    def hook(name: str, pos: int, nbits: int, value: int) -> None:
        trace_field(name, pos - base_offset, nbits, value)

    return hook


def install_tracer(parser) -> None:
    """Attach the logging tracer to an Av1Parser: field lines with
    OBU-anchored positions (the parser rebases per OBU) plus section
    headers."""
    parser.trace = trace_field
    parser.trace_section = trace_section


def tracing_enabled() -> bool:
    return trace_log.isEnabledFor(logging.DEBUG)
