"""Bit-level primitives for AV1 bitstream parsing and writing.

Host-side layer L0 of the framework. Provides MSB-first bit reading and
writing over byte buffers plus the AV1 integer codings:

- ``f(n)``     fixed-width unsigned            (AV1 spec 4.10.2)
- ``leb128``   little-endian base-128 size     (AV1 spec 4.10.5)
- ``uvlc``     variable-length unsigned        (AV1 spec 4.10.3)
- ``ns(n)``    non-symmetric unsigned          (AV1 spec 4.10.7)
- ``su(n)``    two's-complement signed         (AV1 spec 4.10.6)

Capability parity with the reference's bit layer (grav1synth
src/parser/util.rs:7-232), re-designed: a stateful cursor over an
immutable buffer instead of nom-style slice threading, with an optional
field-trace hook (the reference threads a TraceCtx through every read;
here tracing is a callback installed on the reader, zero-cost when off —
see src/parser/trace.rs:12-197 for the behavior being matched).
"""

from __future__ import annotations

from typing import Callable, Optional

TraceFn = Callable[[str, int, int, int], None]
"""Trace callback: (field_name, bit_position, n_bits, value)."""


class BitReaderError(ValueError):
    """Raised on malformed bitstream input (out-of-data, bad padding...)."""


class BitReader:
    """MSB-first bit cursor over a bytes-like buffer.

    ``pos`` is the absolute bit position from the start of ``data``.
    """

    __slots__ = ("data", "pos", "end", "trace")

    def __init__(self, data: bytes, start_bit: int = 0, end_bit: Optional[int] = None):
        self.data = data
        self.pos = start_bit
        self.end = len(data) * 8 if end_bit is None else end_bit
        self.trace: Optional[TraceFn] = None

    # -- core reads ---------------------------------------------------------

    def f(self, n: int, name: str = "") -> int:
        """Read ``n`` bits MSB-first as an unsigned integer."""
        pos = self.pos
        if pos + n > self.end:
            raise BitReaderError(
                f"bit read of {n} at {pos} overruns end {self.end}"
                + (f" (field {name!r})" if name else "")
            )
        lo_byte = pos >> 3
        hi_byte = (pos + n + 7) >> 3
        chunk = int.from_bytes(self.data[lo_byte:hi_byte], "big")
        shift = (hi_byte - lo_byte) * 8 - (pos & 7) - n
        value = (chunk >> shift) & ((1 << n) - 1)
        self.pos = pos + n
        if self.trace is not None and name:
            self.trace(name, pos, n, value)
        return value

    def bool_(self, name: str = "") -> bool:
        return bool(self.f(1, name))

    def zero_bit(self, name: str = "zero_bit") -> None:
        if self.f(1, name) != 0:
            raise BitReaderError(f"expected zero bit at {self.pos - 1}")

    def byte_alignment(self) -> None:
        """Skip to the next byte boundary, requiring the padding be zero."""
        while self.pos & 7:
            self.zero_bit("alignment_bit")

    # -- AV1 integer codings ------------------------------------------------

    def leb128(self, name: str = "leb128") -> int:
        """AV1 leb128: up to 8 bytes, 64-bit value (values >= 2^32 invalid
        per spec for OBU sizes but decoded here; caller range-checks)."""
        start = self.pos
        value = 0
        for i in range(8):
            byte = self.f(8)
            value |= (byte & 0x7F) << (7 * i)
            if not (byte & 0x80):
                break
        else:
            raise BitReaderError("leb128 longer than 8 bytes")
        if value >= 1 << 32:
            raise BitReaderError("leb128 value exceeds 32 bits")
        if self.trace is not None and name:
            self.trace(name, start, self.pos - start, value)
        return value

    def uvlc(self, name: str = "uvlc") -> int:
        """Variable length unsigned: count leading zeros, then that many
        literal bits. >=32 leading zeros saturates to 2^32-1 (spec 4.10.3)."""
        start = self.pos
        leading = 0
        while not self.f(1):
            leading += 1
            if leading >= 32:
                if self.trace is not None and name:
                    self.trace(name, start, self.pos - start, (1 << 32) - 1)
                return (1 << 32) - 1
        value = ((1 << leading) - 1) + (self.f(leading) if leading else 0)
        if self.trace is not None and name:
            self.trace(name, start, self.pos - start, value)
        return value

    def ns(self, n: int, name: str = "ns") -> int:
        """Non-symmetric unsigned in [0, n): short codes for small values."""
        start = self.pos
        w = _floor_log2(n) + 1
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            value = v
        else:
            extra = self.f(1)
            value = (v << 1) - m + extra
        if self.trace is not None and name:
            self.trace(name, start, self.pos - start, value)
        return value

    def su(self, n: int, name: str = "su") -> int:
        """Signed two's-complement: sign bit followed by n-1... AV1 su(1+n)
        convention: here ``n`` is the TOTAL bit count including sign."""
        start = self.pos
        value = self.f(n)
        sign_mask = 1 << (n - 1)
        if value & sign_mask:
            value -= 2 * sign_mask
        if self.trace is not None and name:
            self.trace(name, start, n, value)
        return value

    # -- helpers ------------------------------------------------------------

    def bits_remaining(self) -> int:
        return self.end - self.pos

    def byte_pos(self) -> int:
        """Current position in whole bytes (pos must be byte-aligned)."""
        assert (self.pos & 7) == 0, "not byte aligned"
        return self.pos >> 3


class BitWriter:
    """MSB-first bit accumulator."""

    __slots__ = ("_buf", "_cur", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._cur = 0  # bits not yet flushed to _buf, MSB-first in low _nbits
        self._nbits = 0

    def put(self, value: int, n: int) -> None:
        if value < 0 or value >> n:
            raise ValueError(f"value {value} does not fit in {n} bits")
        self._cur = (self._cur << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._cur >> self._nbits) & 0xFF)
        self._cur &= (1 << self._nbits) - 1

    def put_bool(self, value: bool) -> None:
        self.put(int(value), 1)

    def put_su(self, value: int, n: int) -> None:
        """Signed two's-complement in n total bits."""
        lo, hi = -(1 << (n - 1)), (1 << (n - 1)) - 1
        if not (lo <= value <= hi):
            raise ValueError(f"su value {value} out of range for {n} bits")
        self.put(value & ((1 << n) - 1), n)

    def put_leb128(self, value: int, min_bytes: int = 1) -> None:
        """Write leb128; ``min_bytes`` pads with continuation bytes so a
        size can occupy a fixed number of bytes (used by size splicing)."""
        if value < 0 or value >= 1 << 32:
            raise ValueError("leb128 value out of range")
        out = bytearray()
        v = value
        while True:
            byte = v & 0x7F
            v >>= 7
            if v or len(out) + 1 < min_bytes:
                out.append(byte | 0x80)
            else:
                out.append(byte)
                break
        for b in out:
            self.put(b, 8)

    def byte_align(self, bit: int = 0) -> None:
        """Pad with ``bit`` to the next byte boundary."""
        while self._nbits:
            self.put(bit, 1)

    def align_trailing_bits(self) -> None:
        """AV1 trailing_bits(): a 1 bit then zeros to byte alignment.
        If already aligned, emits a full 0x80 byte (spec 5.3.4: trailing
        bits always include the stop bit)."""
        self.put(1, 1)
        self.byte_align(0)

    @property
    def bit_len(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def getvalue(self) -> bytes:
        if self._nbits:
            raise ValueError("writer not byte-aligned; call byte_align()")
        return bytes(self._buf)


def _floor_log2(x: int) -> int:
    return x.bit_length() - 1


def leb128_encode(value: int, min_bytes: int = 1) -> bytes:
    w = BitWriter()
    w.put_leb128(value, min_bytes)
    return w.getvalue()


def leb128_size(value: int) -> int:
    """Number of bytes a minimal leb128 encoding of ``value`` occupies."""
    n = 1
    while value >= 0x80:
        value >>= 7
        n += 1
    return n
