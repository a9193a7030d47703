"""IVF container read/write (pure host code).

IVF is the trivial packet container used by the AV1 conformance corpora
(dav1d-test-data) and by aomenc/dav1d tooling. Covering it natively
removes the FFmpeg dependency from the core bitstream paths; MKV/MP4 go
through the libavformat shim (container/ffshim.py).

Layout: 32-byte file header ("DKIF", version, header size, fourcc,
width, height, timebase denominator, timebase numerator, frame count),
then per frame a 12-byte header (payload size, 8-byte pts) + payload.
Timestamps are pts * timebase_num / timebase_den seconds (matching
libavformat's ivfdec interpretation).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple

IVF_MAGIC = b"DKIF"
AV1_FOURCC = b"AV01"


@dataclass
class IvfHeader:
    fourcc: bytes = AV1_FOURCC
    width: int = 0
    height: int = 0
    timebase_den: int = 30  # "frame rate" field
    timebase_num: int = 1  # "time scale" field
    frame_count: int = 0

    @property
    def time_base(self) -> Tuple[int, int]:
        """(num, den): seconds per pts tick."""
        return (self.timebase_num, self.timebase_den)


@dataclass
class IvfPacket:
    pts: int
    data: bytes


class IvfReader:
    def __init__(self, fh: BinaryIO):
        self._fh = fh
        raw = fh.read(32)
        if len(raw) < 32 or raw[:4] != IVF_MAGIC:
            raise ValueError("not an IVF file")
        (
            version,
            header_size,
            fourcc,
            width,
            height,
            tb_den,
            tb_num,
            frame_count,
        ) = struct.unpack("<HH4sHHIII4x", raw[4:32])
        if version != 0:
            raise ValueError(f"unsupported IVF version {version}")
        if header_size > 32:
            fh.read(header_size - 32)
        self.header = IvfHeader(fourcc, width, height, tb_den, tb_num, frame_count)

    def __iter__(self) -> Iterator[IvfPacket]:
        while True:
            hdr = self._fh.read(12)
            if len(hdr) < 12:
                return
            size, pts = struct.unpack("<Iq", hdr)
            data = self._fh.read(size)
            if len(data) < size:
                raise ValueError("truncated IVF frame")
            yield IvfPacket(pts, data)

    @classmethod
    def open(cls, path: str) -> "IvfReader":
        return cls(open(path, "rb"))


class IvfWriter:
    def __init__(self, fh: BinaryIO, header: IvfHeader):
        self._fh = fh
        self.header = header
        self._count = 0
        self._write_header(header.frame_count)

    def _write_header(self, frame_count: int) -> None:
        self._fh.write(IVF_MAGIC)
        self._fh.write(
            struct.pack(
                "<HH4sHHIII4x",
                0,
                32,
                self.header.fourcc,
                self.header.width,
                self.header.height,
                self.header.timebase_den,
                self.header.timebase_num,
                frame_count,
            )
        )

    def write_packet(self, packet: IvfPacket) -> None:
        self._fh.write(struct.pack("<Iq", len(packet.data), packet.pts))
        self._fh.write(packet.data)
        self._count += 1

    def finalize(self) -> None:
        """Backpatch the frame count and flush."""
        if self._fh.seekable():
            pos = self._fh.tell()
            self._fh.seek(24)
            self._fh.write(struct.pack("<I", self._count))
            self._fh.seek(pos)
        self._fh.flush()

    @classmethod
    def create(cls, path: str, header: IvfHeader) -> "IvfWriter":
        return cls(open(path, "wb"), header)


def read_ivf(path: str) -> Tuple[IvfHeader, List[IvfPacket]]:
    with open(path, "rb") as fh:
        r = IvfReader(fh)
        return r.header, list(r)


def write_ivf(path: str, header: IvfHeader, packets: List[IvfPacket]) -> None:
    with open(path, "wb") as fh:
        w = IvfWriter(fh, header)
        for p in packets:
            w.write_packet(p)
        w.finalize()


def scan_complete_packets(path: str) -> Tuple[IvfHeader, int, int]:
    """Count whole packets in a (possibly truncated) IVF file.

    Returns (header, n_complete, byte_offset_after_last_complete) —
    the restart point for resumable writers."""
    with open(path, "rb") as fh:
        r = IvfReader(fh)
        count = 0
        offset = fh.tell()
        while True:
            hdr = fh.read(12)
            if len(hdr) < 12:
                break
            size, _ = struct.unpack("<Iq", hdr)
            data = fh.read(size)
            if len(data) < size:
                break
            count += 1
            offset = fh.tell()
        return r.header, count, offset


class IvfAppender:
    """Append packets to an existing IVF after a clean restart point."""

    def __init__(self, path: str, offset: int, existing: int):
        self._fh = open(path, "r+b")
        self._fh.seek(offset)
        self._fh.truncate()
        self._count = existing

    def write_packet(self, packet: IvfPacket) -> None:
        self._fh.write(struct.pack("<Iq", len(packet.data), packet.pts))
        self._fh.write(packet.data)
        self._count += 1

    def finalize(self) -> None:
        pos = self._fh.tell()
        self._fh.seek(24)
        self._fh.write(struct.pack("<I", self._count))
        self._fh.seek(pos)
        self._fh.flush()
        self._fh.close()
