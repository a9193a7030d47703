"""Container/codec I/O: pure IVF plus the libav* native shim."""

from .ivf import IvfHeader, IvfPacket, IvfReader, IvfWriter, read_ivf, write_ivf

__all__ = [
    "IvfHeader",
    "IvfPacket",
    "IvfReader",
    "IvfWriter",
    "read_ivf",
    "write_ivf",
]
