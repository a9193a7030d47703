"""YUV4MPEG2 (.y4m) writer/reader for the render pipeline's output.

The reference never emits pixels (grain synthesis is delegated to
players, grav1synth src/reader.rs:126-212 only decodes for diff); the
render pipeline is a capability superset, and y4m is the interchange
format every toolchain (FFmpeg, aomenc, dav1d CLI) reads.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_COLORSPACE = {
    # (sub_x, sub_y, bit_depth, monochrome) -> y4m C tag
    (1, 1, 8, False): "420mpeg2",
    (1, 1, 10, False): "420p10",
    (1, 1, 12, False): "420p12",
    (1, 0, 8, False): "422",
    (1, 0, 10, False): "422p10",
    (1, 0, 12, False): "422p12",
    (0, 0, 8, False): "444",
    (0, 0, 10, False): "444p10",
    (0, 0, 12, False): "444p12",
    (1, 1, 8, True): "mono",
    (1, 1, 10, True): "mono10",
    (1, 1, 12, True): "mono12",
}


def _dtype(bit_depth: int):
    return np.uint8 if bit_depth == 8 else np.uint16


class Y4mWriter:
    """Streaming y4m writer; geometry is fixed by the first frame."""

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: Tuple[int, int],
        bit_depth: int = 8,
        subsampling: Tuple[int, int] = (1, 1),
        monochrome: bool = False,
    ):
        self.path = path
        self.bit_depth = bit_depth
        self.monochrome = monochrome
        key = (subsampling[0], subsampling[1], bit_depth, monochrome)
        if monochrome:
            key = (1, 1, bit_depth, True)
        cs = _COLORSPACE.get(key)
        if cs is None:
            raise ValueError(f"unsupported y4m geometry {key}")
        num, den = fps
        if num <= 0 or den <= 0:
            num, den = 25, 1
        self._fh = open(path, "wb")
        self._fh.write(
            f"YUV4MPEG2 W{width} H{height} F{num}:{den} Ip A0:0 C{cs}\n".encode()
        )
        self.frames = 0

    def write_frame(self, planes: List[np.ndarray]) -> None:
        self._fh.write(b"FRAME\n")
        dt = _dtype(self.bit_depth)
        n = 1 if self.monochrome else len(planes)
        for p in planes[:n]:
            arr = np.ascontiguousarray(p.astype(dt, copy=False))
            if self.bit_depth > 8:
                arr = arr.astype("<u2", copy=False)
            self._fh.write(arr.tobytes())
        self.frames += 1

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_y4m(path: str):
    """Read a y4m file -> (frames, fps, bit_depth, subsampling,
    monochrome); frames are per-frame plane lists (test oracle use)."""
    with open(path, "rb") as fh:
        header = fh.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m file")
        w = h = 0
        fps = (25, 1)
        cs = "420mpeg2"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                a, b = tok[1:].split(":")
                fps = (int(a), int(b))
            elif tok[0] == "C":
                cs = tok[1:]
        rev = {v: k for k, v in _COLORSPACE.items()}
        if cs not in rev:
            raise ValueError(f"unsupported y4m colorspace {cs}")
        sub_x, sub_y, bit_depth, mono = rev[cs]
        dt = np.dtype("<u2") if bit_depth > 8 else np.dtype(np.uint8)
        cw = (w + sub_x) >> sub_x
        ch = (h + sub_y) >> sub_y
        frames = []
        while True:
            line = fh.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            planes = []
            sizes = [(h, w)] if mono else [(h, w), (ch, cw), (ch, cw)]
            for ph, pw in sizes:
                raw = fh.read(ph * pw * dt.itemsize)
                planes.append(
                    np.frombuffer(raw, dtype=dt).reshape(ph, pw).astype(
                        np.uint8 if bit_depth == 8 else np.uint16
                    )
                )
            frames.append(planes)
        return frames, fps, bit_depth, (sub_x, sub_y), mono
