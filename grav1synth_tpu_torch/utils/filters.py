"""Source preprocessing filters for the diff pipeline: crop + resize.

Parity with the reference FilterChain (grav1synth src/filters.rs:11-181
over the video-resize crate): the same string DSL
``"crop:top=42,bottom=0;resize:width=1920,height=1080,alg=lanczos"``
and the same five separable resize kernels (hermite, catmullrom
[default], mitchell, lanczos3, spline36), applied per plane with
edge-clamped taps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


def _hermite(x: float) -> float:
    x = abs(x)
    return (2 * x - 3) * x * x + 1 if x < 1 else 0.0


def _bc_spline(b: float, c: float):
    def f(x: float) -> float:
        x = abs(x)
        if x < 1:
            return (
                (12 - 9 * b - 6 * c) * x**3
                + (-18 + 12 * b + 6 * c) * x**2
                + (6 - 2 * b)
            ) / 6
        if x < 2:
            return (
                (-b - 6 * c) * x**3
                + (6 * b + 30 * c) * x**2
                + (-12 * b - 48 * c) * x
                + (8 * b + 24 * c)
            ) / 6
        return 0.0

    return f


def _sinc(x: float) -> float:
    return 1.0 if x == 0 else math.sin(math.pi * x) / (math.pi * x)


def _lanczos3(x: float) -> float:
    x = abs(x)
    return _sinc(x) * _sinc(x / 3) if x < 3 else 0.0


def _spline36(x: float) -> float:
    x = abs(x)
    if x < 1:
        return ((13 / 11 * x - 453 / 209) * x - 3 / 209) * x + 1
    if x < 2:
        x -= 1
        return ((-6 / 11 * x + 270 / 209) * x - 156 / 209) * x
    if x < 3:
        x -= 2
        return ((1 / 11 * x - 45 / 209) * x + 26 / 209) * x
    return 0.0


KERNELS = {
    "hermite": (_hermite, 1.0),
    "catmullrom": (_bc_spline(0.0, 0.5), 2.0),
    "mitchell": (_bc_spline(1 / 3, 1 / 3), 2.0),
    "lanczos": (_lanczos3, 3.0),
    "lanczos3": (_lanczos3, 3.0),
    "spline36": (_spline36, 3.0),
}


def _resample_axis(plane: np.ndarray, out_len: int, axis: int, kernel, support):
    in_len = plane.shape[axis]
    if in_len == out_len:
        return plane
    scale = in_len / out_len
    filt_scale = max(scale, 1.0)
    weights = []
    indices = []
    taps = int(math.ceil(support * filt_scale)) * 2
    for o in range(out_len):
        center = (o + 0.5) * scale - 0.5
        left = int(math.floor(center)) - taps // 2 + 1
        idx = np.clip(np.arange(left, left + taps), 0, in_len - 1)
        w = np.asarray([kernel((center - j) / filt_scale) for j in range(left, left + taps)])
        s = w.sum()
        weights.append(w / s if s != 0 else w)
        indices.append(idx)
    weights = np.stack(weights)  # (out, taps)
    indices = np.stack(indices)
    moved = np.moveaxis(plane, axis, 0).astype(np.float64)
    gathered = moved[indices]  # (out, taps, ...)
    res = np.einsum("ot,ot...->o...", weights, gathered)
    return np.moveaxis(res, 0, axis)


@dataclass
class CropFilter:
    top: int = 0
    bottom: int = 0
    left: int = 0
    right: int = 0

    def apply(self, planes: List[np.ndarray], bit_depth: int) -> List[np.ndarray]:
        out = []
        for i, pl in enumerate(planes):
            # chroma planes crop at half rate for 4:2:0
            sub = 1 if i > 0 and pl.shape[0] < planes[0].shape[0] else 0
            t, b = self.top >> sub, self.bottom >> sub
            l, r = self.left >> sub, self.right >> sub
            h, w = pl.shape
            out.append(pl[t : h - b if b else h, l : w - r if r else w])
        return out


@dataclass
class ResizeFilter:
    width: int
    height: int
    alg: str = "catmullrom"

    def apply(self, planes: List[np.ndarray], bit_depth: int) -> List[np.ndarray]:
        kernel, support = KERNELS[self.alg]
        maxval = (1 << bit_depth) - 1
        out = []
        for i, pl in enumerate(planes):
            sub = 1 if i > 0 and pl.shape[0] < planes[0].shape[0] else 0
            tw, th = self.width >> sub, self.height >> sub
            r = _resample_axis(pl, th, 0, kernel, support)
            r = _resample_axis(r, tw, 1, kernel, support)
            out.append(np.clip(np.rint(r), 0, maxval).astype(pl.dtype))
        return out


@dataclass
class FilterChain:
    filters: List = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FilterChain":
        """Parse the DSL: ';'-separated filters, ','-separated key=value
        options (reference filters.rs:16-110)."""
        chain = cls()
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                name, optstr = part.split(":", 1)
            else:
                name, optstr = part, ""
            opts = {}
            for kv in optstr.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, v = kv.split("=", 1)
                opts[k.strip()] = v.strip()
            name = name.strip().lower()
            if name == "crop":
                chain.filters.append(
                    CropFilter(
                        top=int(opts.get("top", 0)),
                        bottom=int(opts.get("bottom", 0)),
                        left=int(opts.get("left", 0)),
                        right=int(opts.get("right", 0)),
                    )
                )
            elif name == "resize":
                alg = opts.get("alg", "catmullrom").lower()
                if alg not in KERNELS:
                    raise ValueError(f"unknown resize algorithm {alg!r}")
                chain.filters.append(
                    ResizeFilter(
                        width=int(opts["width"]),
                        height=int(opts["height"]),
                        alg=alg,
                    )
                )
            else:
                raise ValueError(f"unknown filter {name!r}")
        return chain

    def apply(self, planes: Sequence[np.ndarray], bit_depth: int) -> List[np.ndarray]:
        out = list(planes)
        for f in self.filters:
            out = f.apply(out, bit_depth)
        return out
