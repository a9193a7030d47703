"""Terminal progress reporting (fps + ETA bar, spinner fallback).

Parity with the reference's indicatif usage (grav1synth
src/main.rs:54-131): bar with fps/ETA when the total is known, spinner
otherwise, hidden when stderr is not a TTY.
"""

from __future__ import annotations

import sys
import time
from typing import Optional


class Progress:
    def __init__(
        self,
        total: Optional[int] = None,
        enabled: bool = True,
        unit: str = "it",
        out=None,
    ):
        self._out = out if out is not None else sys.stderr
        self.enabled = enabled and self._out.isatty()
        self.total = total
        self.unit = unit
        self.count = 0
        self._t0 = time.monotonic()
        self._last_draw = 0.0
        self._spinner = "|/-\\"

    def step(self, n: int = 1) -> None:
        self.count += n
        if not self.enabled:
            return
        now = time.monotonic()
        if now - self._last_draw < 0.1:
            return
        self._last_draw = now
        elapsed = max(now - self._t0, 1e-6)
        fps = self.count / elapsed
        if self.total:
            frac = min(self.count / self.total, 1.0)
            width = 30
            filled = int(frac * width)
            eta = (self.total - self.count) / fps if fps > 0 else 0
            self._out.write(
                f"\r[{'#' * filled}{'-' * (width - filled)}] "
                f"{self.count}/{self.total} {self.unit} "
                f"{fps:6.1f} {self.unit}/s eta {eta:5.1f}s"
            )
        else:
            spin = self._spinner[(self.count // 10) % 4]
            self._out.write(
                f"\r{spin} {self.count} {self.unit} {fps:6.1f} {self.unit}/s"
            )
        self._out.flush()

    def done(self) -> None:
        if self.enabled and self.count:
            self._out.write("\n")
            self._out.flush()
