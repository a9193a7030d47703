"""Spans and counters: where the port's time goes, and what it launched.

The port's one performance-tracing system (``utils.trace`` traces
bitstream syntax elements, a user feature, not time).

``span(name)`` is a context manager around one step of a layer, named
``<layer>.<step>`` (``upload.stack``, ``grain.pack``, ``program.replay``,
``estimate.ingest``, ...). It has three modes:

- off, the default: one test, and the shared no-op object comes back;
- while a torch profiler records: a ``torch.profiler.record_function``
  range, so the span lands in the profiler's trace beside the device
  events, on their clock;
- while the ``spans`` logger is enabled at DEBUG (``GRAV1_LOG=spans=debug``
  on the command line): each span's count, total, self and longest time
  summed in memory per name (``time.perf_counter_ns``). Spans nest: a
  span's parent is the span open around it on its thread, and its self
  time is its time less the time of its children. ``log_summary`` logs
  the sums as one table, as ``pipelines.render``, ``diff`` and
  ``estimate`` do once at their end.

``count(name, n)`` adds to an integer counter; counters are always on:

- ``launch.<kernel>``: launches of a kernel wrapper's CUDA kernel (a
  graph replay adds the launches its graph holds); the chroma-pair and
  fused kernels' also by layout, ``launch.grain_chroma_pair.<sub_x><sub_y>``
  and ``launch.grain_fused.<sub_x><sub_y>`` (``.10`` for 4:2:2);
- ``recorded.<kernel>``: launches recorded into a CUDA graph under
  capture, which launch nothing then;
- ``program.captures``, ``program.replays``: the apply's parameter
  programs (``ops.program``);
- ``upload.frames``: frames staged by ``pipelines._upload``, once a
  plane (a three-plane batch of 16 adds 48);
- ``pack.frames``, ``pack.rows``: frames packed by ``ops.grain.pack_params``
  and the parameter rows it built for them, one a run of frames whose
  tables are equal but for the seed.

``snapshot`` returns both, ``reset`` clears both.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

log = logging.getLogger("spans")

_profiling = torch._C._autograd._profiler_enabled
_DEBUG = logging.DEBUG

_COUNTERS: Dict[str, int] = defaultdict(int)
# name -> [count, total ns, self ns, max ns]
_SUMS: Dict[str, List[int]] = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return None


_OFF = _Off()


def _open_spans() -> list:
    """The aggregated spans open on this thread, innermost last."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "range", "summed", "t0", "child_ns")

    def __init__(self, name: str, profiled: bool, summed: bool):
        self.name = name
        self.range = torch.profiler.record_function(name) if profiled else None
        self.summed = summed

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.summed:
            _open_spans().append(self)
            self.child_ns = 0
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.summed:
            dt = time.perf_counter_ns() - self.t0
            stack = _open_spans()
            stack.pop()
            if stack:
                stack[-1].child_ns += dt
            with _LOCK:
                s = _SUMS.get(self.name)
                if s is None:
                    s = _SUMS[self.name] = [0, 0, 0, 0]
                s[0] += 1
                s[1] += dt
                s[2] += dt - self.child_ns
                s[3] = max(s[3], dt)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` (see the module's note on its modes)."""
    profiled = _profiling()
    summed = log.isEnabledFor(_DEBUG)
    if not (profiled or summed):
        return _OFF
    return _Span(name, profiled, summed)


def count(name: str, n: int = 1) -> None:
    _COUNTERS[name] += n


def counter(name: str) -> int:
    return _COUNTERS.get(name, 0)


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``, by the rest of
    their names."""
    return {k[len(prefix):]: v for k, v in _COUNTERS.items() if k.startswith(prefix)}


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_ms", "self_ms", "max_ms"}},
    "counters": {name: n}}."""
    with _LOCK:
        sums = {k: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6, "max_ms": m / 1e6}
                for k, (c, t, s, m) in _SUMS.items()}
    return {"spans": sums, "counters": dict(_COUNTERS)}


def reset() -> None:
    with _LOCK:
        _SUMS.clear()
    _COUNTERS.clear()


def log_summary() -> Optional[str]:
    """Log the spans, longest total first, and the counters as one table at
    DEBUG when the ``spans`` logger is on; returns the table, or None when
    it is off."""
    if not log.isEnabledFor(_DEBUG):
        return None
    snap = snapshot()
    lines = [f"{'span':<20} {'count':>8} {'total ms':>12} {'self ms':>12} {'mean ms':>10} "
             f"{'max ms':>10}"]
    for name, s in sorted(snap["spans"].items(), key=lambda kv: -kv[1]["total_ms"]):
        lines.append(f"{name:<20} {s['count']:>8} {s['total_ms']:>12.3f} {s['self_ms']:>12.3f} "
                     f"{s['total_ms'] / s['count']:>10.4f} {s['max_ms']:>10.4f}")
    if snap["counters"]:
        lines.append(f"{'counter':<20} {'count':>8}")
        lines += [f"{k:<20} {v:>8}" for k, v in sorted(snap["counters"].items())]
    table = "\n".join(lines)
    log.debug("spans and counters of this process:\n%s", table)
    return table
