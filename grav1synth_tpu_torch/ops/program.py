"""One parameter program per batch on the apply path: the counterpart of
the JAX package's ``jax.jit`` boundary (``grain_jax.apply_grain_batch_pallas``,
``_apply_pallas_luma_only_packed``, ``_apply_pallas_with_patterns``), whose
compiled programs are cached per shape and per value of their static
arguments.

The program takes a batch's one parameter buffer
(``GrainParamsBatch.buffer``) to what the grain kernels read: the luma
and the Cb|Cr per-plane parameter tables, the block offsets, the pattern
rows and the pattern kernel's packed patterns (``program_body``). On a
CUDA device that is two kernel launches: the tables kernel
(``grain_kernels.grain_tables``) and the pattern kernel on its rows.
``GrainProgram`` runs it for one ``ProgramKey``. On a CUDA device it runs
the body once eagerly on a side stream (which builds the kernels and
fills the lazy device cache), then captures it into a
``torch.cuda.CUDAGraph`` of those two kernel nodes; each ``run`` copies
the batch's buffer into the graph's static input and replays the graph on
the current stream. On the CPU ``run`` calls the body eagerly, with the
plain versions of the two kernels, and no graph. A failed capture or
replay raises; nothing falls back to the eager body on the card.

A program is keyed by its batch rounded up to a power of two
(``batch_bucket``), not by the batch itself: a batch of fewer frames
fills the first rows of the static input, and takes the first rows of
the outputs. Every step of the body works frame by frame, so the rows
past the batch (zeros, or an earlier batch's frames) touch nothing of
it. The JAX package's segment bound ``n_seg`` is not in the key: the
body evaluates every curve segment (a LUT node walks all 13), with the
same tables.

The outputs of a replay are the graph's static tensors: the next replay
of the same program overwrites them. A caller consumes them on the stream
that replayed the graph before it runs the program again, and keeps none
of them (``grain.apply_with_tables`` reads them in the grain kernel
right after the replay). A replay on another stream than the last one
first waits for that stream.

The ``utils.spans`` counters ``program.captures`` and ``program.replays``
count captures and replays; each replay also adds the kernel launches
its graph holds to ``launch.<kernel>``. A capture (the eager warm-up
included) is the span ``program.capture``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..utils import spans
from . import grain_kernels as gk
from .grain import PARAMS_WIDTH, GrainParamsBatch

# programs kept per process, least recently used dropped first. One
# geometry at batches of up to 2^k frames makes at most 2 (k + 1) keys
# (k + 1 batch buckets, chroma on or off): 10 at render's batch of 16,
# whatever the stream's tables. The 4K bench stream
# (.bench_cache/bench_4k10_grainy.ivf) makes one.
MAX_PROGRAMS = 16


@dataclass(frozen=True)
class ProgramKey:
    """What a program is specialised on: the JAX package's static
    arguments, the batch's shape and its device."""

    device: torch.device
    batch: int  # batch_bucket of the batches it runs
    height: int
    width: int
    bit_depth: int
    sub_x: int
    sub_y: int
    monochrome: bool
    chroma_static: bool  # the Cb|Cr tables are made (never when monochrome)

    @classmethod
    def of(cls, y: torch.Tensor, bit_depth: int, sub_x: int, sub_y: int, monochrome: bool,
           chroma_static: bool) -> "ProgramKey":
        """The key of a batch of luma planes ``y`` (B, H, W)."""
        b, h, w = y.shape
        return cls(y.device, batch_bucket(b), h, w, bit_depth, sub_x, sub_y, bool(monochrome),
                   bool(chroma_static) and not monochrome)


def batch_bucket(b: int) -> int:
    """The batch a program for batches of ``b`` frames is made at: the
    next power of two."""
    return 1 << max(0, b - 1).bit_length()


@dataclass
class ProgramOutputs:
    params_y: torch.Tensor  # (B, P_LEN) luma rows
    params2: Optional[torch.Tensor]  # (2B, P_LEN) Cb rows, then Cr; None: no chroma kernel
    offsets: torch.Tensor  # (B, S, NB) int32 block-offset randoms
    rows: torch.Tensor  # (B, Q_LEN) pattern rows
    patterns: Optional[torch.Tensor] = None  # (B, n) int16 packed; set by program_body

    def first(self, b: int) -> "ProgramOutputs":
        """The outputs of the first ``b`` frames: views of the same tensors,
        but the Cb|Cr rows, which are copied together unless ``b`` is the
        whole batch."""
        n = self.params_y.shape[0]
        if b == n:
            return self

        def rows_of(t):
            return None if t is None else t[:b]

        params2 = self.params2
        if params2 is not None:
            params2 = torch.cat([params2[:b], params2[n : n + b]])
        return ProgramOutputs(rows_of(self.params_y), params2, rows_of(self.offsets),
                              rows_of(self.rows), rows_of(self.patterns))


def _table_args(key: ProgramKey) -> Tuple[int, int, int, bool]:
    return key.height, key.width, key.bit_depth, key.chroma_static and not key.monochrome


def program_tables(p: GrainParamsBatch, key: ProgramKey) -> ProgramOutputs:
    """Everything of the program but the pattern kernel's launch, from
    ``p``'s tensors by PyTorch ops (``grain_kernels.grain_tables_reference``):
    nothing made from host data, nothing read back. The tables kernel's
    plain version."""
    return ProgramOutputs(*gk.grain_tables_reference(p.buffer, *_table_args(key)))


def program_body(buf: torch.Tensor, key: ProgramKey) -> ProgramOutputs:
    """The whole program on the (B, PARAMS_WIDTH) parameter buffer
    ``buf``, eagerly: on a CUDA device the tables kernel, then the pattern
    kernel on its rows; on the CPU their plain versions."""
    out = ProgramOutputs(*gk.grain_tables(buf, *_table_args(key)))
    layout = (key.bit_depth, key.sub_x, key.sub_y, key.monochrome)
    out.patterns = (gk.pattern_kernel(out.rows, *layout) if buf.is_cuda
                    else gk.generate_patterns_packed_reference(GrainParamsBatch(buf), *layout))
    return out


class GrainProgram:
    """The parameter program of one ``ProgramKey``: a captured CUDA graph
    on a CUDA device (captured on the first ``run``), the eager body on the
    CPU."""

    def __init__(self, key: ProgramKey):
        if key.device.type not in ("cpu", "cuda"):
            raise ValueError(f"a parameter program runs on a CUDA device or the CPU, not {key.device}")
        self.key = key
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Optional[torch.Tensor] = None
        self.outputs: Optional[ProgramOutputs] = None
        self.kernels: Dict[str, int] = {}  # kernel launches the graph holds
        self._stream: Optional[torch.cuda.Stream] = None  # the last replay's

    def run(self, p: GrainParamsBatch) -> ProgramOutputs:
        """The program's outputs for the batch ``p``: on a CUDA device the
        first rows of the graph's static outputs after a replay (see the
        module's note on their lifetime), on the CPU new tensors."""
        key = self.key
        buf = p.buffer
        b = buf.shape[0]
        if batch_bucket(b) != key.batch or buf.device != key.device:
            raise ValueError(
                f"a batch of {b} frames on {buf.device} does not fit the program of "
                f"{key.batch} frames on {key.device}"
            )
        if key.device.type == "cpu":
            return program_body(buf, key)
        if self.graph is None:
            self._capture()
        stream = torch.cuda.current_stream(key.device)
        if self._stream is not None and self._stream != stream:
            stream.wait_stream(self._stream)
        self._stream = stream
        self.static_in[:b].copy_(buf, non_blocking=True)
        self.graph.replay()
        spans.count("program.replays")
        for name, n in self.kernels.items():
            spans.count("launch." + name, n)
        return self.outputs.first(b)

    def _capture(self) -> None:
        dev = self.key.device
        with spans.span("program.capture"), torch.cuda.device(dev):
            self.static_in = torch.zeros((self.key.batch, PARAMS_WIDTH), dtype=torch.int32,
                                         device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # builds the kernels and fills the lazy cache (the
                # Gaussian table) before the capture
                program_body(self.static_in, self.key)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            recorded = spans.counters("recorded.")
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self.outputs = program_body(self.static_in, self.key)
            graph.instantiate()
        after = spans.counters("recorded.")
        self.kernels = {k: n - recorded.get(k, 0) for k, n in after.items() if n > recorded.get(k, 0)}
        self.graph = graph
        spans.count("program.captures")


_PROGRAMS: "OrderedDict[ProgramKey, GrainProgram]" = OrderedDict()
# dropped programs whose last replay's stream had work queued, each with
# an event recorded after that work; freed once it has passed
_RETIRED: List[Tuple[torch.cuda.Event, GrainProgram]] = []


def _retire(prog: GrainProgram) -> None:
    """Keep ``prog`` until the work queued so far on its last replay's
    stream has run: its outputs' readers run on that stream."""
    if prog._stream is not None:
        done = torch.cuda.Event()
        done.record(prog._stream)
        _RETIRED.append((done, prog))


def program_for(key: ProgramKey) -> GrainProgram:
    """The cached program of ``key`` (made, not yet captured, on a miss).
    Beyond ``MAX_PROGRAMS`` the least recently used is dropped; its graph
    and outputs are freed once its stream has passed them, without waiting
    for the device."""
    _RETIRED[:] = [(done, prog) for done, prog in _RETIRED if not done.query()]
    prog = _PROGRAMS.pop(key, None)
    if prog is None:
        prog = GrainProgram(key)
        while len(_PROGRAMS) >= MAX_PROGRAMS:
            _retire(_PROGRAMS.popitem(last=False)[1])
    _PROGRAMS[key] = prog
    return prog


def clear_programs() -> None:
    """Drop every cached program, waiting until their streams have passed
    them."""
    for prog in _PROGRAMS.values():
        _retire(prog)
    _PROGRAMS.clear()
    for done, _ in _RETIRED:
        done.synchronize()
    _RETIRED.clear()
