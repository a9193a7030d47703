"""The apply path: film grain on batches of frames, as ``render`` runs it.

The mix's ``frames_on`` says where a batch's frames start:

- ``host``: as ``render`` gets them from its decoder (per-frame uint16 or
  uint8 planes, cycled from a pool of ``pool_frames``). A batch is
  ``pipelines._upload`` a plane, ``ops.grain.pack_params``,
  ``ops.grain.apply_grain`` with patterns made on the card, then
  ``pipelines._start_download`` and an event; the oldest batch past
  ``in_flight`` is waited for and read with ``pipelines._as_mux``
  (render's FIFO). A batch is complete when its planes are host arrays in
  the mux dtype. No decode and no y4m write.
- ``device``: frames already on the card, a pool of ``pool_frames`` int16
  frames; outputs stay on the card. A batch is ``pack_params`` and
  ``apply_grain``, then an event; it is complete when its event has
  passed, waited for once ``in_flight`` batches are behind the one just
  issued.

Frame ``n`` of the run is pool frame ``n % pool_frames`` under table
``n % table_pool``; the warm-up batches come first. The check judges a
sample of the window's frames, drawn from the seed (a reservoir of
``sample_batches`` batches, one frame of each, copied when drawn, and the
last frame of the last batch), against the frozen ``grain_ref``, sample
by sample.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import inputs  # noqa: E402
import yardstick  # noqa: E402
from checks import Reservoir, rate  # noqa: E402
from reference import grain_ref  # noqa: E402
from reference.types import FilmGrainParams as RefParams  # noqa: E402


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.bd = config["bit_depth"]
        self.mono = config["planes"] == 1
        self.sub_x, self.sub_y = (0, 0) if self.mono else config["subsampling"]
        self.batch = traffic["batch"]
        self.pool = traffic["pool_frames"]
        self.table_pool = traffic["table_pool"]
        self.in_flight = traffic["in_flight"]
        self.on_host = traffic["frames_on"] == "host"
        self.shapes = inputs.plane_shapes(config)
        self.tables = inputs.draw_tables(seed, dict(config["grain"], **traffic.get("grain", {})),
                                         self.table_pool)
        self.spans = yardstick.Spans()
        self.n = 0  # frames handed so far, warm-up included
        self.attempted = 0
        self.done: List[Tuple[float, float, int]] = []  # (handed, complete, frames)
        self.pending: list = []
        # first frame of a sampled batch -> (the drawn frame, its output planes)
        self.sample = Reservoir(traffic["sample_batches"], seed)
        self._last = None

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from grav1synth_tpu_torch import _build, pipelines
        from grav1synth_tpu_torch.obu.types import FilmGrainParams
        from grav1synth_tpu_torch.ops import grain

        self.pipelines, self.grain = pipelines, grain
        if self.device.type == "cuda":
            _build.load()
        frames = inputs.film_frames(self.seed, self.pool, self.config, self.device)
        if self.on_host:
            self.frames = inputs.to_host(frames, self.bd)
            del frames
        else:
            self.frames = frames
        # the port's own parameter type, built from the benchmark's draw
        self.params = [FilmGrainParams(**t) for t in self.tables]
        for _ in range(self.traffic["warmup_batches"]):
            self.step()
        self.drain()
        # the warm-up's batches are not the window's
        self.attempted, self._last = 0, None
        self.sample = Reservoir(self.traffic["sample_batches"], self.seed)
        self.done.clear()

    # -- the window -----------------------------------------------------
    def step(self) -> None:
        g, pl = self.grain, self.pipelines
        n0, b = self.n, self.batch
        idx = [(n0 + k) % self.pool for k in range(b)]
        params = [self.params[(n0 + k) % self.table_pool] for k in range(b)]
        t_hand = time.perf_counter()
        if self.on_host:
            with self.spans.span("apply.upload"):
                planes = [pl._upload([self.frames[i][k] for i in idx], self.device)
                          for k in range(len(self.shapes))]
        else:
            planes = [self._device_batch(p, idx) for p in self.frames]
        y, cb, cr = planes if not self.mono else (planes[0], None, None)
        with self.spans.span("apply.issue", (n0, b)):
            out = g.apply_grain(y, cb, cr, g.pack_params(params, self.device), self.bd,
                                self.sub_x, self.sub_y, self.mono)
        # a plane the tables leave untouched comes back as the input, and
        # stays the decoder's (None here), as in render
        out = [None if o is src else o for o, src in zip(out, planes)]
        if self.on_host:
            with self.spans.span("apply.download"):
                out = [None if o is None else pl._start_download(o, self.bd) for o in out]
        done = torch.cuda.Event() if self.device.type == "cuda" else None
        if done is not None:
            done.record()
        self.pending.append((n0, b, t_hand, out, done))
        self.n += b
        self.attempted += b
        while len(self.pending) > self.in_flight:
            self._complete()

    def _device_batch(self, pool: torch.Tensor, idx: List[int]) -> torch.Tensor:
        """The batch's frames of a device pool: a view where they are
        consecutive (a pool of whole batches), else a gather."""
        if idx[-1] - idx[0] == len(idx) - 1:
            return pool[idx[0] : idx[-1] + 1]
        return pool[torch.tensor(idx, device=pool.device)]

    def _complete(self) -> None:
        n0, b, t_hand, out, done = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        if self.on_host:
            out = [None if o is None else self.pipelines._as_mux(o, self.bd) for o in out]
        self.done.append((t_hand, time.perf_counter(), b))
        self._keep(n0, b, out)

    def _keep(self, n0: int, b: int, out) -> None:
        """The sample: a reservoir of the window's batches, one frame of
        each drawn and copied when the batch is kept; and the last batch's
        last frame."""
        self._last = (n0 + b - 1, [None if o is None else o[b - 1] for o in out])

        def one():
            f = self.sample.rng.randrange(b)
            return f, [None if o is None else o[f].copy() if isinstance(o, np.ndarray)
                       else o[f].clone() for o in out]

        self.sample.offer(n0, one)

    def drain(self) -> None:
        while self.pending:
            self._complete()

    def end_to_end(self, t0: float) -> dict:
        return {"apply_fps": rate(self.done, t0)}

    # -- the check ------------------------------------------------------
    def _judged(self) -> Dict[int, List[np.ndarray]]:
        """The sampled outputs, on the host, by frame number."""
        judged = {n0 + f: planes for n0, (f, planes) in self.sample.items.items()}
        if self._last is not None:
            judged[self._last[0]] = self._last[1]
        return {n: [o.cpu().numpy() if isinstance(o, torch.Tensor) else o for o in planes]
                for n, planes in judged.items()}

    def _input(self, n: int) -> List[np.ndarray]:
        i = n % self.pool
        if self.on_host:
            return [np.asarray(p) for p in self.frames[i]]
        return [p[i].cpu().numpy() for p in self.frames]

    def _release(self) -> Tuple[Dict[int, List[np.ndarray]], Dict[int, List[np.ndarray]]]:
        """The judged outputs and their inputs on the host; the program's
        state and the device pools freed."""
        judged = self._judged()
        ins = {n: self._input(n) for n in judged}
        judged = {n: [ins[n][k] if o is None else o for k, o in enumerate(planes)]
                  for n, planes in judged.items()}
        self.frames = self.pending = self.sample = self._last = None
        if self.device.type == "cuda":
            from grav1synth_tpu_torch.ops import program

            program.clear_programs()
            torch.cuda.empty_cache()
        return judged, ins

    def _reference(self, planes, n: int, bit_depth: int) -> List[np.ndarray]:
        p = RefParams(**self.tables[n % self.table_pool])
        return grain_ref.apply_grain_frame([a.astype(np.int32) for a in planes], p, bit_depth,
                                           self.sub_x, self.sub_y)

    def _wrong(self, got: Dict[int, list], want: Dict[int, list]) -> int:
        wrong = 0
        for n, planes in want.items():
            for a, b in zip(got[n], planes):
                wrong += int(np.count_nonzero(a.astype(np.int32) != b.astype(np.int32)))
        return wrong

    def check(self) -> Dict[str, tuple]:
        """Samples of the judged frames that differ from the reference's
        (limit 0: the grain is integer arithmetic, exact against dav1d)."""
        got, ins = self._release()
        self._ins = ins
        want = {n: self._reference(ins[n], n, self.bd) for n in got}
        self._want = want
        self._got_frames = sorted(got)
        return {"wrong_samples": (self._wrong(got, want), 0)}

    def control(self) -> Dict[str, float]:
        """The check's numbers with the reference in the program's place,
        one precision down: above 8 bits the grain of each sample's top 8
        bits, scaled back up; at 8 bits the grain of 7-bit samples (the
        lowest bit dropped)."""
        ctl = {}
        for n in self._got_frames:
            ins = [a.astype(np.int32) for a in self._ins[n]]
            if self.bd > 8:
                out = self._reference([a >> (self.bd - 8) for a in ins], n, 8)
                ctl[n] = [o.astype(np.int32) << (self.bd - 8) for o in out]
            else:
                ctl[n] = self._reference([a >> 1 << 1 for a in ins], n, 8)
        return {"wrong_samples": float(self._wrong(ctl, self._want))}

    # -- the yardstick --------------------------------------------------
    def least_ms(self, work) -> float:
        n0, b = work
        moved = ops = 0.0
        for k in range(b):
            t = self.tables[(n0 + k) % self.table_pool]
            m, o = yardstick.apply_frame_work(t, self.shapes, self.sub_x, self.sub_y)
            moved += m
            ops += o
        return yardstick.least_ms(moved, ops)
