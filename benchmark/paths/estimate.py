"""The estimate path: a grain table from the grainy source alone.

One chroma-aware ``ops.estimate.NoiseEstimator`` at the configuration's
lag takes ``push_batch`` calls of ``batch`` grainy frames ([y, cb, cr]),
cycled from a host pool of ``pool_frames`` as a decoder hands them: the
benchmark's grainy copies of film-like frames. A batch is complete when
``push_batch`` returns: its statistics are downloaded and ingested.
``finish()`` (the fit and its closed-loop calibration) runs once after the
window, untimed. Frame ``n`` of the run, warm-up included, is pool frame
``n % pool_frames``.

The check judges every frame's ``per_frame_sigma`` and the estimator's
summed statistics (before ``finish()``) by their widest relative gap to
the reference's replay of the same frames through the frozen ingest, and
the table ``finish()`` gives against the frozen fit and calibration on the
reference's statistics; a frame handed to the estimator and not ingested
is lost.
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
from checks import chunk_stats, rate, rel_gap, segments_differ  # noqa: E402
from reference import fit, stats  # noqa: E402

GAP_LIMIT = 1e-9  # the widest relative gap of sigmas and sums (PERF.md)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.bd = config["bit_depth"]
        self.lag = config["estimator"]["lag"]
        self.fps = tuple(config["fps"])
        self.batch = traffic["batch"]
        self.pool = traffic["pool_frames"]
        self.shapes = inputs.plane_shapes(config)
        self.spans = yardstick.Spans()
        self.n = 0
        self.attempted = 0
        self.done: List[Tuple[float, float, int]] = []

    def setup(self) -> None:
        from grav1synth_tpu_torch import _build
        from grav1synth_tpu_torch.ops.estimate import NoiseEstimator

        if self.device.type == "cuda":
            _build.load()
        clean = inputs.film_frames(self.seed, self.pool, self.config, self.device)
        self.frames = inputs.to_host(inputs.grainy(self.seed, clean, self.config), self.bd)
        del clean
        self.est = NoiseEstimator(self.fps, self.bd, lag=self.lag, device=self.device)
        for _ in range(self.traffic["warmup_batches"]):
            self.step()
        self.attempted = 0
        self.done.clear()

    def _batch(self, n0: int):
        return [(n0 + k) % self.pool for k in range(self.batch)]

    def step(self) -> None:
        n0 = self.n
        t_hand = time.perf_counter()
        with self.spans.span("estimate.batch", n0):
            self.est.push_batch([self.frames[i] for i in self._batch(n0)])
        self.done.append((t_hand, time.perf_counter(), self.batch))
        self.n += self.batch
        self.attempted += self.batch

    def drain(self) -> None:
        pass

    def end_to_end(self, t0: float) -> dict:
        return {"estimate_fps": rate(self.done, t0)}

    # -- the check ------------------------------------------------------
    def _release(self) -> dict:
        """What the run produced, read once the window has closed, then the
        estimator freed: the sigmas, the summed statistics, the table."""
        state = {"sigma": np.asarray(self.est.per_frame_sigma, np.float64),
                 "sums": chunk_stats(self.est._chunk), "table": self.est.finish()}
        self.est = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return state

    def pool_stats(self, dtype=torch.float64) -> Dict[int, tuple]:
        return {i: stats.self_stats([stats.as_tensor(p, self.device) for p in f], self.lag,
                                    self.bd, dtype)
                for i, f in enumerate(self.frames)}

    def replay(self, per: Dict[int, tuple], table: bool):
        """Every frame handed to the estimator, in order, through the frozen
        ingest: (sigmas, summed statistics, and with ``table`` the fitted
        and calibrated table)."""

        def push(frames, bit_depth, lag):
            return stats.self_stats_frames(frames, bit_depth, lag, self.device)

        ref = fit.NoiseChunk(self.fps, self.bd, 2 * self.lag * (self.lag + 1), push, lag=self.lag)
        if len(self.shapes) == 3:
            ref._sub = tuple(self.config["subsampling"])
        for n in range(self.n):
            ref._ingest(*per[n % self.pool])
        sums = chunk_stats(ref._chunk)
        return (np.asarray(ref.per_frame_sigma, np.float64), sums,
                ref.finish() if table else None)

    def _gaps(self, sigma, sums, want_sigma, want_sums) -> Tuple[float, float]:
        if sigma.shape != want_sigma.shape:
            sigma_gap = float("inf")
        else:
            sigma_gap = rel_gap({"s": sigma}, {"s": want_sigma})
        return sigma_gap, max(rel_gap(sums[p], want_sums[p]) for p in want_sums)

    def check(self) -> Dict[str, tuple]:
        state = self._release()
        self._per = self.pool_stats()
        self._want = self.replay(self._per, table=True)
        sigma_gap, sums_gap = self._gaps(state["sigma"], state["sums"], *self._want[:2])
        return {
            "lost_frames": (self.n - len(state["sigma"]), 0),
            "sigma_gap": (sigma_gap, GAP_LIMIT),
            "sums_gap": (sums_gap, GAP_LIMIT),
            "table_diff": (segments_differ(state["table"], self._want[2]), 0),
        }

    def control(self) -> Dict[str, float]:
        """The gaps with the reference's statistics in float32 in the
        program's place."""
        torch.backends.cuda.matmul.allow_tf32 = False
        sigma, sums, _ = self.replay(self.pool_stats(torch.float32), table=False)
        sigma_gap, sums_gap = self._gaps(sigma, sums, *self._want[:2])
        return {"sigma_gap": sigma_gap, "sums_gap": sums_gap}

    def least_ms(self, n0) -> float:
        moved = ops = fp64 = 0.0
        sample_bytes = 1 if self.bd == 8 else 2
        for i in self._batch(n0):
            m, o, f = yardstick.estimate_frame_work(self._per[i], self.shapes, sample_bytes, self.lag)
            moved += m
            ops += o
            fp64 += f
        return yardstick.least_ms(moved, ops, fp64)
