"""The diff path: a grain table from a grainy source and its denoised copy.

One ``ops.diff_estimate.DiffEstimator`` at the configuration's lag takes
``diff_batch`` calls of ``batch`` frame pairs (all three planes), cycled
from a host pool of ``pool_frames`` pairs as a decoder hands them: the
source is the benchmark's grainy copy of a film-like frame, the denoised
plane that frame. A batch is complete when ``diff_batch`` returns: its
statistics are downloaded and ingested. ``finish()`` runs once after the
window, untimed. Frame ``n`` of the run, warm-up included, is pool pair
``n % pool_frames``.

The check judges the per-frame statistics the estimator ingested for a
sample of the window's batches, drawn from the seed (a reservoir of
``sample_batches``), by their widest relative gap to the reference's, and
the table ``finish()`` gives against the reference's replay of every
frame through the frozen chunking and fit; a frame that was handed to
the estimator and not ingested is lost.
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
from checks import Reservoir, rate, rel_gap, segments_differ  # noqa: E402
import yardstick  # noqa: E402
from reference import fit, stats  # noqa: E402

STATS_LIMIT = 1e-9  # the widest relative gap of the statistics (PERF.md)


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
        # first frame of a sampled batch -> the (y, cb, cr) statistics ingested
        self.sample = Reservoir(traffic["sample_batches"], seed)
        self._window = False

    def setup(self) -> None:
        from grav1synth_tpu_torch import _build
        from grav1synth_tpu_torch.ops.diff_estimate import DiffEstimator

        if self.device.type == "cuda":
            _build.load()
        self.frames = self.make_frames()
        self.est = DiffEstimator(self.fps, self.bd, self.bd, lag=self.lag, device=self.device)
        add = self.est._add_frames

        def ingest(y_st, cb_st=None, cr_st=None):
            # what the window's batch produced, kept by reference
            if self._window:
                self.sample.offer(self._batch_n0, lambda: (y_st, cb_st, cr_st))
            add(y_st, cb_st, cr_st)

        self.est._add_frames = ingest
        for _ in range(self.traffic["warmup_batches"]):
            self.step()
        self.attempted = 0
        self.done.clear()
        self._window = True

    def make_frames(self):
        clean = inputs.film_frames(self.seed, self.pool, self.config, self.device)
        src = inputs.grainy(self.seed, clean, self.config)
        return inputs.to_host(src, self.bd), inputs.to_host(clean, self.bd)

    def _batch(self, n0: int):
        return [(n0 + k) % self.pool for k in range(self.batch)]

    def step(self) -> None:
        src, den = self.frames
        n0 = self.n
        idx = self._batch(n0)
        self._batch_n0 = n0
        t_hand = time.perf_counter()
        with self.spans.span("diff.batch", n0):
            self.est.diff_batch([src[i] for i in idx], [den[i] for i in idx])
        self.done.append((t_hand, time.perf_counter(), self.batch))
        self.n += self.batch
        self.attempted += self.batch

    def drain(self) -> None:
        pass

    def end_to_end(self, t0: float) -> dict:
        return {"diff_fps": rate(self.done, t0)}

    # -- the check ------------------------------------------------------
    def program_state(self):
        """What the run produced, read once the window has closed: the
        table ``finish()`` gives and the frames the estimator ingested."""
        return {"table": self.est.finish(), "ingested": self.est._frame_idx}

    def _release(self):
        state = self.program_state()
        self.est = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return state

    def pool_stats(self, dtype=torch.float64, which=None) -> Dict[int, tuple]:
        """The reference's statistics of each pool pair (or those in
        ``which``)."""
        src, den = self.frames
        out = {}
        for i in (range(self.pool) if which is None else which):
            out[i] = stats.pair_stats([stats.as_tensor(p, self.device) for p in src[i]],
                                      [stats.as_tensor(p, self.device) for p in den[i]],
                                      self.lag, self.bd, dtype)
        return out

    def replay(self, per: Dict[int, tuple]):
        """The reference table: every frame handed to the estimator, in
        order, through the frozen chunking and fit (a fit memoised on its
        chunk's sums: the pool repeats)."""
        chunks = fit.DiffChunks(self.fps, self.bd, self.lag, 2 * self.lag * (self.lag + 1))
        memo: Dict[bytes, object] = {}

        def fit_memo(chunk, lag, bd, seed):
            key = np.concatenate([np.ravel(a) for ps in (chunk.y, chunk.cb, chunk.cr)
                                  for a in (ps.ata, ps.atb, [ps.n_ar], ps.bin_cnt, ps.bin_sum,
                                            ps.bin_sumsq)] + [[chunk.frames]]).tobytes()
            if key not in memo:
                memo[key] = fit._fit_params(chunk, lag, bd, seed)
            return memo[key]

        for n in range(self.n):
            y, cb, cr = per[n % self.pool]
            chunks.add_frame(y, cb, cr, fit_memo)
        return chunks.finish(fit_memo)

    def _sample_gap(self, per: Dict[int, tuple]) -> float:
        gap = 0.0
        for n0, st in self.sample.items.items():
            for k, idx in enumerate(self._batch(n0)):
                for plane, want in zip(st, per[idx]):
                    if want is None:
                        continue
                    if plane is None or any(len(v) <= k for v in plane.values()):
                        return float("inf")  # a frame of the batch has no statistics
                    gap = max(gap, rel_gap({key: v[k] for key, v in plane.items()}, want))
        return gap

    def check(self) -> Dict[str, tuple]:
        state = self._release()
        self._per = self.pool_stats()
        want = self.replay(self._per)
        return {
            "lost_frames": (self.n - state["ingested"], 0),
            "stats_gap": (self._sample_gap(self._per) if self.sample.items else float("inf"),
                          STATS_LIMIT),
            "table_diff": (segments_differ(state["table"], want), 0),
        }

    def control(self) -> Dict[str, float]:
        """The statistics gap with the reference in float32 in the
        program's place, on the sampled batches."""
        torch.backends.cuda.matmul.allow_tf32 = False
        which = {i for n0 in self.sample.items for i in self._batch(n0)}
        low = self.pool_stats(torch.float32, sorted(which))
        gap = 0.0
        for i in which:
            for got, want in zip(low[i], self._per[i]):
                if want is not None:
                    gap = max(gap, rel_gap(got, want))
        return {"stats_gap": gap}

    def least_ms(self, n0) -> float:
        moved = ops = 0.0
        sample_bytes = 1 if self.bd == 8 else 2
        for i in self._batch(n0):
            m, o = yardstick.diff_frame_work(self._per[i], self.shapes, sample_bytes, self.lag)
            moved += m
            ops += o
        return yardstick.least_ms(moved, ops)
