"""What the path drivers' checks share: the sample drawn from the seed,
and the numbers that compare the program's outputs with the reference's."""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` of the items offered (reservoir sampling
    with a generator on the run's seed): ``offer`` returns the slot an item
    takes, or None, and ``items`` maps each kept key to its item."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.keys: List = []
        self.items: Dict = {}

    def offer(self, key, make) -> bool:
        """Offer the item ``make()`` would give under ``key``; ``make`` is
        called only when the item is kept."""
        slot = self.seen if self.seen < self.k else self.rng.randrange(self.seen + 1)
        self.seen += 1
        if slot >= self.k:
            return False
        if slot < len(self.keys):
            self.items.pop(self.keys[slot], None)
            self.keys[slot] = key
        else:
            self.keys.append(key)
        self.items[key] = make()
        return True


def rate(done, t0: float) -> float:
    """Frames a second over the window: every batch handed to the port in
    the window, ``done`` as (handed, complete, frames), over the time from
    the window's start to the last completion. The window closes at its
    last batch's completion, so no batch counts in part."""
    return sum(b for _, _, b in done) / (max(c for _, c, _ in done) - t0)


def rel_gap(got: dict, want: dict) -> float:
    """The widest |got - want| of a statistic, relative to the largest
    |want| of that statistic, over all statistics; a statistic missing or
    of another shape reads infinite."""
    worst = 0.0
    for k, w in want.items():
        g = got.get(k)
        if g is None or np.shape(g) != np.shape(w):
            return float("inf")
        if not np.size(w):
            continue
        gap = float(np.max(np.abs(np.asarray(g, np.float64) - w)))
        if gap:
            scale = float(np.max(np.abs(w)))
            worst = max(worst, gap / scale if scale else float("inf"))
    return worst


def segments_differ(got, want) -> int:
    """Segments of two grain tables that differ in time or in any parameter
    (seed included), and the difference in their counts."""
    diff = abs(len(got) - len(want))
    for a, b in zip(got, want):
        same = (a.start_time, a.end_time) == (b.start_time, b.end_time) and all(
            getattr(a.params, f) == getattr(b.params, f) for f in vars(b.params))
        diff += not same
    return diff


def chunk_stats(chunk) -> Dict[str, dict]:
    """An estimator chunk's sums (``_ChunkStats``: y, cb, cr) as plain
    dicts of float64 arrays, copied."""
    return {plane: {k: np.array(getattr(getattr(chunk, plane), k), dtype=np.float64)
                    for k in ("ata", "atb", "n_ar", "bin_cnt", "bin_sum", "bin_sumsq")}
            for plane in ("y", "cb", "cr")}
