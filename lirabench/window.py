"""The traffic generator's common parts. A mix is a file of parameters,
``lirabench/traffic/<mix>.json``; its ``mode`` names the generator that reads
it, ``lirabench/modes/<mode>.py``, whose ``Mode(mix, pool, seed)`` draws the
mix's requests from the seed over the configuration's query pool (a tensor
on the run's device), ``warm(engine, seconds)`` warms up the shapes they use
and whatever a window of ``seconds`` needs ready, and
``run(engine, seconds, tracer)`` drives the measured window and returns a
``Window``.

  ``"mode": "closed"``: back-to-back ``LiraEngine.search`` calls of
      ``batch_rows`` rows each, the next sent when the last returns (callers
      that each wait for their answer). The rows are a stream drawn from the
      seed before the window: the whole pool in an order of the seed's
      (``"rows": "uniform"``: no query repeats until the stream wraps), or
      draws by Zipf's law with exponent ``zipf_s`` over one ranking of the
      pool fixed by the mix's ``ranking_seed`` (``"rows": "zipf"``: the same
      popular queries recur in every batch of the window and of every run).
      Batch j is the stream's rows [j·batch_rows, (j+1)·batch_rows), so no
      two batches of a window are the same rows; a window that outruns the
      stream starts it again, half a batch and a row further on each time.
      Warm-up sends ``warm_calls`` batches from the stream's end.

Every answered row is an index into the query pool, so the answers can be
judged against the reference once the window has closed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

CLOCK = time.perf_counter


@dataclasses.dataclass
class Window:
    """What the window did. ``pool`` / ``ids`` / ``dists`` / ``nprobe`` hold
    one entry per engine call; ``call_ms`` the host time of each call."""
    t_open: float
    t_close: float
    rows: int = 0
    calls: int = 0
    unanswered: int = 0
    overflow: int = 0
    pool: list = dataclasses.field(default_factory=list)
    ids: list = dataclasses.field(default_factory=list)
    dists: list = dataclasses.field(default_factory=list)
    nprobe: list = dataclasses.field(default_factory=list)
    call_ms: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


def zipf_rows(rng, n_pool: int, s: float, size: int, ranking_seed: int) -> np.ndarray:
    """``size`` pool rows by Zipf's law with exponent ``s``, drawn from
    ``rng``, over the ranking of the pool that ``ranking_seed`` fixes."""
    rank = np.random.default_rng(int(ranking_seed)).permutation(n_pool)
    cdf = np.cumsum(1.0 / np.arange(1, n_pool + 1) ** s)
    pick = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    return rank[np.minimum(pick, n_pool - 1)]
