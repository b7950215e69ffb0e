"""Back-to-back batches: the ``closed`` mode of ``lirabench/window.py``.

The window keeps every answer for the judge, copied into host memory that
warm-up has allocated and touched, and lets each call's own result go, as a
caller that consumes its answers does. Kept as they come, the results would
take fresh pages every call, and faulting them in cost the engine's copy back
to the host 8.2 ms a call instead of 1.5 (lira-ann.batch8k on an H100): the
first window of every process read 7% below later ones. A room of one
stream's answers (256 calls) left that cost on every call past the 256th,
25-30 ms a call against ~20, so warm-up makes room for ``ROOM`` times the
calls that the window's seconds hold at the fastest warm-up call's pace; a
window that outruns the room keeps the rest as they come.
"""
from __future__ import annotations

import numpy as np
import torch

from lirabench.window import CLOCK, Window, zipf_rows

ROOM = 1.3


class Mode:
    """Back-to-back batches of ``batch_rows`` rows from a stream of pool rows."""

    def __init__(self, mix: dict, pool: torch.Tensor, seed: int):
        rng = np.random.default_rng([int(seed), 1])
        n_pool = pool.shape[0]
        self.rows = int(mix["batch_rows"])
        if mix["rows"] == "uniform":
            idx = rng.permutation(n_pool)
        elif mix["rows"] == "zipf":
            idx = zipf_rows(rng, n_pool, float(mix["zipf_s"]), n_pool, mix["ranking_seed"])
        else:
            raise ValueError(f"rows {mix['rows']!r}: uniform or zipf")
        if n_pool % self.rows:
            raise ValueError(f"the pool's {n_pool} rows are not whole batches of {self.rows}")
        self.idx = idx
        self.stream = pool[torch.as_tensor(idx, device=pool.device)].cpu().numpy()
        self.warm_calls = int(mix["warm_calls"])

    def batch(self, j: int):
        """The pool rows and vectors of the window's batch ``j``."""
        n = len(self.idx)
        lap, start = divmod(j * self.rows, n)
        if not lap:
            sl = slice(start, start + self.rows)
            return self.idx[sl], self.stream[sl]
        at = (start + lap * (self.rows // 2 + 1) + np.arange(self.rows)) % n
        return self.idx[at], self.stream[at]

    def warm(self, engine, seconds: float) -> None:
        n = len(self.idx)
        call_s = []
        for j in range(self.warm_calls):
            t = CLOCK()
            res = engine.search(self.stream[n - (j + 1) * self.rows: n - j * self.rows])
            call_s.append(CLOCK() - t)
        # the first call builds the step; the others pace the window
        pace = min(call_s[1:] or call_s)
        rows = self.rows * (int(ROOM * seconds / pace) + 1)
        # room for the window's answers, touched now so the window finds it faulted in
        self.kept_ids = np.ones((rows, res.ids.shape[1]), res.ids.dtype)
        self.kept_dists = np.ones((rows, res.dists.shape[1]), res.dists.dtype)

    def keep(self, w: Window, res) -> None:
        """Keep a call's answers for the judge (past the room, as they come)."""
        r0, r1 = w.rows, w.rows + len(res.ids)
        if r1 <= len(self.kept_ids):
            self.kept_ids[r0:r1] = res.ids
            self.kept_dists[r0:r1] = res.dists
            w.ids.append(self.kept_ids[r0:r1])
            w.dists.append(self.kept_dists[r0:r1])
        else:
            w.ids.append(res.ids)
            w.dists.append(res.dists)

    def run(self, engine, seconds: float, tracer) -> Window:
        w = Window(t_open=CLOCK(), t_close=0.0)
        t_end = w.t_open + seconds
        j = 0
        t = w.t_open
        while t < t_end:
            idx, q = self.batch(j)
            with tracer.span("bench.batch"):
                res = engine.search(q)
            w.pool.append(idx)
            self.keep(w, res)
            w.nprobe.append(res.nprobe_eff)
            w.overflow += res.overflow
            w.rows += len(idx)
            w.calls += 1
            j += 1
            del res
            t1 = CLOCK()
            w.call_ms.append((t1 - t) * 1e3)
            t = t1
        w.t_close = t
        return w
