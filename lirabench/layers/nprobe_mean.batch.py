"""nprobe_mean.batch: partitions probed per query (``SearchResult.nprobe_eff``:
the σ-adaptive fan-out), the mean over every row answered in the window."""
import numpy as np


def read(r):
    rows = r.window.nprobe
    return float(np.concatenate(rows).mean()) if rows else None
