"""merge_pool_fill.batch: the share of the merge pool's entries that hold a
candidate: the program's ``lira_engine_merge_pool_entries_total`` written
(each dispatched pair's top-k) over allocated (the compact pool,
``[q_row, nprobe_max·k]`` a call), over the window."""
from lirabench import program


def read(r):
    pool = program.counter(r.registry, "lira_engine_merge_pool_entries_total")
    if pool is None or not pool.total(kind="allocated"):
        return None
    return pool.total(kind="written") / pool.total(kind="allocated")
