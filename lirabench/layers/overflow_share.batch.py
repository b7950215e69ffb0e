"""overflow_share.batch: probes dropped by a partition's ``q_cap`` over the
probes attempted, from the engine's ``lira_engine_overflow_probes_total`` and
``lira_engine_probes_total`` counters over the window."""
from lirabench import common


def read(r):
    if r.registry is None:
        return None
    tried = common.series_total(r.registry, "lira_engine_probes_total")
    if not tried:
        return None
    return common.series_total(r.registry, "lira_engine_overflow_probes_total") / tried
