"""host_ms: host ms per ``LiraEngine.search`` call outside the device step,
its ``engine.prepare`` and ``engine.post`` spans (validation, the serve-cache
lookup, padding and the copy in; the copies out and the counters)."""
from lirabench import common


def read(r):
    return common.host_ms(r)
