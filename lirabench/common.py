"""Helpers the metric readers share: the program's counters and spans, and
device time per thousand queries."""
from __future__ import annotations


def series_total(registry, name: str) -> float:
    """The sum of a counter, or of a histogram's ``_sum`` / ``_count``
    series, over every label set, read from the registry's exposition."""
    from repro_torch.obs.metrics import parse_exposition

    total = 0.0
    for key, value in parse_exposition(registry.render()).items():
        if key.split("{")[0] == name:
            total += value
    return total


def span_ms(tracer, name: str) -> list:
    """The durations of the finished spans called ``name``, in ms."""
    return [sp.duration_ms for sp in tracer.finished(name)]


def range_per_kq(r, name: str):
    """Device ms in the serve step's range ``name`` over the window, per
    1,000 query rows served; None when no device time was read."""
    ms = 0.0 if r.reduced is None else r.reduced.ranges.get(name, 0.0)
    if not ms > 0 or not r.window.rows:
        return None
    return ms * 1e3 / r.window.rows


def host_ms(r):
    """Host ms a ``LiraEngine.search`` call spends before and after the
    device: its ``engine.prepare`` and ``engine.post`` spans, per call."""
    if r.tracer is None:
        return None
    calls = len(r.tracer.finished("engine.search"))
    if not calls:
        return None
    return (sum(span_ms(r.tracer, "engine.prepare")) + sum(span_ms(r.tracer, "engine.post"))) / calls


def idle_share(r):
    """The share of the traced window in which no operation ran on the card."""
    red = r.reduced
    if red is None or not red.window_s > 0 or not red.busy_s > 0:
        return None
    return 1.0 - red.busy_s / red.window_s


def live_rows(cache, cand_ids):
    """Live rows per partition ([B], float64), counted once for the store:
    the first call (in warm-up) counts them, later calls on a store of the
    same shape reuse the count."""
    key = ("live", tuple(cand_ids.shape), cand_ids.device)
    if key not in cache:
        cache[key] = (cand_ids >= 0).sum(1).double()
    return cache[key]


def kernel_share(r, name: str, work):
    """``<kernel>_roofline``: the least time the card needs for the work the
    window handed the kernel ``name`` (``work(**call)`` → (bytes, flops) for
    each call its hook kept) as a percentage of the device time of the
    events whose name starts ``name``."""
    from lirabench import peaks

    if r.reduced is None or r.hooks is None:
        return None
    calls = r.hooks.calls.get(name, [])
    ms = r.reduced.kernel_ms(name)
    if not calls or not ms > 0:
        return None
    nbytes = flops = 0.0
    for call in calls:
        b, f = work(**call)
        nbytes += float(b)
        flops += float(f)
    return peaks.roofline_share(nbytes, flops, ms / 1e3)
