"""What a traced run (``--trace 1``) captures, and its reduction in memory.

Over the measured window a ``torch.profiler`` capture records the card's
operations, the program's spans go to an ``obs.Tracer`` and its counters to a
fresh ``obs.MetricsRegistry``, and ``Hooks`` wrap kernel entry points of
``repro_torch.kernels.ops`` to count the work each call is handed. The
profile is reduced here and never written out:
  * every device event (kernel, copy, fill) is matched to the runtime call
    that launched it by its correlation id, and its time counted under the
    serve step's named range around that call (``lira.probing`` ... ``lira.merge``)
    and under the innermost operation (or, for a kernel launched directly,
    its own name): the reduction of ``repro_torch.obs.profiling.range_times``;
  * the device's busy time is the union of the device events' intervals;
  * the idle gaps inside the window are named by the innermost host span
    open at their midpoint, the profiler's clock tied to the spans' clock by
    a marker range entered at a known time.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time
from typing import Callable, Optional

RANGES = ("lira.probing", "lira.dispatch", "lira.scan", "lira.merge")
_MARK = "lirabench.window"
_DEVICE_CALLS = ("LaunchKernel", "Memcpy", "Memset")


class Hooks:
    """Wrappers over functions of ``repro_torch.kernels.ops``: each call of a
    wrapped function first hands ``cache`` and its arguments to the hook,
    whose return value is kept in ``calls[name]``. ``counting`` turns the keeping on (the hooks
    run in warm-up too, so a hook can cache what is fixed for the store)."""

    def __init__(self):
        self.calls: dict = collections.defaultdict(list)
        self.cache: dict = {}           # what a hook keeps across calls
        self.counting = False
        self._saved: dict = {}

    def wrap(self, name: str, hook: Callable) -> None:
        from repro_torch.kernels import ops

        inner = self._saved.setdefault(name, getattr(ops, name))
        outer = getattr(ops, name)

        def wrapped(*args, **kwargs):
            rec = hook(self.cache, *args, **kwargs)
            if self.counting:
                self.calls[name].append(rec)
            return outer(*args, **kwargs)

        wrapped.__wrapped__ = inner
        setattr(ops, name, wrapped)

    def remove(self) -> None:
        from repro_torch.kernels import ops

        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        self._saved.clear()


@dataclasses.dataclass
class Reduced:
    """A traced window, reduced. Times in milliseconds unless named ``_s``."""
    window_s: float
    busy_s: float
    ranges: dict                    # range → device ms
    ops: dict                       # "range/op" → device ms
    kernels: dict                   # device event name → ms
    idle: dict                      # innermost host span → idle seconds
    events: int
    unmatched: int
    lost: int

    def kernel_ms(self, prefix: str) -> float:
        """Device ms of the events whose name has a word starting ``prefix``."""
        return sum(ms for name, ms in self.kernels.items()
                   if any(w.startswith(prefix) for w in re.split(r"\W+", name)))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, ms / 1e3] for name, ms in ops],
                "idle_gaps": [[name, s] for name, s in idle]}


class Capture:
    """The profiler and the tracer over one window. Enter it just before the
    window opens and leave it when the window closes; ``reduce()`` then
    gives the ``Reduced``."""

    def __init__(self, tracer, cuda: bool):
        self.tracer = tracer
        self.cuda = cuda
        self.prof = None
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self._mark = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self._mark = record_function(_MARK)
        self._mark.__enter__()
        self.t_open = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.t_close = time.perf_counter()
        self._mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Reduced:
        from torch.autograd import DeviceType

        events = self.prof.events()
        mark = next(ev for ev in events if ev.name == _MARK
                    and ev.device_type == DeviceType.CPU)
        w0, w1 = mark.time_range.start, mark.time_range.end        # profiler µs
        offset_us = w0 - self.t_open * 1e6
        runtime = {ev.id: ev for ev in events
                   if ev.device_type == DeviceType.CPU and ev.name.startswith("cu")}
        ranges = {n: 0.0 for n in RANGES}
        ops, kernels = collections.Counter(), collections.Counter()
        spans_iv = []
        seen, unmatched = set(), 0
        for ev in events:
            if ev.device_type != DeviceType.CUDA or ev.name in ranges or ev.name == _MARK:
                continue
            a, b = ev.time_range.start, ev.time_range.end
            ms = (b - a) / 1e3
            spans_iv.append((a, b))
            kernels[ev.name] += ms
            call = runtime.get(ev.id)
            if call is None:
                unmatched += 1
                ops["unmatched/" + ev.name] += ms
                continue
            seen.add(ev.id)
            op = call.cpu_parent
            rng = op
            while rng is not None and rng.name not in ranges:
                rng = rng.cpu_parent
            where = rng.name if rng is not None else "outside"
            if rng is not None:
                ranges[rng.name] += ms
            ops[where + "/" + (ev.name if op is None or op is rng else op.name)] += ms
        lost = sum(1 for i, call in runtime.items()
                   if i not in seen and any(c in call.name for c in _DEVICE_CALLS))
        busy_us, gaps = _busy_and_gaps(spans_iv, w0, w1)
        return Reduced(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, ranges=ranges,
                       ops=dict(ops), kernels=dict(kernels),
                       idle=self._name_gaps(gaps, offset_us), events=len(spans_iv),
                       unmatched=unmatched, lost=lost)

    def _name_gaps(self, gaps, offset_us) -> dict:
        """Idle seconds by the innermost host span open at each gap's midpoint
        (``"no span"`` where none is)."""
        spans = sorted((sp.t_start * 1e6 + offset_us, sp.t_end * 1e6 + offset_us, sp.name)
                       for sp in self.tracer.finished() if sp.t_end is not None)
        starts = [s[0] for s in spans]
        idle = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = "no span"
            # spans nest, so the innermost open one is the latest started
            # that has not ended
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if spans[i][1] >= mid:
                    name = spans[i][2]
                    break
            idle[name] += (b - a) / 1e6
        return dict(idle)


def _busy_and_gaps(intervals, w0: float, w1: float):
    """The union's length of ``intervals`` cut to [w0, w1], and the gaps."""
    busy, gaps, cur = 0.0, [], w0
    for a, b in sorted(intervals):
        a, b = max(a, w0), min(b, w1)
        if b <= cur:
            continue
        if a > cur:
            gaps.append((cur, a))
            cur = a
        busy += b - cur
        cur = b
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps
