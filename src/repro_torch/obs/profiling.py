"""torch.profiler capture and the serve step's profiler ranges (counterpart
of ``repro/obs/profiling.py``).

``profile_capture(profile_dir)`` wraps a code region in a ``torch.profiler``
trace when ``profile_dir`` is truthy and is a no-op otherwise, so launchers
can take ``--profile-dir`` unconditionally. The trace lands in
``<profile_dir>/<worker>.<timestamp>.pt.trace.json``, which TensorBoard's
profile plugin and Perfetto (ui.perfetto.dev) read. The serve step wraps its
stages in ``torch.profiler.record_function`` ranges named ``RANGES``, so a
trace reads in LIRA's stage vocabulary; ``range_times`` sums the device time
of the kernels launched inside each range, by range and by operation.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional

__all__ = ["RANGES", "profile_capture", "range_times"]

# the serve step's stages, in order (serving/engine.py:make_serve_step)
RANGES = ("lira.probing", "lira.dispatch", "lira.scan", "lira.merge")


@contextlib.contextmanager
def profile_capture(profile_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace (CPU, and the card when there is
    one) into ``profile_dir`` for the duration of the block, yielding the
    profiler (``key_averages()``, ``events()``); no-op yielding None when
    ``profile_dir`` is empty or None."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(profile_dir))) as prof:
        yield prof


# runtime and driver calls that put work on the card, each seen as one
# device event (a kernel, a copy or a fill) with the call's correlation id
_DEVICE_CALLS = ("LaunchKernel", "Memcpy", "Memset")


def range_times(prof, names=RANGES) -> dict:
    """Device time of a finished profile, by named range and by operation.

    A device event (kernel, copy, fill) is matched to the runtime call that
    launched it by its correlation id; the call's enclosing operations give
    the range, and the innermost one (``aten::sort``, ``aten::mm``, ...) the
    op it counts under. A kernel the range launched directly (the
    hand-written kernels, launched through ctypes) counts under its own
    name. Every device event is accounted for, so a capture that lost
    records shows it. Returns::

        {"ranges": {range: {"device_ms": ms, "ops": {op: ms}}},  # summed over
                                                                  # each occurrence
         "outside": {"device_ms": ms, "ops": {op: ms}},  # matched, in no range
         "unmatched": {"events": n, "device_ms": ms},    # no runtime call found
         "lost": n,          # launch, copy or fill calls with no device event
         "events": n, "busy_ms": ms}                      # every device event
    """
    from torch.autograd import DeviceType

    events = prof.events()
    # CUDA runtime and driver calls (cudaLaunchKernel, cudaMemcpyAsync, ...)
    runtime = {ev.id: ev for ev in events
               if ev.device_type == DeviceType.CPU and ev.name.startswith("cu")}
    ranges = {n: {"device_ms": 0.0, "ops": collections.Counter()} for n in names}
    outside = {"device_ms": 0.0, "ops": collections.Counter()}
    unmatched = {"events": 0, "device_ms": 0.0}
    seen, n_events, busy = set(), 0, 0.0
    for ev in events:
        if ev.device_type != DeviceType.CUDA or ev.name in ranges:
            continue    # CPU events, and the ranges' own device-side spans
        ms = (ev.time_range.end - ev.time_range.start) / 1e3
        n_events += 1
        busy += ms
        call = runtime.get(ev.id)
        if call is None:
            unmatched["events"] += 1
            unmatched["device_ms"] += ms
            continue
        seen.add(ev.id)
        op = call.cpu_parent
        rng = op
        while rng is not None and rng.name not in ranges:
            rng = rng.cpu_parent
        rec = ranges[rng.name] if rng is not None else outside
        rec["device_ms"] += ms
        rec["ops"][ev.name if op is None or op is rng else op.name] += ms
    lost = sum(1 for i, call in runtime.items()
               if i not in seen and any(c in call.name for c in _DEVICE_CALLS))

    def done(rec):
        return {"device_ms": rec["device_ms"], "ops": dict(rec["ops"].most_common())}

    return {"ranges": {n: done(r) for n, r in ranges.items()}, "outside": done(outside),
            "unmatched": unmatched, "lost": lost, "events": n_events, "busy_ms": busy}
