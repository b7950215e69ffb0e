"""Injectable clocks for the serving stack (counterpart of
``repro/utils/clock.py``).

Every time-dependent layer (the front-end's batching deadlines, the tracer's
span durations) takes a zero-argument ``clock`` callable returning seconds
instead of reading wall time itself. ``FakeClock`` is the deterministic one:
time moves only through ``advance``, so scheduler tests never sleep and
latency assertions are exact. Production callers pass ``time.monotonic``
(scheduling) or ``time.perf_counter`` (durations).
"""
from __future__ import annotations

__all__ = ["FakeClock"]


class FakeClock:
    """Deterministic injectable clock: time moves only via ``advance``. Used
    by the scheduler tests and the open-loop load simulation, where measured
    service time is charged explicitly."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self._t += float(dt)
        return self._t
