"""Span-based tracing with an injectable clock (counterpart of
``repro/obs/trace.py``; pure Python, kept as the port's own copy).

A ``Tracer`` hands out nestable ``span("name")`` context managers; each span
records its start, duration, parent and free-form attributes. The serving
stack threads one tracer through the front-end and the engine, so one request
gives a spine like

    frontend.batch → frontend.assemble → engine.search → prepare / device / post

with parent links intact (spans nest by being opened while another span of
the same tracer is open).

  * **Deterministic tests**: the clock is injected (``utils.clock.FakeClock``
    instances are callable), so span durations are exact under virtual time.
  * **Zero cost when off**: ``NOOP`` is a shared tracer whose ``span`` is a
    reusable no-op context. The traced code path is the same either way
    (tracing must give the same bits as not tracing); tracing only reads
    clocks around stages.
  * **Bounded memory**: finished spans land in a ring (``max_spans``); a
    ``sink`` (path or callable) can stream them out as JSON lines instead.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import time
from typing import Callable, Optional, Union

__all__ = ["Span", "Tracer", "NOOP"]


class Span:
    """One timed stage. ``duration_ms`` is 0 while the span is open; attrs
    set via ``set(...)`` inside the block are exported with the span."""

    __slots__ = ("name", "span_id", "parent_id", "t_start", "t_end", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t_start: float):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs: dict = {}

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def duration_ms(self) -> float:
        if self.t_end is None:
            return 0.0
        return (self.t_end - self.t_start) * 1e3

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t_start": self.t_start,
                "duration_ms": self.duration_ms, "attrs": self.attrs}

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, {self.duration_ms:.3f}ms)")


class Tracer:
    """Collects nested spans. ``clock`` is any zero-arg callable returning
    seconds (``time.perf_counter`` by default; pass a
    ``repro_torch.utils.clock.FakeClock`` for virtual time). ``sink`` streams
    finished spans as JSON-lines to a path or hands the dict to a
    callable."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 sink: Union[str, Callable[[dict], None], None] = None,
                 max_spans: int = 100_000):
        self._clock = clock
        self._sink = sink
        self._sink_fh: Optional[io.TextIOBase] = None
        self._stack: list[Span] = []
        self._finished: list[Span] = []
        self._max_spans = int(max_spans)
        self._ids = itertools.count(1)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        parent = self._stack[-1] if self._stack else None
        sp = Span(name, next(self._ids),
                  parent.span_id if parent else None, self._clock())
        if attrs:
            sp.attrs.update(attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            sp.t_end = self._clock()
            self._stack.pop()
            self._record(sp)

    def _record(self, sp: Span) -> None:
        self._finished.append(sp)
        if len(self._finished) > self._max_spans:
            del self._finished[:len(self._finished) - self._max_spans]
        if self._sink is not None:
            if callable(self._sink):
                self._sink(sp.to_dict())
            else:
                if self._sink_fh is None:
                    self._sink_fh = open(self._sink, "a")
                self._sink_fh.write(json.dumps(sp.to_dict()) + "\n")
                self._sink_fh.flush()

    def finished(self, name: Optional[str] = None) -> list[Span]:
        if name is None:
            return list(self._finished)
        return [s for s in self._finished if s.name == name]

    def children(self, parent: Span) -> list[Span]:
        return [s for s in self._finished if s.parent_id == parent.span_id]

    def clear(self) -> None:
        self._finished.clear()

    def export_jsonl(self, path: str) -> int:
        """Write every retained span as one JSON object per line; returns
        the number of spans written."""
        with open(path, "w") as fh:
            for sp in self._finished:
                fh.write(json.dumps(sp.to_dict()) + "\n")
        return len(self._finished)

    def close(self) -> None:
        if self._sink_fh is not None:
            self._sink_fh.close()
            self._sink_fh = None


class _NoopSpan:
    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = None
    attrs: dict = {}
    duration_ms = 0.0

    def set(self, **attrs) -> None:
        pass


class _NoopTracer:
    """Tracing disabled: ``span`` returns one shared reusable null context.
    ``enabled`` lets call sites skip building stage dicts entirely."""

    enabled = False
    _CM = contextlib.nullcontext(_NoopSpan())

    def span(self, name: str, **attrs):
        return self._CM

    def finished(self, name=None):
        return []

    def clear(self) -> None:
        pass


NOOP = _NoopTracer()
