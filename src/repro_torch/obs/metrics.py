"""Metrics registry: Counter / Gauge / Histogram with labels (counterpart of
``repro/obs/metrics.py``; pure Python and numpy, kept as the port's own copy).

  * **Counter** — monotonically increasing totals (searches served, overflow
    probes, shed requests), labeled (``tier="pq", impl="cuda"``);
  * **Gauge**   — last-written values (current ``q_cap_factor``, store epoch);
  * **Histogram** — fixed log-spaced buckets (``LATENCY_BUCKETS_MS``: 4 per
    decade, ~31.6 µs to 10 s) plus exact per-label min/max/sum/count, so
    memory is O(buckets) however long the process serves. ``quantile``
    interpolates within the bucket and clamps to the observed [min, max]:
    a degenerate distribution reports exactly its value, and no estimate
    exceeds what was seen.

A ``MetricsRegistry`` is a get-or-create namespace of metrics; ``render()``
emits a Prometheus-style text exposition and ``parse_exposition`` reads one
back. The port's process-wide ``default_registry()`` is its own, not the JAX
package's; tests and benchmarks inject fresh registries.

No clocks in here: time enters only as observed values (``obs/trace.py``
measures).
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np

__all__ = ["LATENCY_BUCKETS_MS", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "default_registry", "parse_exposition"]

# 4 buckets per decade from 10^-1.5 ms (~31.6 µs) to 10^4 ms (10 s): spans a
# sub-µs kernel launch to a pathological multi-second stall at a constant
# 10^0.25 ≈ 1.78× resolution. Values beyond the last edge land in +Inf.
LATENCY_BUCKETS_MS = tuple(10.0 ** (i / 4.0) for i in range(-6, 17))

# effective-probe counts are small integers: pow2 edges keep the paper's
# fan-out distribution readable (nprobe_eff ≤ 1, ≤ 2, ≤ 4, …)
NPROBE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
BATCH_ROWS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                      512.0, 1024.0)

# per-partition staleness fractions ((misassigned inserts + tombstones) /
# live rows, serving/engine.py maybe_repartition): ~2× edges around the
# default 0.25 repartition threshold; > 1.0 means more churn than content
STALENESS_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0)


def _key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _matches(key: tuple, subset: dict) -> bool:
    want = {(str(k), str(v)) for k, v in subset.items()}
    return want <= set(key)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def _render_labels(self, key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Metric):
    """Monotonic total per label set. ``inc`` rejects negative amounts —
    a decreasing counter means two code paths disagree about what happened."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        k = _key(labels)
        self._vals[k] = self._vals.get(k, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return self._vals.get(_key(labels), 0.0)

    def total(self, **labels) -> float:
        """Sum over every label set matching the given subset (e.g. all shed
        reasons of one front-end)."""
        return sum(v for k, v in self._vals.items() if _matches(k, labels))

    def render(self) -> list[str]:
        lines = [f"# TYPE {self.name} {self.kind}"]
        for k in sorted(self._vals):
            lines.append(f"{self.name}{self._render_labels(k)} "
                         f"{self._vals[k]:.10g}")
        return lines


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._vals[_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._vals.get(_key(labels), 0.0)

    def render(self) -> list[str]:
        lines = [f"# TYPE {self.name} {self.kind}"]
        for k in sorted(self._vals):
            lines.append(f"{self.name}{self._render_labels(k)} "
                         f"{self._vals[k]:.10g}")
        return lines


class _HistState:
    __slots__ = ("counts", "total", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = np.zeros(n_buckets + 1, np.int64)  # last = +Inf overflow
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bucket distribution per label set: O(len(buckets)) memory
    regardless of observation count — the bounded replacement for rolling
    per-observation reservoirs in long-lived serving processes."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS):
        super().__init__(name, help)
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"increasing, got {edges}")
        self.buckets = edges
        self._edges = np.asarray(edges, np.float64)
        self._states: dict[tuple, _HistState] = {}

    def _state(self, labels: dict) -> _HistState:
        k = _key(labels)
        st = self._states.get(k)
        if st is None:
            st = self._states[k] = _HistState(len(self.buckets))
        return st

    def observe(self, value: float, **labels) -> None:
        self.observe_many([value], **labels)

    def observe_many(self, values, **labels) -> None:
        vals = np.asarray(values, np.float64).reshape(-1)
        if vals.size == 0:
            return
        st = self._state(labels)
        # bucket b holds values ≤ edge[b] (Prometheus "le" semantics)
        idx = np.searchsorted(self._edges, vals, side="left")
        np.add.at(st.counts, idx, 1)
        st.total += int(vals.size)
        st.sum += float(vals.sum())
        st.min = min(st.min, float(vals.min()))
        st.max = max(st.max, float(vals.max()))

    def count(self, **labels) -> int:
        st = self._states.get(_key(labels))
        return st.total if st else 0

    def sum(self, **labels) -> float:
        st = self._states.get(_key(labels))
        return st.sum if st else 0.0

    def counts(self, **labels) -> np.ndarray:
        st = self._states.get(_key(labels))
        return (st.counts.copy() if st
                else np.zeros(len(self.buckets) + 1, np.int64))

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile by linear interpolation inside the bucket
        holding the target rank, clamped to the exact observed [min, max] —
        a degenerate distribution (all values equal) reports exactly that
        value, and no estimate exceeds what was actually seen."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        st = self._states.get(_key(labels))
        if st is None or st.total == 0:
            return 0.0
        rank = q * st.total
        cum = np.cumsum(st.counts)
        b = int(np.searchsorted(cum, rank, side="left"))
        lo = self.buckets[b - 1] if b > 0 else 0.0
        hi = self.buckets[b] if b < len(self.buckets) else st.max
        prev = float(cum[b - 1]) if b > 0 else 0.0
        frac = (rank - prev) / max(float(st.counts[b]), 1.0)
        est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(min(max(est, st.min), st.max))

    def render(self) -> list[str]:
        lines = [f"# TYPE {self.name} {self.kind}"]
        for k in sorted(self._states):
            st = self._states[k]
            cum = 0
            for edge, n in zip(self.buckets, st.counts):
                cum += int(n)
                le = 'le="%.10g"' % edge
                lines.append(
                    f"{self.name}_bucket{self._render_labels(k, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket"
                         f"{self._render_labels(k, inf)} {st.total}")
            lines.append(f"{self.name}_sum{self._render_labels(k)} "
                         f"{st.sum:.10g}")
            lines.append(f"{self.name}_count{self._render_labels(k)} "
                         f"{st.total}")
        return lines


class MetricsRegistry:
    """Get-or-create namespace of metrics. Re-requesting a name returns the
    existing instrument; requesting it as a different kind (or a histogram
    with different buckets) raises — two call sites silently disagreeing
    about a metric is how dashboards lie."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kwargs)
            return m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        if kwargs.get("buckets") is not None and \
                tuple(float(b) for b in kwargs["buckets"]) != m.buckets:
            raise ValueError(f"histogram {name!r} already registered with "
                             f"different buckets")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        # buckets=None means "don't care": create with the latency defaults,
        # or return whatever is registered (readers must not need to repeat
        # the creator's bucket choice just to fetch the instrument)
        if buckets is None and name not in self._metrics:
            buckets = LATENCY_BUCKETS_MS
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._metrics))

    def render(self) -> str:
        """Prometheus-style text exposition of every registered metric."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry production code records into by default."""
    return _DEFAULT


_LINE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def parse_exposition(text: str) -> dict[str, float]:
    """Parse a ``render()`` exposition back into ``{series: value}`` keyed by
    ``name{labels}``. Raises ValueError on any non-comment line that does not
    parse, so it doubles as the "metrics text is well-formed" check."""
    out: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        try:
            value = float(m.group(3))
        except ValueError:
            raise ValueError(f"non-numeric value on line {lineno}: "
                             f"{line!r}") from None
        out[m.group(1) + (m.group(2) or "")] = value
    return out
