"""The program's own counters for the readers of the spans and counters
inside the build and the serve step: None wherever the program under test
never made the counter, so a reader reports nothing there instead of a
zero."""
from __future__ import annotations


def counter(registry, name: str):
    """The counter ``name`` of ``registry``, or None."""
    from repro_torch.obs.metrics import Counter

    found = None if registry is None else registry.get(name)
    return found if isinstance(found, Counter) else None


def process_counter(name: str):
    """The counter ``name`` of the process-wide registry, where the build
    (``run.py`` builds with no registry of its own) and the kernel compiles
    count, or None."""
    from repro_torch.obs.metrics import default_registry

    return counter(default_registry(), name)


def build_stage_s(stage: str):
    """Seconds ``LiraEngine.build`` spent in ``stage``
    (``lira_build_seconds_total{stage}``), or None."""
    c = process_counter("lira_build_seconds_total")
    return None if c is None else c.value(stage=stage)
