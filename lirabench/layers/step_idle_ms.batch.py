"""step_idle_ms.batch: ms a ``LiraEngine.search`` call in which the card
waited while the host was inside the serve step: the traced window's idle
gaps named by ``engine.device``, ``engine.sync`` or a stage of the step
(``lira.probing`` ... ``lira.merge``), over the window's ``engine.search``
spans."""

SPANS = ("engine.device", "engine.sync", "lira.probing", "lira.dispatch", "lira.scan",
         "lira.merge")


def read(r):
    if r.reduced is None or r.tracer is None:
        return None
    calls = len(r.tracer.finished("engine.search"))
    if not calls:
        return None
    return sum(r.reduced.idle.get(name, 0.0) for name in SPANS) * 1e3 / calls
