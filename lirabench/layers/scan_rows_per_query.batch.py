"""scan_rows_per_query.batch: live rows the scan reads per query row served:
the program's ``lira_engine_scan_pair_rows_total`` (each probed partition's
live rows, once a dispatched query) over ``lira_engine_rows_total``, both
over the window."""
from lirabench import program


def read(r):
    pairs = program.counter(r.registry, "lira_engine_scan_pair_rows_total")
    rows = program.counter(r.registry, "lira_engine_rows_total")
    if pairs is None or rows is None or not rows.total():
        return None
    return pairs.total() / rows.total()
