"""query_bytes_per_row.batch: the query bytes ``LiraEngine.search`` copies to
the card per query row served: the program's ``lira_engine_query_bytes_total``
over ``lira_engine_rows_total``, both over the window (d bytes a row for
uint8 queries, 4·d for f32). Nothing where the program has no such
counter."""
from lirabench import program


def read(r):
    nbytes = program.counter(r.registry, "lira_engine_query_bytes_total")
    rows = program.counter(r.registry, "lira_engine_rows_total")
    if nbytes is None or rows is None or not rows.total():
        return None
    return nbytes.total() / rows.total()
