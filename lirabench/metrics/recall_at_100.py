"""recall_at_100: recall@100 of every answered query against the plain
reference's exact top-100 (``judge.py``)."""


def read(r):
    return r.checks["recall"]["value"] if r.checks and r.window.rows else None
