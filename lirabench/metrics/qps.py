"""qps: query rows answered in the window over the window's seconds, the
window running from its opening to the return of the last call sent in it."""


def read(r):
    w = r.window
    return w.rows / w.seconds if w.seconds > 0 and w.rows else None
