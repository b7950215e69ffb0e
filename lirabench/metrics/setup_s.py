"""setup_s: seconds from the process's start (imports included) to the
window's opening: the vectors, the index build, and the warm-up of every
shape the traffic uses (the kernels' first build in a fresh checkout too)."""


def read(r):
    return r.setup_s
