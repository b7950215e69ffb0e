"""kernel_build_s: seconds nvcc ran in this process to build the kernel
libraries, summed over kernels (the program's
``lira_kernel_build_seconds_total``); 0 where every library was built
before, as in a checkout's later runs."""
from lirabench import program


def read(r):
    c = program.process_counter("lira_kernel_build_seconds_total")
    return None if c is None else c.total()
