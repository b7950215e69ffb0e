"""scan_ms.batch: device ms inside the serve step's ``lira.scan``
range, over the window, per 1,000 query rows served."""
from lirabench import common


def read(r):
    return common.range_per_kq(r, "lira.scan")
