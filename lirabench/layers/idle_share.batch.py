"""idle_share: the share of the traced window in which no operation ran on
the card (1 − the union of the device events' intervals ÷ the window)."""
from lirabench import common


def read(r):
    return common.idle_share(r)
