"""``idle_share.serve`` (%): the share of the traced window of a register call
in which no operation ran on the device (1 - the union of the device's
intervals over the window)."""

from h100_bench import trace


def read(run):
    return trace.idle_percent(run)
