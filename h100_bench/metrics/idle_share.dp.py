"""``idle_share.dp`` (%): the share of the traced window of a data-parallel
training step in which no operation ran on a rank's device (1 - the union
of its intervals over the window), averaged over the ranks."""

from h100_bench import trace


def read(run):
    return trace.idle_percent(run)
