"""``mfu.dp`` (%): the data-parallel training step's share of the peak of
its chips: the model's conv FLOPs of the window's pairs (over every rank)
over the window's seconds and the peak of the cell's dtype times its
chips."""

from h100_bench import flops


def read(run):
    return flops.step_share(run, train=True)
