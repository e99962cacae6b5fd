"""``mfu.train`` (%): the training step's share of the chip's peak: the model's conv
FLOPs of the window's pairs over the window's seconds and the peak of the
cell's dtype times its chips."""

from h100_bench import flops


def read(run):
    return flops.step_share(run, train=True)
