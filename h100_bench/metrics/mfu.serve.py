"""``mfu.serve`` (%): the register call's share of the chip's peak: the model's conv
FLOPs of the window's pairs over the window's seconds and the bf16 peak."""

from h100_bench import flops


def read(run):
    return flops.step_share(run, train=False)
