"""``conv_roofline.train`` (%): the conv layer's share of its roofline in training: the least
time of the U-Net's conv work (forward, dx, dw) over the device time of
the conv layer's kernels."""

from h100_bench import flops


def read(run):
    return flops.conv_share(run, train=True)
