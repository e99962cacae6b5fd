"""``conv_roofline.serve`` (%): the conv layer's share of its roofline in serving: the least
time of the U-Net's forward convs over the device time of the conv
layer's kernels."""

from h100_bench import flops


def read(run):
    return flops.conv_share(run, train=False)
