"""``conv_roofline.dp`` (%): the conv layer's share of its roofline in
data-parallel training: the least time of this rank's share of the U-Net's
conv work (forward, dx, dw) over the device time of the conv layer's
kernels on this rank, averaged over the ranks."""

from h100_bench import flops


def read(run):
    return flops.conv_share(run, train=True)
