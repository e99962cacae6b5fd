"""The yardstick's arithmetic: published peaks of one H100 and the work of
the 3x3x3 convolutions of a VoxelMorph U-Net, counted from shapes.

Frozen here, beside the benchmark, so that no change to the program can move
it. The peaks and ``conv_least_s`` are those ``chip_smoke.py`` used
(``HBM_BYTES_PER_S``, ``BF16_TENSOR_FLOPS_PER_S``, ``TF32_TENSOR_FLOPS_PER_S``,
``conv_bound``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS_PER_S = 989e12
TF32_TENSOR_FLOPS_PER_S = 494.7e12
# float32 accuracy on the tensor cores takes three TF32 passes (the 3xTF32
# split of a product into a high and a low part); that is the fastest route
# to a float32-accurate convolution on this card, so it is the rate against
# which no float32 implementation can read above 1.
F32_FLOPS_PER_S = TF32_TENSOR_FLOPS_PER_S / 3

PEAK_FLOPS_PER_S = {"bfloat16": BF16_TENSOR_FLOPS_PER_S, "float32": F32_FLOPS_PER_S}
BYTES_PER_ELEMENT = {"bfloat16": 2, "float32": 4}


class Conv:
    """One 3x3x3 SAME convolution: ``ci`` -> ``co`` channels over ``voxels``
    output voxels (stride 1, so input voxels are as many), ``name`` its
    block."""

    def __init__(self, name: str, ci: int, co: int, shape: Sequence[int]):
        self.name = name
        self.ci = int(ci)
        self.co = int(co)
        self.shape = tuple(int(s) for s in shape)
        self.voxels = math.prod(self.shape)

    @property
    def flops(self) -> float:
        """2 * 27 * ci * co operations a voxel (a multiply and an add a tap)."""
        return 2.0 * 27 * self.ci * self.co * self.voxels

    def __repr__(self):
        return f"Conv({self.name}, {self.ci}->{self.co}, {self.shape})"


def unet_convs(inshape: Sequence[int], in_channels: int, enc: Sequence[int],
               dec: Sequence[int], svf_resolution: int = 1) -> List[Conv]:
    """The convolutions of the VoxelMorph U-Net (one conv a level, max pools
    of 2): the encoder at full, 1/2, 1/4 ... resolution; the decoder back up,
    each conv's output upsampled and concatenated with the skip of the
    level above, the last ``log2(svf_resolution)`` upsamplings skipped; then
    the final convs at the resolution reached."""
    nb_dec = len(enc)
    skips_up = int(math.floor(math.log(svf_resolution) / math.log(2)))
    shapes = [tuple(int(s) // 2 ** k for s in inshape) for k in range(nb_dec + 1)]
    convs, ch, skip_ch = [], in_channels, []
    for level, nf in enumerate(enc):
        convs.append(Conv(f"enc_conv_{level}_0", ch, nf, shapes[level]))
        ch = nf
        skip_ch.append(ch)
    for level in range(nb_dec):
        real = nb_dec - 1 - level
        convs.append(Conv(f"dec_conv_{real}_0", ch, dec[level], shapes[real + 1]))
        ch = dec[level]
        at = real + 1
        if level < nb_dec - skips_up:
            ch += skip_ch.pop()
            at = real
    for num, nf in enumerate(dec[nb_dec:]):
        convs.append(Conv(f"dec_final_conv_{num}", ch, nf, shapes[at]))
        ch = nf
    return convs


def head_convs(inshape: Sequence[int], in_channels: int, ndims: int, nb_heads: int,
               svf_resolution: int = 1) -> List[Conv]:
    """The flow head (and, for a probabilistic model, the log-sigma head):
    3x3x3 convs to ``ndims`` channels at the U-Net's output resolution."""
    shape = tuple(int(s) // svf_resolution for s in inshape)
    names = ["flow", "log_sigma"][:nb_heads]
    return [Conv(n, in_channels, ndims, shape) for n in names]


def forward_flops(convs: Sequence[Conv]) -> float:
    return sum(c.flops for c in convs)


def train_flops(convs: Sequence[Conv]) -> float:
    """A training step's convolution work: the forward, the input gradient of
    every conv but the first (whose input is the data) and the weight
    gradient of every conv, each as many operations as the forward.
    Recomputation (the U-Net's per-block remat) is not counted."""
    return 3 * forward_flops(convs) - convs[0].flops


def conv_least_s(conv: Conv, dtype: str) -> float:
    """The least time of one pass of ``conv`` on the card: its operations at
    the peak for ``dtype``, or its bytes (the input read and the output
    written once) at the HBM rate, whichever is longer."""
    nbytes = (conv.ci + conv.co) * conv.voxels * BYTES_PER_ELEMENT[dtype]
    return max(nbytes / HBM_BYTES_PER_S, conv.flops / PEAK_FLOPS_PER_S[dtype])


def dw_least_s(conv: Conv, dtype: str) -> float:
    """The least time of a weight gradient: the forward's operations; it
    reads the input and the output's cotangent and writes 27 ci co weights."""
    nbytes = ((conv.ci + conv.co) * conv.voxels + 27 * conv.ci * conv.co) \
        * BYTES_PER_ELEMENT[dtype]
    return max(nbytes / HBM_BYTES_PER_S, conv.flops / PEAK_FLOPS_PER_S[dtype])


def conv_pass_least_s(convs: Sequence[Conv], dtype: str, train: bool) -> float:
    """The least time of the U-Net's conv work a pair: every forward and, in
    training, every input gradient but the first conv's (the same shape
    read the other way: co in, ci out) and every weight gradient."""
    total = sum(conv_least_s(c, dtype) for c in convs)
    if train:
        total += sum(conv_least_s(Conv(c.name, c.co, c.ci, c.shape), dtype)
                     for c in convs[1:])
        total += sum(dw_least_s(c, dtype) for c in convs)
    return total


def model_convs(config: Dict) -> Tuple[List[Conv], List[Conv]]:
    """(U-Net convs, head convs) of a configuration file's ``model``."""
    m = config["model"]
    inshape = m["inshape"]
    enc, dec = m["nb_unet_features"]
    svf = m.get("svf_resolution", 1)
    unet = unet_convs(inshape, m["src_feats"] + m["trg_feats"], enc, dec, svf)
    heads = head_convs(inshape, unet[-1].co, len(inshape), 2 if m.get("use_probs") else 1, svf)
    return unet, heads


def model_flops(model: Dict, train: bool) -> float:
    """The model's convolution work a pair (U-Net and heads): the forward,
    and in training its input and weight gradients (the heads' input
    gradient included)."""
    unet, heads = model_convs({"model": model})
    if train:
        return train_flops(unet) + 3 * forward_flops(heads)
    return forward_flops(unet) + forward_flops(heads)


def step_share(run, train: bool) -> Optional[float]:
    """The window's model work over what the cell's chips could do in it at
    the peak of its dtype, in percent (``mfu.*``)."""
    if run.trace is None or not run.pairs or run.window_s <= 0:
        return None
    peak = PEAK_FLOPS_PER_S[run.dtype] * run.world
    return 100.0 * model_flops(run.model, train) * run.pairs / (run.window_s * peak)


def conv_share(run, train: bool) -> Optional[float]:
    """The least time of this rank's U-Net conv work in the window (its
    share of the pairs) over the device time of the conv layer's kernels,
    in percent (``conv_roofline.*``)."""
    if run.trace is None or not run.pairs:
        return None
    device_s = run.trace.kernel_seconds(conv_layer)
    if device_s <= 0:
        return None
    unet, _ = model_convs({"model": run.model})
    least = conv_pass_least_s(unet, run.dtype, train) * run.pairs / run.world
    return 100.0 * least / device_s


def conv_layer(kernel) -> bool:
    """A kernel of the conv layer: one of ``csrc/conv3.cu``'s, or any launched
    inside the conv's autograd function (its weight gradient's products,
    its layout and weight preparation, the LeakyReLU's derivative)."""
    return "conv3_" in kernel.name or any(s.startswith("conv3.") for s in kernel.spans)
