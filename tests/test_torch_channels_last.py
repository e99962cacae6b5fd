"""The channels-last layout of the port's U-Net in conv-kernel mode
(``VXM_PALLAS_CONV=1``), on the CPU.

The conv kernel computes on ``torch.channels_last_3d`` tensors (NDHWC
storage). In that mode the U-Net keeps the layout from its input to its
output, in the forward and the backward, so that the conv wrapper never
copies an input or a cotangent to another layout
(``conv3_same_cf.layout_copies``). The layers between two convs are held to
what they replace: the nearest upsampling bit for bit to
``repeat_interleave``, the model fed channels-last to the model fed NCDHW.
Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu_torch.models.unet import ConvBlock, Unet, _upsample_nearest, max_pool
from voxelmorph_tpu_torch.ops import conv3

CL = torch.channels_last_3d
# the train-step tests' tolerance for a gradient tensor, relative to its
# largest entry (test_train_step_under_the_switch_matches_jax)
GRAD_RTOL = 1e-4


def _channels_last(t):
    return t.is_contiguous(memory_format=CL)


@pytest.fixture
def kernel_mode():
    conv3.set_pallas_conv(True)
    try:
        yield
    finally:
        conv3.set_pallas_conv(None)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("stored", ["contiguous", "channels_last"])
@pytest.mark.parametrize("ndims", [2, 3])
def test_upsample_nearest_equals_repeat_interleave(ndims, stored, channels_last):
    rng = np.random.default_rng(ndims)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 5, 6)[:ndims + 2]).astype(np.float32))
    if stored == "channels_last":
        x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    ref = x
    for d in range(ndims):
        ref = torch.repeat_interleave(ref, 2, dim=d + 2)
    out = _upsample_nearest(x, 2, ndims, channels_last)
    assert torch.equal(out, ref)
    if channels_last:  # the broadcast is taken over (B, *S, C): channels-last storage
        assert out.movedim(1, -1).is_contiguous()
    else:
        assert out.is_contiguous()


def test_max_pool_backward_keeps_channels_last():
    """The tie-splitting backward gives the same gradient in either layout,
    channels-last where asked; ties included (a constant region)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 6, 7, 8)).astype(np.float32)
    x[..., :4, :4, :4] = 1.0
    g = rng.normal(size=(1, 4, 3, 3, 4)).astype(np.float32)
    grads = {}
    for last in (False, True):
        xt = torch.from_numpy(x)
        gt = torch.from_numpy(g)
        if last:
            xt, gt = xt.contiguous(memory_format=CL), gt.contiguous(memory_format=CL)
        xt.requires_grad_()
        out = max_pool(xt, 2, 3, last)
        grads[last], = torch.autograd.grad(out, xt, gt)
    assert _channels_last(grads[True]) and not grads[True].is_contiguous()
    assert torch.equal(grads[True], grads[False])


def _unet():
    return Unet(3, 2, nb_features=[[4, 8, 8], [8, 8, 8, 4, 4]],
                generator=torch.Generator().manual_seed(0))


def test_unet_kernel_mode_keeps_channels_last(kernel_mode):
    """At 16^3: every conv block sees and returns channels-last tensors, a
    forward and backward copy nothing to that layout, and outputs and
    parameter gradients equal those of the model fed NCDHW."""
    rng = np.random.default_rng(1)
    pair = torch.from_numpy(rng.normal(size=(1, 16, 16, 16, 2)).astype(np.float32))
    cot = rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    results = {}
    for fed in ("channels_last", "ncdhw"):
        net = _unet()
        seen = []
        for m in net.modules():
            if isinstance(m, ConvBlock):
                m.register_forward_hook(
                    lambda m, i, o: seen.append((_channels_last(i[0]), _channels_last(o))))
        # the pair arrives as VxmDense builds it: a channels-last view
        x = pair.movedim(-1, 1)
        w = torch.from_numpy(cot).movedim(-1, 1)
        if fed == "ncdhw":
            x, w = x.contiguous(), w.contiguous()
        conv3.conv3_same_cf.layout_copies = 0
        out = net(x)
        (out * w).sum().backward()
        results[fed] = (out.detach(), {n: p.grad for n, p in net.named_parameters()},
                        conv3.conv3_same_cf.layout_copies, seen)
    out, grads, copies, seen = results["channels_last"]
    assert len(seen) == 8 and all(i and o for i, o in seen)
    assert copies == 0 and _channels_last(out)
    assert results["ncdhw"][2] >= 1  # the NCDHW input is copied once, at the first conv
    assert torch.equal(out, results["ncdhw"][0])
    for name, ref in results["ncdhw"][1].items():
        assert ref.abs().max() > 0, name
        assert_rel_close(grads[name].numpy(), ref.numpy(), GRAD_RTOL, name)
