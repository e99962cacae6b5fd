"""VxmDense, the dense unsupervised registration network.

Counterpart of ``voxelmorph_tpu/models/vxm.py``: concat(source, target) ->
U-Net -> flow conv [-> log-sigma head -> sample] -> rescale to the svf and
integration resolutions -> scaling and squaring -> rescale to full
resolution -> warp. Inputs and outputs are channels-last, ``(B, *S, C)``
images and ``(B, *S, N)`` flows, as in the JAX package. The module's
training mode (``model.train()`` / ``model.eval()``) plays the part of the
JAX call's ``train`` argument.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import warp as warp_ops
from .unet import Unet

__all__ = ["VxmDense", "rescale_flow", "sample_normal"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def rescale_flow(flow: torch.Tensor, factor) -> torch.Tensor:
    """Rescale a (batched) dense flow by a spatial factor (resize + scale)."""
    if factor == 1:
        return flow
    return warp_ops.rescale_dense_transform(flow, factor)


def sample_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal noise of ``shape`` for the probabilistic flow sample."""
    return torch.randn(shape, generator=generator, device=device)


class VxmDense(nn.Module):
    """Dense unsupervised registration network.

    The constructor takes the JAX module's fields, so a checkpoint's config
    rebuilds the network; ``generator`` draws the initial weights as flax
    initialises them (he-normal convs with zero bias, the flow head
    N(0, 1e-5), the log-sigma head N(0, 1e-10) with bias -10).
    ``forward(source, target, generator=None)`` returns a dict with
    y_source, (y_target,) svf, preint_flow, postint_flow, pos_flow,
    (neg_flow,) (flow_params,) unet_out and reg. With ``use_probs`` the flow
    is, in training mode, a sample of the predicted distribution with noise
    drawn from ``generator``, and in eval mode its mean.
    """

    def __init__(self, inshape: Sequence[int], nb_unet_features=None,
                 nb_unet_levels: Optional[int] = None, unet_feat_mult: int = 1,
                 nb_unet_conv_per_level: int = 1, int_steps: int = 7,
                 svf_resolution: int = 1, int_resolution: int = 2, bidir: bool = False,
                 use_probs: bool = False, src_feats: int = 1, trg_feats: int = 1,
                 fill_value: Optional[float] = None, reg_field: str = "preintegrated",
                 hyper: bool = False, dtype=torch.float32, fast_warp_phases: int = 0,
                 fast_warp_halo: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        ndims = len(inshape)
        if ndims != 3:
            raise NotImplementedError(f"the PyTorch VxmDense is 3-D, got inshape {inshape}")
        if hyper:
            raise NotImplementedError("HyperMorph (hyper=True) is not ported yet")
        if fast_warp_phases > 0 or fast_warp_halo != 2:
            raise NotImplementedError("fast_warp_phases > 0 and fast_warp_halo (the phase "
                                      "warp) are not ported yet")
        if reg_field.lower() not in ("svf", "preintegrated", "postintegrated", "warp"):
            raise ValueError(f'Unknown option "{reg_field}" for reg_field.')
        dtype = _DTYPES.get(dtype, dtype)
        self.config = dict(
            inshape=tuple(inshape), nb_unet_features=nb_unet_features,
            nb_unet_levels=nb_unet_levels, unet_feat_mult=unet_feat_mult,
            nb_unet_conv_per_level=nb_unet_conv_per_level, int_steps=int_steps,
            svf_resolution=svf_resolution, int_resolution=int_resolution, bidir=bidir,
            use_probs=use_probs, src_feats=src_feats, trg_feats=trg_feats,
            fill_value=fill_value, reg_field=reg_field, hyper=hyper, dtype=dtype,
            fast_warp_phases=fast_warp_phases, fast_warp_halo=fast_warp_halo)
        self.inshape = tuple(inshape)
        self.int_steps = int_steps
        self.svf_resolution = svf_resolution
        self.int_resolution = int_resolution
        self.bidir = bidir
        self.use_probs = use_probs
        self.fill_value = fill_value
        self.reg_field = reg_field
        self.dtype = dtype

        # decoder upsamplings to skip so the unet emits at svf resolution
        nb_upsample_skips = int(np.floor(np.log(svf_resolution) / np.log(2)))
        self.unet = Unet(ndims, src_feats + trg_feats, nb_features=nb_unet_features,
                         nb_levels=nb_unet_levels, feat_mult=unet_feat_mult,
                         nb_conv_per_level=nb_unet_conv_per_level,
                         nb_upsample_skips=nb_upsample_skips, dtype=dtype,
                         generator=generator)
        nf = self.unet.out_features
        self.flow = nn.Conv3d(nf, ndims, 3, padding=1)
        with torch.no_grad():
            self.flow.weight.normal_(0.0, 1e-5, generator=generator)
            self.flow.bias.zero_()
        if use_probs:
            self.log_sigma = nn.Conv3d(nf, ndims, 3, padding=1)
            with torch.no_grad():
                self.log_sigma.weight.normal_(0.0, 1e-10, generator=generator)
                self.log_sigma.bias.fill_(-10.0)

    def forward(self, source: torch.Tensor, target: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        x = torch.cat([source, target], dim=-1).movedim(-1, 1)
        x = self.unet(x).float()
        outputs = {"unet_out": x.movedim(1, -1)}
        flow = F.conv3d(x, self.flow.weight, self.flow.bias, padding=1).movedim(1, -1)
        if self.use_probs:
            logsigma = F.conv3d(x, self.log_sigma.weight, self.log_sigma.bias,
                                padding=1).movedim(1, -1)
            outputs["flow_params"] = torch.cat([flow, logsigma], dim=-1)
            if self.training:
                eps = sample_normal(flow.shape, generator, flow.device)
                flow = flow + torch.exp(logsigma / 2.0) * eps

        # rescale to the exact svf grid if the unet grid differs (rounding)
        pre_svf_size = np.array(flow.shape[1:-1])
        svf_size = np.array([int(np.round(d / self.svf_resolution)) for d in self.inshape])
        if not np.array_equal(pre_svf_size, svf_size):
            flow = rescale_flow(flow, svf_size[0] / pre_svf_size[0])
        outputs["svf"] = flow

        # rescale to integration resolution
        int_size = np.array([int(np.round(d / self.int_resolution)) for d in self.inshape])
        if self.int_steps > 0 and self.int_resolution > 1 and \
                not np.array_equal(svf_size, int_size):
            flow = rescale_flow(flow, int_size[0] / svf_size[0])
        outputs["preint_flow"] = flow

        pos_flow = flow
        neg_flow = -flow if self.bidir else None
        if self.int_steps > 0:
            pos_flow = warp_ops.integrate_vec_batched(pos_flow, nb_steps=self.int_steps)
            if self.bidir:
                neg_flow = warp_ops.integrate_vec_batched(neg_flow, nb_steps=self.int_steps)
        outputs["postint_flow"] = pos_flow

        # back to full resolution
        if self.int_steps > 0 and self.int_resolution > 1:
            factor = self.inshape[0] / int_size[0]
            pos_flow = rescale_flow(pos_flow, factor)
            if self.bidir:
                neg_flow = rescale_flow(neg_flow, factor)

        # training warps the image in float32, serving in the model's compute
        # dtype, as JAX does
        img_dtype = torch.float32 if self.training else self.dtype

        def warp(img, w):
            return warp_ops.transform_batched(
                img.to(img_dtype), w, fill_value=self.fill_value).float()

        outputs["y_source"] = warp(source, pos_flow)
        outputs["pos_flow"] = pos_flow
        if self.bidir:
            outputs["y_target"] = warp(target, neg_flow)
            outputs["neg_flow"] = neg_flow

        if self.use_probs:
            outputs["reg"] = outputs["flow_params"]
        else:
            outputs["reg"] = {
                "svf": outputs["svf"],
                "preintegrated": outputs["preint_flow"],
                "postintegrated": outputs["postint_flow"],
                "warp": pos_flow,
            }[self.reg_field.lower()]
        return outputs
