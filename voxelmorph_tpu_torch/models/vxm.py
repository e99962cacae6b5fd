"""VxmDense, the dense unsupervised registration network, and its
semi-supervised segmentation and point-cloud variants.

Counterpart of ``voxelmorph_tpu/models/vxm.py``, in 1, 2 or 3 dimensions:
concat(source, target) ->
U-Net -> flow conv [-> log-sigma head -> sample] -> rescale to the svf and
integration resolutions -> scaling and squaring -> rescale to full
resolution -> warp. Inputs and outputs are channels-last, ``(B, *S, C)``
images and ``(B, *S, N)`` flows, as in the JAX package. The module's
training mode (``model.train()`` / ``model.eval()``) plays the part of the
JAX call's ``train`` argument. ``VxmDenseSemiSupervisedSeg`` adds the warp
of one-hot segmentations at a reduced resolution,
``VxmDenseSemiSupervisedPointCloud`` the signed distances sampled at warped
surface points.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import warp as warp_ops
from ..ops.warp_bounded import MAX_CHANNELS as _MAX_WARP_CHANNELS
from .unet import Unet

__all__ = ["VxmDense", "VxmDenseSemiSupervisedSeg", "VxmDenseSemiSupervisedPointCloud",
           "registration_model", "rescale_flow", "sample_normal"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def rescale_flow(flow: torch.Tensor, factor, batched: bool = True) -> torch.Tensor:
    """Rescale a dense flow by a spatial factor (resize + scale): a batch
    ``(B, *S, N)``, or with ``batched=False`` one flow ``(*S, N)``."""
    if factor == 1:
        return flow
    if batched:
        return torch.stack([warp_ops.rescale_dense_transform(f, factor) for f in flow])
    return warp_ops.rescale_dense_transform(flow, factor)


def sample_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal noise of ``shape`` for the probabilistic flow sample."""
    return torch.randn(shape, generator=generator, device=device)


class VxmDense(nn.Module):
    """Dense unsupervised registration network.

    The constructor takes the JAX module's fields, so a checkpoint's config
    rebuilds the network; ``generator`` draws the initial weights as flax
    initialises them (he-normal convs with zero bias, the flow head
    N(0, 1e-5), the log-sigma head N(0, 1e-10) with bias -10). ``do_res``
    and ``final_activation_function`` are the U-Net's (the JAX package's
    ``Unet`` fields, which its VxmDense leaves at their defaults); a config
    names them only when they are set.
    ``forward(source, target, generator=None)`` returns a dict with
    y_source, (y_target,) svf, preint_flow, postint_flow, pos_flow,
    (neg_flow,) (flow_params,) unet_out and reg. With ``use_probs`` the flow
    is, in training mode, a sample of the predicted distribution with noise
    drawn from ``generator``, and in eval mode its mean. With
    ``fast_warp_phases`` s > 0 (``registration.enable_fast_warp``) the eval
    forward of a 3-D model warps the images as 2^s bounded warps at
    ``fast_warp_halo`` by the 2^s-th root of pos_flow
    (``ops.warp.phase_warp_batched``), on either device; every field output
    is unchanged.
    """

    def __init__(self, inshape: Sequence[int], nb_unet_features=None,
                 nb_unet_levels: Optional[int] = None, unet_feat_mult: int = 1,
                 nb_unet_conv_per_level: int = 1, int_steps: int = 7,
                 svf_resolution: int = 1, int_resolution: int = 2, bidir: bool = False,
                 use_probs: bool = False, src_feats: int = 1, trg_feats: int = 1,
                 fill_value: Optional[float] = None, reg_field: str = "preintegrated",
                 hyper: bool = False, dtype=torch.float32, fast_warp_phases: int = 0,
                 fast_warp_halo: int = 2, do_res: bool = False,
                 final_activation_function: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ndims = len(inshape)
        if ndims not in (1, 2, 3):
            raise ValueError(f"ndims should be one of 1, 2, or 3. found: {ndims}")
        if hyper:
            raise NotImplementedError("HyperMorph (hyper=True) is not ported yet")
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
        if do_res:
            self.config["do_res"] = do_res
        if final_activation_function is not None:
            self.config["final_activation_function"] = final_activation_function
        self.ndims = ndims
        self.inshape = tuple(inshape)
        self.int_steps = int_steps
        self.svf_resolution = svf_resolution
        self.int_resolution = int_resolution
        self.bidir = bidir
        self.use_probs = use_probs
        self.fill_value = fill_value
        self.reg_field = reg_field
        self.dtype = dtype
        self.fast_warp_phases = fast_warp_phases
        self.fast_warp_halo = fast_warp_halo

        # decoder upsamplings to skip so the unet emits at svf resolution
        nb_upsample_skips = int(np.floor(np.log(svf_resolution) / np.log(2)))
        self.unet = Unet(ndims, src_feats + trg_feats, nb_features=nb_unet_features,
                         nb_levels=nb_unet_levels, feat_mult=unet_feat_mult,
                         nb_conv_per_level=nb_unet_conv_per_level, do_res=do_res,
                         nb_upsample_skips=nb_upsample_skips,
                         final_activation_function=final_activation_function, dtype=dtype,
                         generator=generator)
        nf = self.unet.out_features
        conv_cls = getattr(nn, f"Conv{ndims}d")
        self.flow = conv_cls(nf, ndims, 3, padding=1)
        with torch.no_grad():
            self.flow.weight.normal_(0.0, 1e-5, generator=generator)
            self.flow.bias.zero_()
        if use_probs:
            self.log_sigma = conv_cls(nf, ndims, 3, padding=1)
            with torch.no_grad():
                self.log_sigma.weight.normal_(0.0, 1e-10, generator=generator)
                self.log_sigma.bias.fill_(-10.0)

    def forward(self, source: torch.Tensor, target: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        x = torch.cat([source, target], dim=-1).movedim(-1, 1)
        x = self.unet(x).float()
        outputs = {"unet_out": x.movedim(1, -1)}
        conv = getattr(F, f"conv{self.ndims}d")
        flow = conv(x, self.flow.weight, self.flow.bias, padding=1).movedim(1, -1)
        if self.use_probs:
            logsigma = conv(x, self.log_sigma.weight, self.log_sigma.bias,
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

        # the phase warp (fast_warp_phases, eval mode only): the last s
        # squarings move from the field to the image, 2^s bounded warps of
        # the image by the s-th intermediate field, the 2^s-th root of
        # pos_flow; pos_flow and every field output are unchanged
        fast_s = 0
        if (not self.training and self.fast_warp_phases > 0 and self.int_steps > 0
                and self.ndims == 3 and self.fill_value is None
                and source.shape[-1] <= _MAX_WARP_CHANNELS):
            fast_s = min(int(self.fast_warp_phases), self.int_steps)

        def integrate(v):
            """(the integrated field, its 2^fast_s-th root or None)"""
            if fast_s:
                return warp_ops.integrate_vec_batched(v, nb_steps=self.int_steps,
                                                      return_root_steps=fast_s)
            return warp_ops.integrate_vec_batched(v, nb_steps=self.int_steps), None

        pos_root = neg_root = None
        if self.int_steps > 0:
            pos_flow, pos_root = integrate(pos_flow)
            if self.bidir:
                neg_flow, neg_root = integrate(neg_flow)
        outputs["postint_flow"] = pos_flow

        # back to full resolution
        if self.int_steps > 0 and self.int_resolution > 1:
            factor = self.inshape[0] / int_size[0]
            pos_flow = rescale_flow(pos_flow, factor)
            if pos_root is not None:
                pos_root = rescale_flow(pos_root, factor)
            if self.bidir:
                neg_flow = rescale_flow(neg_flow, factor)
                if neg_root is not None:
                    neg_root = rescale_flow(neg_root, factor)

        # training warps the image in float32, serving in the model's compute
        # dtype, as JAX does
        img_dtype = torch.float32 if self.training else self.dtype

        def warp(img, w, root):
            img = img.to(img_dtype)
            if fast_s:
                return warp_ops.phase_warp_batched(img, root, w, 2 ** fast_s,
                                                   self.fast_warp_halo)
            return warp_ops.transform_batched(img, w, fill_value=self.fill_value).float()

        outputs["y_source"] = warp(source, pos_flow, pos_root)
        outputs["pos_flow"] = pos_flow
        if self.bidir:
            outputs["y_target"] = warp(target, neg_flow, neg_root)
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


class VxmDenseSemiSupervisedSeg(nn.Module):
    """VxmDense plus the warp of downsampled one-hot segmentations.

    The network is a ``VxmDense`` held as ``self.vxm`` (the JAX module's
    ``vxm`` submodule, so checkpoint keys are ``vxm||...``), bidirectional
    when ``bidir`` or ``bidir_labels``. ``forward(source, target, src_seg,
    trg_seg=None, generator=None)`` returns VxmDense's outputs plus
    'y_seg_source', ``src_seg`` ``(B, *S/seg_resolution, nb_labels)`` warped
    (linear) by pos_flow rescaled to the segmentation's resolution, and with
    ``bidir_labels`` 'y_seg_target', ``trg_seg`` warped by neg_flow.
    """

    def __init__(self, inshape: Sequence[int], nb_labels: int, nb_unet_features=None,
                 seg_resolution: int = 2, bidir: bool = False, bidir_labels: bool = False,
                 int_steps: int = 7, int_resolution: int = 2, use_probs: bool = False,
                 src_feats: int = 1, trg_feats: int = 1, reg_field: str = "preintegrated",
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vxm = VxmDense(inshape, nb_unet_features=nb_unet_features,
                            bidir=bidir or bidir_labels, int_steps=int_steps,
                            int_resolution=int_resolution, use_probs=use_probs,
                            src_feats=src_feats, trg_feats=trg_feats, reg_field=reg_field,
                            dtype=dtype, generator=generator)
        self.config = dict(
            inshape=tuple(inshape), nb_labels=nb_labels, nb_unet_features=nb_unet_features,
            seg_resolution=seg_resolution, bidir=bidir, bidir_labels=bidir_labels,
            int_steps=int_steps, int_resolution=int_resolution, use_probs=use_probs,
            src_feats=src_feats, trg_feats=trg_feats, reg_field=reg_field,
            dtype=self.vxm.dtype)
        self.inshape = tuple(inshape)
        self.nb_labels = nb_labels
        self.seg_resolution = seg_resolution
        self.bidir = bidir
        self.bidir_labels = bidir_labels

    def forward(self, source: torch.Tensor, target: torch.Tensor, src_seg: torch.Tensor,
                trg_seg: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        out = self.vxm(source, target, generator=generator)
        seg_flow = rescale_flow(out["pos_flow"], 1.0 / self.seg_resolution)
        out["y_seg_source"] = warp_ops.transform_batched(src_seg.float(), seg_flow)
        if self.bidir_labels:
            if trg_seg is None:
                raise ValueError("bidir_labels requires a target segmentation input")
            neg_seg_flow = rescale_flow(out["neg_flow"], 1.0 / self.seg_resolution)
            out["y_seg_target"] = warp_ops.transform_batched(trg_seg.float(), neg_seg_flow)
        return out


class VxmDenseSemiSupervisedPointCloud(nn.Module):
    """Bidirectional VxmDense plus distances sampled at warped surface points.

    The network is a bidirectional ``VxmDense`` held as ``self.vxm`` (the
    JAX module's ``vxm`` submodule, so checkpoint keys are ``vxm||...``).
    ``forward(source, target, subj_dt, atl_dt, subj_surface, atlas_surface,
    generator=None)``, with the inputs of ``generators.surf_semisupervised``
    in its order, returns VxmDense's outputs plus 'warped_atl_surface', the
    atlas's points ``(B, M, N + 1)`` moved by pos_flow (points move the
    opposite way to images), and 'subj_dt_value', the subject's SDTs
    ``(B, *S', L)`` sampled (linear, magnitude) there, the last point column
    choosing the label's channel; with ``surf_bidir`` also
    'warped_subj_surface' and 'atl_dt_value', the subject's points by
    neg_flow on the atlas's SDTs. Without ``surf_bidir`` the generator gives
    four inputs, (source, target, subj_dt, atlas_surface), which the forward
    takes in that order too.
    """

    def __init__(self, inshape: Sequence[int], nb_surface_points: int, nb_labels_sample: int,
                 nb_unet_features=None, sdt_vol_resize: float = 1.0, surf_bidir: bool = True,
                 int_steps: int = 7, int_resolution: int = 2, use_probs: bool = False,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vxm = VxmDense(inshape, nb_unet_features=nb_unet_features, bidir=True,
                            int_steps=int_steps, int_resolution=int_resolution,
                            use_probs=use_probs, dtype=dtype, generator=generator)
        self.config = dict(
            inshape=tuple(inshape), nb_surface_points=nb_surface_points,
            nb_labels_sample=nb_labels_sample, nb_unet_features=nb_unet_features,
            sdt_vol_resize=sdt_vol_resize, surf_bidir=surf_bidir, int_steps=int_steps,
            int_resolution=int_resolution, use_probs=use_probs, dtype=self.vxm.dtype)
        self.inshape = tuple(inshape)
        self.nb_surface_points = nb_surface_points
        self.nb_labels_sample = nb_labels_sample
        self.sdt_vol_resize = sdt_vol_resize
        self.surf_bidir = surf_bidir

    def _sample(self, dts: torch.Tensor, pts: torch.Tensor, flow: torch.Tensor):
        """(points moved by flow, dts sampled there), per batch element."""
        moved = torch.stack([warp_ops.point_spatial_transformer(
            p, f, sdt_vol_resize=self.sdt_vol_resize) for p, f in zip(pts, flow)])
        values = torch.stack([warp_ops.value_at_location(v, p) for v, p in zip(dts, moved)])
        return moved, values

    def forward(self, source: torch.Tensor, target: torch.Tensor, subj_dt: torch.Tensor,
                atl_dt: Optional[torch.Tensor] = None, subj_surface: Optional[torch.Tensor] = None,
                atlas_surface: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        if not self.surf_bidir and atlas_surface is None:
            atlas_surface, atl_dt = atl_dt, None
        out = self.vxm(source, target, generator=generator)
        out["warped_atl_surface"], out["subj_dt_value"] = self._sample(
            subj_dt.float(), atlas_surface.float(), out["pos_flow"])
        if self.surf_bidir:
            out["warped_subj_surface"], out["atl_dt_value"] = self._sample(
                atl_dt.float(), subj_surface.float(), out["neg_flow"])
        return out


def registration_model(model: nn.Module):
    """The net that registers image pairs inside a semi-supervised model,
    and its weights: ``(VxmDense, state dict)``. Deployment registers plain
    pairs; the segmentation and surface inputs exist only for training."""
    name = type(model).__name__
    if name in ("VxmDenseSemiSupervisedSeg", "VxmDenseSemiSupervisedPointCloud"):
        return model.vxm, model.vxm.state_dict()
    raise ValueError(f"no registration extraction for {name}")
