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
surface points. ``InstanceDense`` optimises one flow field, with no network,
for one pair, and ``Transform`` applies a dense or affine transform.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import warp as warp_ops
from ..ops.affine import is_affine_shape, rescale_affine
from ..ops.warp_bounded import MAX_CHANNELS as _MAX_WARP_CHANNELS
from ..parallel import mesh as mesh_lib
from ..parallel.mesh import draw_rows
from .unet import Unet

__all__ = ["VxmDense", "VxmDenseSemiSupervisedSeg", "VxmDenseSemiSupervisedPointCloud",
           "InstanceDense", "Transform", "registration_model", "rescale_flow",
           "sample_normal"]

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
    """Standard normal noise of ``shape`` for the probabilistic flow sample;
    in a train step over several ranks, this rank's rows of the global
    batch's noise (``parallel.mesh.draw_rows``)."""
    return draw_rows(lambda batch: torch.randn((batch, *shape[1:]), generator=generator,
                                               device=device), shape[0])


class VxmDense(nn.Module):
    """Dense unsupervised registration network.

    The constructor takes the JAX module's fields, so a checkpoint's config
    rebuilds the network; ``generator`` draws the initial weights as flax
    initialises them (he-normal convs with zero bias, the flow head
    N(0, 1e-5), the log-sigma head N(0, 1e-10) with bias -10). ``do_res``
    and ``final_activation_function`` are the U-Net's (the JAX package's
    ``Unet`` fields, which its VxmDense leaves at their defaults); a config
    names them only when they are set.
    ``forward(source, target, hyp=None, generator=None)`` returns a dict
    with y_source, (y_target,) svf, preint_flow, postint_flow, pos_flow,
    (neg_flow,) (flow_params,) unet_out and reg. With ``hyper`` the U-Net's
    convs are HyperConvs of the embedding ``hyp`` ``(B, nb_hyp_units)``
    (``models.hyper.HyperVxmDense`` makes it); flax infers that width from
    the input, so it is a constructor argument here, left out of
    ``config`` as the JAX module has no such field. With ``use_probs`` the flow
    is, in training mode, a sample of the predicted distribution with noise
    drawn from ``generator``, and in eval mode its mean. With
    ``fast_warp_phases`` s > 0 (``registration.enable_fast_warp``) the eval
    forward of a 3-D model warps the images as 2^s bounded warps at
    ``fast_warp_halo`` by the 2^s-th root of pos_flow
    (``ops.warp.phase_warp_batched``), on either device; every field output
    is unchanged.

    Over a mesh's 'space' axis (``parallel.mesh.spatial``) the source and
    the target arrive as this rank's slabs (``slab_inputs``); the U-Net and
    the flow heads run on them, and every parameter's gradient on a rank is
    its slab's part (none is used whole: ``whole_parameters``).
    """

    slab_inputs = (0, 1)

    def __init__(self, inshape: Sequence[int], nb_unet_features=None,
                 nb_unet_levels: Optional[int] = None, unet_feat_mult: int = 1,
                 nb_unet_conv_per_level: int = 1, int_steps: int = 7,
                 svf_resolution: int = 1, int_resolution: int = 2, bidir: bool = False,
                 use_probs: bool = False, src_feats: int = 1, trg_feats: int = 1,
                 fill_value: Optional[float] = None, reg_field: str = "preintegrated",
                 hyper: bool = False, dtype=torch.float32, fast_warp_phases: int = 0,
                 fast_warp_halo: int = 2, do_res: bool = False,
                 final_activation_function: Optional[str] = None,
                 nb_hyp_units: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        ndims = len(inshape)
        if ndims not in (1, 2, 3):
            raise ValueError(f"ndims should be one of 1, 2, or 3. found: {ndims}")
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
        self.hyper = hyper
        self.nb_hyp_units = nb_hyp_units

        # decoder upsamplings to skip so the unet emits at svf resolution
        nb_upsample_skips = int(np.floor(np.log(svf_resolution) / np.log(2)))
        self.unet = Unet(ndims, src_feats + trg_feats, nb_features=nb_unet_features,
                         nb_levels=nb_unet_levels, feat_mult=unet_feat_mult,
                         nb_conv_per_level=nb_unet_conv_per_level, do_res=do_res,
                         nb_upsample_skips=nb_upsample_skips,
                         final_activation_function=final_activation_function, dtype=dtype,
                         generator=generator, hyper=hyper, nb_hyp_units=nb_hyp_units)
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

    @property
    def slab_align(self) -> int:
        """The unit, in planes, of the slabs of a spatially sharded forward
        (the U-Net's ``slab_align``); ``shard_batch(spatial=True)`` takes it
        as ``align``."""
        return self.unet.slab_align

    @property
    def slab_depth(self) -> int:
        """The first spatial dim of the volume the slabs cut."""
        return self.inshape[0]

    def whole_parameters(self):
        """The parameters used whole on every rank of a row: none."""
        return []

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of an input ``x`` ``(B, *inshape, C)`` computed
        whole on every rank of the row (``parallel.mesh.slab_of``; x itself
        outside ``spatial``)."""
        return mesh_lib.slab_of(x, 1, self.slab_align)

    def _slabs_forward(self, source, target, hyp, outputs):
        """The U-Net and the flow heads: ``(flow, logsigma or None, source,
        target)``, channels-last. Inside ``parallel.mesh.spatial`` the
        inputs are this rank's slabs; the heads convolve the U-Net's slab
        widened by its neighbours' planes, and the fields and images come
        back whole on every rank of the data row (``gather_space``)."""
        with mesh_lib.slabs(self.inshape[0], self.slab_align) as space:
            if space is not None and source.shape[1] != space.hi - space.lo:
                raise ValueError(
                    f"a slab of {source.shape[1]} planes where this rank's slab of "
                    f"{self.inshape[0]} is {space.lo}:{space.hi}: shard the inputs with "
                    f"shard_batch(spatial=True, align={self.slab_align})")
            x = self.unet(torch.cat([source, target], dim=-1).movedim(-1, 1), hyp).float()
            outputs["unet_out"] = x.movedim(1, -1)
            conv = getattr(F, f"conv{self.ndims}d")
            padding = 1
            if space is not None:
                x = mesh_lib.halo_exchange(x, 1, 2, space)
                padding = (0,) + (1,) * (self.ndims - 1)
            heads = [conv(x, head.weight, head.bias, padding=padding) for head in
                     [self.flow] + ([self.log_sigma] if self.use_probs else [])]
            fields = (torch.cat(heads, dim=1) if self.use_probs else heads[0]).movedim(1, -1)
            if space is not None:
                fields = mesh_lib.gather_space(fields, 1, space)
                images = mesh_lib.gather_space(torch.cat([source, target], dim=-1), 1, space)
                source, target = images.split([source.shape[-1], target.shape[-1]], dim=-1)
        flow, logsigma = (fields.split(self.ndims, dim=-1) if self.use_probs
                          else (fields, None))
        return flow, logsigma, source, target

    def forward(self, source: torch.Tensor, target: torch.Tensor,
                hyp: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        outputs = {}
        flow, logsigma, source, target = self._slabs_forward(source, target, hyp, outputs)
        if self.use_probs:
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


class VxmSlabs:
    """The slab protocol (``parallel.mesh``) of a model built around a
    VxmDense ``vxm``: the source and the target, its first two inputs,
    arrive as slabs of ``vxm``'s volume, and no parameter is used whole on
    every rank of a row (a class that uses some overrides
    ``whole_parameters``)."""

    slab_inputs = (0, 1)

    @property
    def slab_align(self) -> int:
        return self.vxm.slab_align

    @property
    def slab_depth(self) -> int:
        return self.vxm.slab_depth

    def whole_parameters(self):
        return []


class VxmDenseSemiSupervisedSeg(VxmSlabs, nn.Module):
    """VxmDense plus the warp of downsampled one-hot segmentations.

    The network is a ``VxmDense`` held as ``self.vxm`` (the JAX module's
    ``vxm`` submodule, so checkpoint keys are ``vxm||...``), bidirectional
    when ``bidir`` or ``bidir_labels``. ``forward(source, target, src_seg,
    trg_seg=None, generator=None)`` returns VxmDense's outputs plus
    'y_seg_source', ``src_seg`` ``(B, *S/seg_resolution, nb_labels)`` warped
    (linear) by pos_flow rescaled to the segmentation's resolution, and with
    ``bidir_labels`` 'y_seg_target', ``trg_seg`` warped by neg_flow. Over a
    mesh's 'space' axis the source and the target arrive as slabs, the
    segmentations whole: their warps run on the whole field.
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


class VxmDenseSemiSupervisedPointCloud(VxmSlabs, nn.Module):
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
    takes in that order too. Over a mesh's 'space' axis the source and the
    target arrive as slabs, the SDTs and the points whole: the sampling runs
    on the whole field.
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


class InstanceDense(nn.Module):
    """Instance-specific optimisation: a learned flow field and no network.

    The parameter ``flow`` ``(1, *round(inshape / int_resolution), N)``,
    drawn N(0, 1e-5) as flax draws it, is scaled by ``mult``, repeated over
    the batch, integrated by ``int_steps`` squarings (the tiered warp, so the
    bounded-warp kernels on CUDA tensors), rescaled to full resolution and
    applies to the source. ``forward(source, generator=None)`` returns
    y_source, preint_flow, pos_flow and reg (the preintegrated flow). As in
    the JAX package, with ``int_steps=0`` nothing is rescaled: pos_flow stays
    on the flow's grid and y_source is sampled there (a grid of half the
    size with ``int_resolution=2``).

    It has no network to shard: over a mesh's 'space' axis every rank of a
    row computes the whole of it (the source arrives whole), and the flow's
    gradient, whole on each, is averaged over 'space' (``whole_parameters``).
    """

    slab_inputs = ()
    slab_align = 1

    @property
    def slab_depth(self) -> int:
        return self.inshape[0]

    def whole_parameters(self):
        return [self.flow]

    def __init__(self, inshape: Sequence[int], feats: int = 1, int_steps: int = 7,
                 int_resolution: int = 2, mult: float = 1000.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(inshape=tuple(inshape), feats=feats, int_steps=int_steps,
                           int_resolution=int_resolution, mult=mult)
        self.inshape = tuple(inshape)
        self.int_steps = int_steps
        self.int_resolution = int_resolution
        self.mult = mult
        self.flow_shape = tuple(int(np.round(d / int_resolution)) for d in inshape)
        self.flow = nn.Parameter(torch.empty((1, *self.flow_shape, len(inshape))))
        with torch.no_grad():
            self.flow.normal_(0.0, 1e-5, generator=generator)

    def forward(self, source: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        preint_flow = (self.flow * self.mult).repeat(source.shape[0], *[1] * (self.flow.dim() - 1))
        pos_flow = preint_flow
        if self.int_steps > 0:
            pos_flow = warp_ops.integrate_vec_batched(pos_flow, nb_steps=self.int_steps)
            if self.int_resolution > 1:
                pos_flow = rescale_flow(pos_flow, self.inshape[0] / self.flow_shape[0])
        y_source = warp_ops.transform_batched(source.float(), pos_flow)
        return {"y_source": y_source, "preint_flow": preint_flow, "pos_flow": pos_flow,
                "reg": preint_flow}

    @staticmethod
    def flow_from_warp(warp, mult: float = 1000.0):
        """The stored parameter of an existing (preintegrated) flow."""
        return warp / mult

    def set_flow(self, warp) -> None:
        """Set the parameter, in place, from a preintegrated flow ``(1, *S, N)``
        or ``(*S, N)`` on the flow's grid (a warm start)."""
        if not torch.is_tensor(warp):
            warp = torch.as_tensor(np.asarray(warp, np.float32))
        with torch.no_grad():
            self.flow.copy_(self.flow_from_warp(warp, self.mult).reshape(self.flow.shape))


class Transform(nn.Module):
    """Apply a transform to images, for inference: ``forward(img, trf)`` with
    img ``(B, *S, C)`` and trf a batch of affine matrices ``(B, N, N+1)`` or
    dense displacements ``(B, *S', N)``. ``rescale`` scales the transform
    first (``ops.affine.rescale_affine`` or ``rescale_flow``). A dense field
    on the image's grid warps through ``transform_batched``, the tiered warp
    (its kernels on CUDA tensors); anything else through ``transform`` per
    sample, on the gather. No parameters."""

    def __init__(self, interp_method: str = "linear", rescale: Optional[float] = None,
                 fill_value: Optional[float] = None, shift_center: bool = True):
        super().__init__()
        self.interp_method = interp_method
        self.rescale = rescale
        self.fill_value = fill_value
        self.shift_center = shift_center

    def forward(self, img: torch.Tensor, trf: torch.Tensor) -> torch.Tensor:
        affine = is_affine_shape(tuple(trf.shape[1:]))
        if self.rescale is not None and self.rescale != 1:
            trf = rescale_affine(trf, self.rescale) if affine else rescale_flow(trf, self.rescale)
        if not affine and tuple(trf.shape[1:-1]) == tuple(img.shape[1:-1]):
            return warp_ops.transform_batched(img, trf, interp_method=self.interp_method,
                                              fill_value=self.fill_value)
        return torch.stack([warp_ops.transform(
            i, t, interp_method=self.interp_method, fill_value=self.fill_value,
            shift_center=self.shift_center, window_halo=None) for i, t in zip(img, trf)])


def registration_model(model: nn.Module):
    """The net that registers image pairs inside a semi-supervised model,
    and its weights: ``(VxmDense, state dict)``. Deployment registers plain
    pairs; the segmentation and surface inputs exist only for training."""
    name = type(model).__name__
    if name in ("VxmDenseSemiSupervisedSeg", "VxmDenseSemiSupervisedPointCloud"):
        return model.vxm, model.vxm.state_dict()
    raise ValueError(f"no registration extraction for {name}")
