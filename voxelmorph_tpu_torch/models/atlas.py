"""Template (atlas) construction and probabilistic atlas segmentation.

Counterpart of ``voxelmorph_tpu/models/atlas.py``. The learnable atlas is a
parameter (``atlas``), and ``MeanStream``'s running mean and count, a flax
variable collection ('stream') in the JAX package, are buffers of the
module: a checkpoint stores them under the JAX Trainer's keys
(``__extra__state||stream||<module path>||mean``; ``modelio.state_to_jax``).
Inputs and outputs are channels-last, as in the JAX package; the module's
training mode plays the part of the JAX call's ``train`` argument.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as mesh_lib
from ..parallel.mesh import batch_mean
from .unet import ConvBlock, lecun_normal_, slab_block
from .vxm import VxmDense, VxmSlabs

__all__ = ["MeanStream", "TemplateCreation", "ConditionalTemplateCreation",
           "ProbAtlasSegmentation", "stream_step"]


class MeanStream(nn.Module):
    """Running mean over training batches with a capped effective window.

    The buffers ``mean`` ``shape`` and ``count`` ``()`` start at zero. In
    training mode each call folds the batch mean of ``x`` ``(B, *shape)`` in
    with weight ``B / count``, where ``count = min(count + B, cap)``, and
    returns ``min(1, count / cap) * mean`` of the updated values, broadcast
    to the batch; the gradient flows into ``x`` through the batch mean, as
    in the JAX package. In a train step over several ranks the batch is the
    global one (``parallel.mesh.batch_mean``), so every rank folds in the
    same mean and count. In eval mode nothing changes and the output is the
    stored mean, so scaled.

    Inside ``stream_step`` (a train step of the ``Trainer``) the update is
    kept aside and written into the buffers when the step ends, so that a
    second forward in the step (a recomputation in the backward) computes
    the same values and the batch is folded in once.
    """

    collection = "stream"

    def __init__(self, shape: Sequence[int], cap: float = 100.0):
        super().__init__()
        self.cap = float(cap)
        self.register_buffer("mean", torch.zeros(tuple(shape)))
        self.register_buffer("count", torch.zeros(()))
        self._in_step = False
        self._pending = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, count = self.mean, self.count
        if self.training:
            bs, x_mean = batch_mean(x.float())
            count = torch.clamp(count + bs, max=self.cap)
            mean = mean + (bs / count) * (x_mean - mean)
            if self._in_step:
                self._pending = mean.detach(), count
            else:
                self._commit(mean.detach(), count)
        scale = torch.clamp(count / self.cap, max=1.0)
        return (scale * mean)[None].expand(x.shape)

    def _commit(self, mean: torch.Tensor, count: torch.Tensor) -> None:
        with torch.no_grad():
            self.mean.copy_(mean)
            self.count.copy_(count)


@contextlib.contextmanager
def stream_step(model: nn.Module):
    """One train step of ``model``: each ``MeanStream`` in it updates its
    buffers once, when the step ends, however many forwards the step runs."""
    streams = [m for m in model.modules() if isinstance(m, MeanStream)]
    for m in streams:
        m._in_step, m._pending = True, None
    try:
        yield
        for m in streams:
            if m._pending is not None:
                m._commit(*m._pending)
    finally:
        for m in streams:
            m._in_step, m._pending = False, None


def _same_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """flax's Conv with SAME padding (the odd voxel at the high end) on
    ``(B, C, *S)``."""
    pads = []
    for k in reversed(conv.kernel_size):
        pads += [(k - 1) // 2, k - 1 - (k - 1) // 2]
    return conv(F.pad(x, pads))


def _flax_conv(ndims: int, cin: int, cout: int, k: int, generator, weak: Optional[float] = None):
    """An unpadded ``Conv{ndims}d`` initialised as flax's ``nn.Conv``:
    lecun-normal kernel and zero bias, or with ``weak`` both N(0, weak)."""
    conv = getattr(nn, f"Conv{ndims}d")(cin, cout, k)
    with torch.no_grad():
        if weak is None:
            lecun_normal_(conv.weight, generator)
            conv.bias.zero_()
        else:
            conv.weight.normal_(0.0, weak, generator=generator)
            conv.bias.normal_(0.0, weak, generator=generator)
    return conv


class TemplateCreation(VxmSlabs, nn.Module):
    """Unconditional deformable template: a learnable atlas registered
    bidirectionally to each scan.

    ``atlas`` ``(1, *inshape, atlas_feats)`` is drawn N(0, 1e-7) and
    repeated over the batch as the moving image of a bidirectional
    ``VxmDense`` (``self.vxm``). ``forward(source, generator=None)`` returns
    its outputs plus 'atlas', 'atlas_tensor' (the batched atlas) and
    'mean_stream', ``MeanStream`` of neg_flow. In a train step the atlas's
    gradient comes from the backward of the full-resolution warp of the
    atlas (the tiered warp's dvol).

    Over a mesh's 'space' axis the scan arrives as this rank's slab and the
    atlas, whole on every rank, enters the U-Net as its slab
    (``parallel.mesh.slab_of``); its gradient, whole on each rank, is
    averaged over 'space' (``whole_parameters``). MeanStream folds in the
    whole neg_flow.
    """

    slab_inputs = (0,)

    def whole_parameters(self):
        return [self.atlas]

    def __init__(self, inshape: Sequence[int], nb_unet_features=None, mean_cap: float = 100.0,
                 atlas_feats: int = 1, src_feats: int = 1, int_steps: int = 7,
                 int_resolution: int = 2, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.inshape = tuple(inshape)
        self.atlas = nn.Parameter(torch.empty((1, *self.inshape, atlas_feats)))
        with torch.no_grad():
            self.atlas.normal_(0.0, 1e-7, generator=generator)
        self.vxm = VxmDense(inshape, nb_unet_features=nb_unet_features, bidir=True,
                            int_steps=int_steps, int_resolution=int_resolution,
                            src_feats=atlas_feats, trg_feats=src_feats, dtype=dtype,
                            generator=generator)
        self.mean_stream = MeanStream((*self.inshape, len(self.inshape)), cap=mean_cap)
        self.config = dict(inshape=self.inshape, nb_unet_features=nb_unet_features,
                           mean_cap=mean_cap, atlas_feats=atlas_feats, src_feats=src_feats,
                           int_steps=int_steps, int_resolution=int_resolution,
                           dtype=self.vxm.dtype)

    def forward(self, source: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        atlas_b = self.atlas.expand(source.shape[0], *self.atlas.shape[1:])
        out = self.vxm(self.vxm.slab(atlas_b), source, generator=generator)
        out["atlas"] = self.atlas
        out["atlas_tensor"] = atlas_b
        out["mean_stream"] = self.mean_stream(out["neg_flow"])
        return out

    def set_atlas(self, atlas) -> None:
        """Set the atlas, in place, from an array of its shape with or
        without the batch axis."""
        if not torch.is_tensor(atlas):
            atlas = torch.as_tensor(np.asarray(atlas, np.float32))
        with torch.no_grad():
            self.atlas.copy_(atlas.reshape(self.atlas.shape))

    def get_atlas(self) -> np.ndarray:
        """The atlas as a numpy array, its unit axes dropped."""
        return self.atlas.detach().cpu().numpy().squeeze()


class ConditionalTemplateCreation(VxmSlabs, nn.Module):
    """Conditional template: a phenotype vector generates an atlas residual
    added to a base atlas, then registered as in ``TemplateCreation``.

    The phenotype goes through ``pheno_dense`` (a Dense layer on its last
    axis to ``prod(conv_image_shape)`` values) and an ELU, is reshaped to the image
    ``conv_image_shape`` (``inshape / 2**conv_nb_levels`` by default, with
    ``conv_nb_features`` channels) and decoded: ``conv_nb_levels`` levels of
    conv + ELU and a 2x nearest repeat, closed by a 1^N conv, then
    ``extra_conv_layers`` convs with no activation, then ``atlas_gen``
    (N(0, 1e-7)). These layers are plain library calls (cuDNN, a matrix
    product), as they are XLA ops in the JAX package.
    ``forward(pheno, atlas, source, generator=None)`` returns the
    ``VxmDense`` outputs of ``atlas + atlas_gen`` against ``source``, plus
    'atlas_tensor' and, with ``use_mean_stream``, 'mean_stream'.

    Over a mesh's 'space' axis the scan arrives as this rank's slab; the
    phenotype, the base atlas and the decoder stay whole on every rank, and
    the atlas tensor enters the U-Net as its slab (``parallel.mesh.slab_of``):
    the decoder's gradients, whole on each rank, are averaged over 'space'
    (``whole_parameters``).
    """

    slab_inputs = (2,)

    def whole_parameters(self):
        return [p for name, p in self.named_parameters() if not name.startswith("vxm.")]

    def __init__(self, inshape: Sequence[int], pheno_input_shape: Sequence[int],
                 nb_unet_features=None, src_feats: int = 1, atlas_feats: Optional[int] = None,
                 conv_image_shape: Optional[Sequence[int]] = None, conv_size: int = 3,
                 conv_nb_levels: int = 0, conv_nb_features: int = 32,
                 extra_conv_layers: int = 3, use_mean_stream: bool = True,
                 mean_cap: float = 100.0, int_steps: int = 7, int_resolution: int = 2,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        ndims = len(inshape)
        self.inshape = tuple(inshape)
        self.ndims = ndims
        self.conv_nb_levels = conv_nb_levels
        self.extra_conv_layers = extra_conv_layers
        self.use_mean_stream = use_mean_stream
        feats = atlas_feats or src_feats
        if conv_image_shape is not None:
            image_shape = tuple(conv_image_shape)
            if len(image_shape) == ndims:
                image_shape += (conv_nb_features,)
        else:
            scale = 2 ** conv_nb_levels
            image_shape = tuple(s // scale for s in self.inshape) + (conv_nb_features,)
        up_shape = tuple(s * 2 ** conv_nb_levels for s in image_shape[:-1])
        if up_shape != self.inshape:
            raise ValueError(
                f"conv_image_shape {image_shape[:-1]} upsampled through {conv_nb_levels} "
                f"levels gives {up_shape}, expected inshape {self.inshape}")
        self.conv_image_shape = image_shape
        nf = image_shape[-1]

        # a Dense layer on the phenotype's last axis, as flax's
        self.pheno_dense = nn.Linear(int(pheno_input_shape[-1]), int(np.prod(image_shape)))
        with torch.no_grad():
            lecun_normal_(self.pheno_dense.weight, generator)
            self.pheno_dense.bias.zero_()
        for n in range(conv_nb_levels):
            self.add_module(f"atlas_dec_conv_{n}",
                            _flax_conv(ndims, nf, conv_nb_features, conv_size, generator))
            nf = conv_nb_features
        if conv_nb_levels:
            self.atlas_dec_likelihood = _flax_conv(ndims, nf, conv_nb_features, 1, generator)
            nf = conv_nb_features
        for n in range(extra_conv_layers):
            self.add_module(f"atlas_extra_conv_{n}",
                            _flax_conv(ndims, nf, conv_nb_features, conv_size, generator))
            nf = conv_nb_features
        self.atlas_gen = _flax_conv(ndims, nf, feats, 3, generator, weak=1e-7)
        self.vxm = VxmDense(inshape, nb_unet_features=nb_unet_features, bidir=True,
                            int_steps=int_steps, int_resolution=int_resolution,
                            src_feats=feats, trg_feats=src_feats, dtype=dtype,
                            generator=generator)
        if use_mean_stream:
            self.mean_stream = MeanStream((*self.inshape, ndims), cap=mean_cap)
        self.config = dict(
            inshape=self.inshape, pheno_input_shape=tuple(pheno_input_shape),
            nb_unet_features=nb_unet_features, src_feats=src_feats, atlas_feats=atlas_feats,
            conv_image_shape=None if conv_image_shape is None else tuple(conv_image_shape),
            conv_size=conv_size, conv_nb_levels=conv_nb_levels,
            conv_nb_features=conv_nb_features, extra_conv_layers=extra_conv_layers,
            use_mean_stream=use_mean_stream, mean_cap=mean_cap, int_steps=int_steps,
            int_resolution=int_resolution, dtype=self.vxm.dtype)

    def forward(self, pheno: torch.Tensor, atlas: torch.Tensor, source: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        x = F.elu(self.pheno_dense(pheno.float()))
        x = x.reshape(-1, *self.conv_image_shape).movedim(-1, 1)
        for n in range(self.conv_nb_levels):
            x = F.elu(_same_conv(getattr(self, f"atlas_dec_conv_{n}"), x))
            for axis in range(2, self.ndims + 2):
                x = x.repeat_interleave(2, dim=axis)
        if self.conv_nb_levels:
            x = _same_conv(self.atlas_dec_likelihood, x)
        for n in range(self.extra_conv_layers):
            x = _same_conv(getattr(self, f"atlas_extra_conv_{n}"), x)
        atlas_tensor = atlas + _same_conv(self.atlas_gen, x).movedim(1, -1)
        out = self.vxm(self.vxm.slab(atlas_tensor), source, generator=generator)
        out["atlas_tensor"] = atlas_tensor
        if self.use_mean_stream:
            out["mean_stream"] = self.mean_stream(out["neg_flow"])
        return out


def _normal_log_prob(x: torch.Tensor, mu: torch.Tensor, logsigmasq: torch.Tensor) -> torch.Tensor:
    """log N(x; mu, exp(logsigmasq))."""
    return -0.5 * (math.log(2 * math.pi) + logsigmasq) - 0.5 * (x - mu) ** 2 / torch.exp(logsigmasq)


class ProbAtlasSegmentation(VxmSlabs, nn.Module):
    """Atlas-based Bayesian segmentation.

    A ``VxmDense`` (``self.vxm``, ``src_feats=nb_labels``) warps a
    probabilistic atlas onto the image: on CUDA tensors the tiered warp's
    kernels for up to 4 labels, the wide gather for more. Per-label Gaussian
    statistics come from two ``ConvBlock``s (``stat_conv0``, ``stat_conv1``;
    the conv kernel in conv-kernel mode) on the U-Net's output or, with
    ``stat_post_warp``, on the warped atlas and the image, then VALID convs
    (N(0, 1e-5)) and a global max. ``forward(image, atlas, generator=None)``
    (the image first, as in the JAX package) returns the VxmDense outputs
    plus 'loss_vol' (the unnormalised log-marginal by log-sum-exp, or the
    posterior by softmax with ``supervised_model``), 'flow' (pos_flow),
    'uloglhood', 'stat_mu', 'stat_logssq' and 'warped_atlas'.
    ``image_feats`` is the image's channel count (the JAX module reads it
    from its input); a config names it only when it is not 1.

    Over a mesh's 'space' axis the image and the atlas arrive whole and
    enter the U-Net as this rank's slabs (``parallel.mesh.slab_of``). The
    stat ConvBlocks run on slabs, widened by a plane of each neighbour's as
    the U-Net's blocks are: of ``unet_out``, or with ``stat_post_warp`` of
    the whole warped atlas and image. The VALID convs run on the widened
    slabs too, and their outputs, whose extents are not the slabs', are
    gathered at their own offsets before the global max. Every parameter's
    gradient on a rank is its slab's part (no ``whole_parameters``).
    """

    slab_inputs = ()

    def _valid(self, conv: nn.Module, x: torch.Tensor, space) -> torch.Tensor:
        """The VALID conv ``conv`` of the stat volume ``x`` ``(B, C, *S)``,
        whole on every rank of the row; inside ``slabs``, x is this rank's
        slab: the conv runs on it widened by a plane of each neighbour's,
        the planes centred on a face of the volume are dropped, and the
        parts are gathered at their offsets in the VALID output."""
        if space is None:
            return conv(x)
        n = x.shape[2]
        total, start = space.extent(n)
        out = conv(mesh_lib.halo_exchange(x, 1, 2, space))
        first, last = space.index == 0, space.index == space.size - 1
        out = out.narrow(2, int(first), n - int(first) - int(last))
        return mesh_lib.gather_space(out, 2, space, extent=(total - 2, start - 1 + int(first)))

    def __init__(self, inshape: Sequence[int], nb_labels: int, nb_unet_features=None,
                 nb_unet_conv_per_level: int = 1, init_mu=None, init_sigma=None,
                 warp_atlas: bool = True, stat_post_warp: bool = False, stat_nb_feats: int = 16,
                 network_stat_weight: float = 0.001, supervised_model: bool = False,
                 int_steps: int = 7, int_resolution: int = 2, dtype=torch.float32,
                 image_feats: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        ndims = len(inshape)
        if ndims not in (1, 2, 3):
            raise ValueError(f"ndims should be one of 1, 2, or 3. found: {ndims}")
        if stat_post_warp and not warp_atlas:
            raise ValueError("must enable warp_atlas if computing stat post warp")
        self.ndims = ndims
        self.nb_labels = nb_labels
        self.warp_atlas = warp_atlas
        self.stat_post_warp = stat_post_warp
        self.network_stat_weight = network_stat_weight
        self.supervised_model = supervised_model
        self.init_mu = None if init_mu is None else [float(v) for v in np.ravel(init_mu)]
        self.init_sigma = None if init_sigma is None else [float(v) for v in np.ravel(init_sigma)]
        self.vxm = VxmDense(inshape, nb_unet_features=nb_unet_features,
                            nb_unet_conv_per_level=nb_unet_conv_per_level, int_steps=int_steps,
                            int_resolution=int_resolution, src_feats=nb_labels,
                            trg_feats=image_feats, dtype=dtype, generator=generator)
        stat_in = nb_labels + image_feats if stat_post_warp else self.vxm.unet.out_features
        self.stat_conv0 = ConvBlock(stat_in, stat_nb_feats, ndims, generator=generator)
        self.stat_conv1 = ConvBlock(stat_nb_feats, nb_labels, ndims, generator=generator)
        self.mu_vol = _flax_conv(ndims, nb_labels, nb_labels, 3, generator, weak=1e-5)
        self.logsigmasq_vol = _flax_conv(ndims, nb_labels, nb_labels, 3, generator, weak=1e-5)
        self.config = dict(
            inshape=tuple(inshape), nb_labels=nb_labels, nb_unet_features=nb_unet_features,
            nb_unet_conv_per_level=nb_unet_conv_per_level, init_mu=init_mu,
            init_sigma=init_sigma, warp_atlas=warp_atlas, stat_post_warp=stat_post_warp,
            stat_nb_feats=stat_nb_feats, network_stat_weight=network_stat_weight,
            supervised_model=supervised_model, int_steps=int_steps,
            int_resolution=int_resolution, dtype=self.vxm.dtype)
        if image_feats != 1:
            self.config["image_feats"] = image_feats

    def forward(self, image: torch.Tensor, atlas: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        image = image.float()
        out = self.vxm(self.vxm.slab(atlas), self.vxm.slab(image), generator=generator)
        warped_atlas = out["y_source"] if self.warp_atlas else atlas.float()
        with mesh_lib.slabs(self.vxm.inshape[0], self.vxm.slab_align) as space:
            if self.stat_post_warp:
                combined = self.vxm.slab(torch.cat([warped_atlas, image], dim=-1))
            else:
                combined = out["unet_out"]
            conv = slab_block(self.stat_conv1, slab_block(self.stat_conv0,
                                                          combined.movedim(-1, 1))).float()
            axes = tuple(range(2, self.ndims + 2))
            # VALID convs, then a global max: one statistic per label
            stat_mu = torch.amax(self._valid(self.mu_vol, conv, space), dim=axes,
                                 keepdim=True).movedim(1, -1)
            stat_logssq = torch.amax(self._valid(self.logsigmasq_vol, conv, space), dim=axes,
                                     keepdim=True).movedim(1, -1)
        if self.init_mu is not None:
            stat_mu = self.network_stat_weight * stat_mu + stat_mu.new_tensor(self.init_mu)
        if self.init_sigma is not None:
            init_logsigmasq = stat_logssq.new_tensor([2 * math.log(f) for f in self.init_sigma])
            stat_logssq = self.network_stat_weight * stat_logssq + init_logsigmasq

        # the image's log-likelihood under each label's Gaussian, plus the
        # (warped) atlas's log prior
        uloglhood = _normal_log_prob(image, stat_mu, stat_logssq)
        logpdf = uloglhood + torch.log(torch.clamp(warped_atlas, 1e-36, 1.0))
        if not self.supervised_model:
            alpha = torch.amax(logpdf, dim=-1, keepdim=True)
            loss_vol = alpha + torch.log(
                torch.sum(torch.exp(logpdf - alpha), dim=-1, keepdim=True) + 1e-7)
        else:
            loss_vol = torch.softmax(logpdf, dim=-1)
        out["loss_vol"] = loss_vol
        out["flow"] = out["pos_flow"]
        out["uloglhood"] = uloglhood
        out["stat_mu"] = stat_mu
        out["stat_logssq"] = stat_logssq
        out["warped_atlas"] = warped_atlas
        return out
