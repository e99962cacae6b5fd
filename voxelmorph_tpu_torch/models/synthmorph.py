"""SynthMorph: registration trained on images synthesized from label maps.

Counterpart of the synthesis half of ``voxelmorph_tpu/models/synthmorph.py``:
``LabelsToImageConfig``, ``labels_to_image`` (label map -> per-label GMM
intensities -> a random diffeomorphic warp of the image and of the soft
one-hot -> blur -> bias field -> gamma) and ``SynthMorphDense``, a VxmDense
trained end to end on pairs synthesized on the device. ``labels_to_image``
is split, as ``ops.image.draw_multiscale_noise`` is, into its draws, from an
explicit ``torch.Generator`` (``labels_to_image_draws``), and the
deterministic map from them (``labels_to_image_from_draws``), so that a test
can replay the JAX package's draws. The synthesis is data: it runs without
autograd, on plain torch gathers (JAX's XLA gathers), and only the
registration network's outputs carry gradients.

The joint affine and deformable model is here too: ``VxmAffineFeatureDetector``
(a conv encoder whose feature maps' barycenters are soft landmarks for a
symmetric least-squares affine) and ``HyperVxmJoint`` (that affine stage at
half resolution, then a hypernetwork-conditioned encoder-decoder of
``HyperConv``s on the affinely aligned pair, whose symmetrised SVF is
integrated by scaling and squaring). Their convs are flax ``nn.Conv``s and
``HyperConv``s in the JAX package, XLA's convolutions there, so they are
cuDNN's here in every conv mode; the integration takes the tiered warp's
kernels. Their matrices act on zero-based indices (``shift_center=False``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import affine as affine_ops
from ..ops import warp as warp_ops
from ..ops.image import (barycenter, gaussian_blur, multiscale_noise_draws,
                         multiscale_noise_from_draws, sqrtm)
from ..ops.interp import interpn_label_onehot, ndgrid
from ..parallel import mesh as mesh_lib
from ..parallel.mesh import draw_rows
from .unet import HyperConv, _upsample_nearest, leaky_relu, lecun_normal_
from .vxm import _DTYPES, VxmDense, VxmSlabs

__all__ = ["LabelsToImageConfig", "labels_to_image", "labels_to_image_draws",
           "labels_to_image_from_draws", "shared_intensity", "SynthMorphDense",
           "registration_model", "VxmAffineFeatureDetector", "HyperVxmJoint"]


class LabelsToImageConfig:
    """Static configuration of the synthesis, the JAX package's class field
    for field (and its checkpoint dict): ``warp_std`` / ``warp_res`` set the
    SVF, ``blur_std`` the smoothing, ``bias_std`` / ``bias_res`` the
    multiplicative bias field, ``gamma_std`` the contrast jitter,
    ``zero_background`` the chance that label 0 is black.

    ``index_lut`` maps a label to its index in ``in_label_list``;
    ``out_lut`` maps it to its index in ``out_label_list``, -1 where it is
    not there (its one-hot is then all zero).
    """

    def __init__(self, in_shape, in_label_list, out_label_list=None,
                 out_shape=None, warp_std=0.5, warp_res=(16,), blur_std=1.0,
                 bias_std=0.3, bias_res=(40,), gamma_std=0.25,
                 mean_range=(0.0, 1.0), std_range=(0.0, 0.1),
                 warp_int_steps=5, zero_background=0.2):
        self.in_shape = tuple(int(s) for s in in_shape)
        self.out_shape = tuple(int(s) for s in (out_shape or in_shape))
        in_label_list = np.asarray(sorted(np.unique(in_label_list)))
        self.in_label_list = in_label_list
        if out_label_list is None:
            out_label_list = in_label_list
        self.out_label_list = np.asarray(sorted(np.unique(out_label_list)))
        self.warp_std = warp_std
        self.warp_res = tuple(np.ravel(warp_res))
        self.blur_std = blur_std
        self.bias_std = bias_std
        self.bias_res = tuple(np.ravel(bias_res))
        self.gamma_std = gamma_std
        self.mean_range = mean_range
        self.std_range = std_range
        self.warp_int_steps = warp_int_steps
        self.zero_background = zero_background

        max_label = int(in_label_list.max())
        lut = np.zeros(max_label + 1, np.int32)
        lut[in_label_list] = np.arange(len(in_label_list))
        self.index_lut = lut
        out_lut = np.full(max_label + 1, -1, np.int32)
        for i, lab in enumerate(self.out_label_list):
            if lab <= max_label:
                out_lut[lab] = i
        self.out_lut = out_lut
        self.nb_in_labels = len(in_label_list)
        self.nb_out_labels = len(self.out_label_list)

    @property
    def zeroes_background(self) -> bool:
        """Whether a sample draws the flag that blacks out label 0."""
        return self.zero_background > 0 and self.in_label_list[0] == 0

    def to_dict(self):
        """JSON-safe constructor kwargs (the checkpoint's ``data``)."""
        return {
            "in_shape": list(self.in_shape),
            "in_label_list": [int(v) for v in self.in_label_list],
            "out_label_list": [int(v) for v in self.out_label_list],
            "out_shape": list(self.out_shape),
            "warp_std": float(self.warp_std),
            "warp_res": [float(v) for v in self.warp_res],
            "blur_std": float(self.blur_std),
            "bias_std": float(self.bias_std),
            "bias_res": [float(v) for v in self.bias_res],
            "gamma_std": float(self.gamma_std),
            "mean_range": [float(v) for v in self.mean_range],
            "std_range": [float(v) for v in self.std_range],
            "warp_int_steps": int(self.warp_int_steps),
            "zero_background": float(self.zero_background),
        }

    @classmethod
    def from_dict(cls, data):
        return cls(**data)


@functools.lru_cache(maxsize=16)
def _luts_on(cfg: LabelsToImageConfig, device: torch.device):
    """The config's two lookup tables on ``device``, made once: a step
    then copies nothing from the host."""
    with torch.inference_mode(False):
        return (torch.as_tensor(cfg.index_lut, dtype=torch.long, device=device),
                torch.as_tensor(cfg.out_lut, dtype=torch.long, device=device))


def labels_to_image_draws(generator: Optional[torch.Generator], cfg: LabelsToImageConfig,
                          batch: int, device=None) -> List[dict]:
    """The random draws of ``labels_to_image`` for ``batch`` samples, one
    dict each, drawn from ``generator`` sample after sample, in this order:
    ``means`` and ``stds`` (uniform in ``mean_range`` and ``std_range``, one
    per input label), the background flag ``zero`` (one uniform below
    ``zero_background``; only when ``cfg.zeroes_background``), the voxel
    noise ``noise`` (standard normal, ``in_shape``), the SVF's multiscale
    draws ``svf`` (``ops.image.multiscale_noise_draws``, ``warp_res``,
    ``warp_std``, one channel per axis), the blur sigma ``blur_sigma``
    (uniform in ``[0, blur_std)``), the bias field's draws ``bias``
    (``bias_res``, ``bias_std``, one channel; only when ``bias_std > 0``)
    and ``gamma`` (normal times ``gamma_std``, the log of the exponent).
    ``means``, ``stds`` and ``zero`` are the intensity draws, which two
    images may share (``shared_intensity``)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    nd = len(cfg.in_shape)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    draws = []
    for _ in range(batch):
        d = {"means": uniform((cfg.nb_in_labels,), *cfg.mean_range),
             "stds": uniform((cfg.nb_in_labels,), *cfg.std_range)}
        if cfg.zeroes_background:
            d["zero"] = uniform((), 0.0, 1.0) < cfg.zero_background
        d["noise"] = torch.randn(cfg.in_shape, generator=generator, device=device)
        d["svf"] = multiscale_noise_draws(generator, cfg.in_shape, list(cfg.warp_res),
                                          cfg.warp_std, nb_channels=nd, device=device)
        d["blur_sigma"] = uniform((), 0.0, cfg.blur_std)
        if cfg.bias_std > 0:
            d["bias"] = multiscale_noise_draws(generator, cfg.in_shape, list(cfg.bias_res),
                                               cfg.bias_std, nb_channels=1, device=device)
        d["gamma"] = torch.randn((), generator=generator, device=device) * cfg.gamma_std
        draws.append(d)
    return draws


def shared_intensity(draw: dict, other: dict, share) -> dict:
    """``draw`` with its intensity draws (means, stds, background flag)
    taken from ``other`` where ``share`` (a bool, or a bool tensor on the
    device: nothing is read to the host)."""
    out = dict(draw)
    for key in ("means", "stds", "zero"):
        if key in draw:
            out[key] = (torch.where(share, other[key], draw[key])
                        if isinstance(share, torch.Tensor) else
                        other[key] if share else draw[key])
    return out


def _center_fit(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """Center pad (zeros) or crop the spatial axes of ``(*S, C)`` to
    ``out_shape``."""
    for d, (cur, out) in enumerate(zip(x.shape[:-1], out_shape)):
        if out > cur:
            shape = list(x.shape)
            shape[d] = out
            padded = x.new_zeros(shape)
            padded.narrow(d, (out - cur) // 2, cur).copy_(x)
            x = padded
        elif out < cur:
            x = x.narrow(d, (cur - out) // 2, out)
    return x


def _synthesize(lab: torch.Tensor, draw: dict, cfg: LabelsToImageConfig, return_warp: bool):
    """One sample of ``labels_to_image_from_draws``: lab ``(*in_shape,)``."""
    index_lut, out_lut = _luts_on(cfg, lab.device)
    lab = lab.long()
    # 1. per-label GMM intensities on the unwarped map
    idx = index_lut[lab.clamp(0, index_lut.numel() - 1)]
    means, stds = draw["means"], draw["stds"]
    if cfg.zeroes_background:
        zero = draw["zero"]
        means = torch.cat([torch.where(zero, torch.zeros_like(means[:1]), means[:1]), means[1:]])
        stds = torch.cat([torch.where(zero, torch.zeros_like(stds[:1]), stds[:1]), stds[1:]])
    image = means[idx] + stds[idx] * draw["noise"]
    # 2. the output labels' indices (-1: not an output label)
    out_idx = out_lut[lab.clamp(0, out_lut.numel() - 1)]
    # 3. a random smooth SVF, integrated on the gather; the image and the
    # one-hot ride the same warp, linear, so the one-hot is soft at edges
    svf = multiscale_noise_from_draws(draw["svf"], cfg.in_shape)
    warp = warp_ops.integrate_vec(svf, nb_steps=cfg.warp_int_steps)
    loc = ndgrid(cfg.in_shape, dtype=warp.dtype, device=warp.device) + warp
    image, one_hot = interpn_label_onehot(image, out_idx, loc, cfg.nb_out_labels)
    # 4. blur with a random sigma
    image = gaussian_blur(image[..., None], draw["blur_sigma"], max_sigma=cfg.blur_std)
    # 5. multiplicative bias field
    if cfg.bias_std > 0:
        image = image * torch.exp(multiscale_noise_from_draws(draw["bias"], cfg.in_shape))
    # 6. to [0, 1], then the gamma jitter
    lo, hi = image.min(), image.max()
    image = (image - lo) / (hi - lo).clamp(min=1e-6)
    image = torch.pow(image.clamp(1e-6, 1.0), torch.exp(draw["gamma"]))
    # 7. center pad or crop to out_shape
    if cfg.out_shape != cfg.in_shape:
        image = _center_fit(image, cfg.out_shape)
        one_hot = _center_fit(one_hot, cfg.out_shape)
    if return_warp:
        inv_warp = warp_ops.integrate_vec(-svf, nb_steps=cfg.warp_int_steps)
        return image, one_hot, warp, inv_warp
    return image, one_hot


@torch.no_grad()
def labels_to_image_from_draws(label_map: torch.Tensor, cfg: LabelsToImageConfig,
                               draws: List[dict], return_warp: bool = False):
    """The synthesized pair of ``label_map`` ``(B, *in_shape, 1)`` (integer
    labels, any dtype) from ``draws`` (one dict per sample, as
    ``labels_to_image_draws`` gives them), on the map's device.

    Returns ``image`` ``(B, *out_shape, 1)`` in [0, 1] and ``one_hot``
    ``(B, *out_shape, nb_out_labels)``, the one-hot over
    ``cfg.out_label_list`` carried through the warp with linear
    interpolation (soft at the boundaries); with ``return_warp`` also the
    synthesis deformation and its exact inverse ``integrate_vec(-svf)``,
    displacements ``(B, *in_shape, N)`` (which needs out_shape ==
    in_shape).
    """
    if return_warp and cfg.out_shape != cfg.in_shape:
        raise ValueError("return_warp requires out_shape == in_shape")
    if len(draws) != label_map.shape[0]:
        raise ValueError(f"{len(draws)} draws for a batch of {label_map.shape[0]}")
    samples = [_synthesize(lab[..., 0], d, cfg, return_warp) for lab, d in zip(label_map, draws)]
    return tuple(torch.stack(parts) for parts in zip(*samples))


def labels_to_image(generator: Optional[torch.Generator], label_map: torch.Tensor,
                    cfg: LabelsToImageConfig, return_warp: bool = False,
                    intensity_draws: Optional[List[dict]] = None):
    """Synthesize ``(image, one_hot[, warp, inv_warp])`` from an integer
    label map ``(B, *in_shape, 1)`` with draws from ``generator``
    (``labels_to_image_draws``, then ``labels_to_image_from_draws``).
    ``intensity_draws`` (another call's draws) replace this call's
    intensity draws: two images of one contrast, the JAX package's
    ``intensity_key``."""
    draws = labels_to_image_draws(generator, cfg, label_map.shape[0], label_map.device)
    if intensity_draws is not None:
        draws = [shared_intensity(d, o, True) for d, o in zip(draws, intensity_draws)]
    return labels_to_image_from_draws(label_map, cfg, draws, return_warp)


class SynthMorphDense(VxmSlabs, nn.Module):
    """A VxmDense trained on pairs synthesized on the device.

    ``forward(src_labels, trg_labels, generator=None, draws=None)`` takes
    two integer label maps ``(B, *in_shape, 1)`` (any dtype), synthesizes an
    image and a soft one-hot from each (``labels_to_image``), registers the
    images with ``vxm`` (a ``VxmDense`` at ``cfg.out_shape``, the JAX
    module's ``vxm``, so checkpoint keys are ``vxm||...``) and returns its
    outputs plus ``image_1``, ``image_2``, ``map_1``, ``map_2`` and
    ``pred_map``, the detached ``map_1`` warped by pos_flow (30-46
    channels: the plain wide gather, with no volume gradient). With
    ``sup_flow`` it also returns ``gt_flow``, the exact flow that aligns
    ``map_1`` to ``map_2`` when both come from one label map
    (``w2 + inv_w1 o (id + w2)``, detached).

    The draws (``draw``) come from ``generator`` in training mode and, in
    eval mode, from a generator seeded 0 (the JAX module's PRNGKey(0)), or
    are injected whole with ``draws``. With ``shared_contrast`` p > 0 the
    second image takes the first's intensity draws with probability p (a
    coin drawn first, kept on the device).

    Over a mesh's 'space' axis the label maps arrive whole, as the
    synthesis warps, blurs and draws across the volume: every rank of a row
    synthesizes the whole pair (the same draws: those of the global batch,
    ``draw``), and the images enter the U-Net as this rank's slabs
    (``parallel.mesh.slab_of``); ``pred_map`` is warped on the whole field.
    Every parameter's gradient on a rank is its slab's part.
    """

    slab_inputs = ()

    def __init__(self, cfg: LabelsToImageConfig, nb_unet_features=None, int_steps: int = 5,
                 int_resolution: int = 2, svf_resolution: int = 2, dtype=torch.float32,
                 sup_flow: bool = False, shared_contrast: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = _DTYPES.get(dtype, dtype)
        self.config = dict(cfg=cfg, nb_unet_features=nb_unet_features, int_steps=int_steps,
                           int_resolution=int_resolution, svf_resolution=svf_resolution,
                           dtype=dtype, sup_flow=sup_flow, shared_contrast=shared_contrast)
        self.cfg = cfg
        self.sup_flow = sup_flow
        self.shared_contrast = float(shared_contrast)
        self.vxm = VxmDense(cfg.out_shape, nb_unet_features=nb_unet_features,
                            int_steps=int_steps, int_resolution=int_resolution,
                            svf_resolution=svf_resolution, dtype=dtype, generator=generator)

    def draw(self, generator: Optional[torch.Generator], batch: int, device) -> dict:
        """The draws of one forward, in this order from ``generator``: the
        shared-contrast coin ``share`` (a bool tensor; only when
        ``shared_contrast > 0``), then the source's ``labels_to_image_draws``
        (``src``), then the target's (``trg``). In a train step over several
        ranks each image's draws are the global batch's, of which this rank
        keeps its rows (``parallel.mesh.draw_rows``)."""
        share = None
        if self.shared_contrast > 0:
            share = torch.rand((), generator=generator, device=device) < self.shared_contrast

        def images(n):
            return labels_to_image_draws(generator, self.cfg, n, device)

        return {"share": share, "src": draw_rows(images, batch), "trg": draw_rows(images, batch)}

    def forward(self, src_labels: torch.Tensor, trg_labels: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> dict:
        device = src_labels.device
        if draws is None:
            if not self.training:
                generator = torch.Generator(device=device).manual_seed(0)
            draws = self.draw(generator, src_labels.shape[0], device)
        trg_draws = draws["trg"]
        if draws.get("share") is not None:
            trg_draws = [shared_intensity(t, s, draws["share"])
                         for t, s in zip(trg_draws, draws["src"])]
        gt_flow = None
        with torch.no_grad():
            if self.sup_flow:
                ima_1, map_1, _, inv_w1 = labels_to_image_from_draws(
                    src_labels, self.cfg, draws["src"], return_warp=True)
                ima_2, map_2, w2, _ = labels_to_image_from_draws(
                    trg_labels, self.cfg, trg_draws, return_warp=True)
                # phi_1^-1 o phi_2 as a displacement: u_2(x) + u_1^-1(x + u_2(x))
                gt_flow = w2 + warp_ops.transform_batched(inv_w1, w2, window_halo=None)
            else:
                ima_1, map_1 = labels_to_image_from_draws(src_labels, self.cfg, draws["src"])
                ima_2, map_2 = labels_to_image_from_draws(trg_labels, self.cfg, trg_draws)

        out = self.vxm(self.vxm.slab(ima_1), self.vxm.slab(ima_2), generator=generator)
        out["image_1"], out["image_2"] = ima_1, ima_2
        out["map_1"], out["map_2"] = map_1, map_2
        # the one-hot is data: the warp's backward builds no volume gradient
        out["pred_map"] = warp_ops.transform_batched(map_1.detach(), out["pos_flow"])
        if gt_flow is not None:
            out["gt_flow"] = gt_flow
        return out


def registration_model(model: SynthMorphDense):
    """The net that registers acquired image pairs of ``cfg.out_shape``
    inside a trained SynthMorphDense, and its weights: ``(VxmDense, state
    dict)``. The synthesis has no parameters; deployment keeps the
    registration net alone."""
    if not isinstance(model, SynthMorphDense):
        raise ValueError(f"no SynthMorph registration net in {type(model).__name__}")
    return model.vxm, model.vxm.state_dict()


def _scale_matrix(fact, nd: int, device=None) -> torch.Tensor:
    """The ``(nd, nd + 1)`` matrix that scales zero-based indices by
    ``fact``, made on ``device`` by fills (no copy from the host)."""
    return torch.eye(nd, nd + 1, device=device) * float(fact)


def _on_device(values: Sequence[float], device) -> torch.Tensor:
    """A float32 vector of ``values`` made on ``device`` by fills (writing
    them into its elements would copy each from the host, which waits for
    the device)."""
    return torch.stack([torch.full((), float(v), device=device) for v in values])


def _cen_matrix(shape: Sequence[int], sign: float, device=None) -> torch.Tensor:
    """The ``(N, N + 1)`` shift by ``sign`` times the centre of ``shape``:
    from centred to zero-based indices (+1) and back (-1); made by fills."""
    shift = _on_device([sign * 0.5 * (float(s) - 1.0) for s in shape], device)
    return torch.cat([torch.eye(len(shape), device=device), shift[:, None]], dim=1)


def _compose(*transforms: torch.Tensor) -> torch.Tensor:
    """``ops.warp.compose`` with ``shift_center=False`` per sample of
    batched transforms ``(B, ...)``: JAX's ``vmap`` of it."""
    return torch.stack([warp_ops.compose(list(ts), shift_center=False)
                        for ts in zip(*transforms)])


def _warp_to(images: torch.Tensor, trfs: torch.Tensor, shape=None,
             interp_method: str = "linear") -> torch.Tensor:
    """Each image ``(B, *S, C)`` transformed by its matrix or dense
    transform with zero fill on zero-based indices (into ``shape`` for a
    matrix): JAX's ``vmap`` of ``transform``."""
    return torch.stack([warp_ops.transform(i, t, interp_method=interp_method, fill_value=0.0,
                                           shift_center=False, shape=shape)
                        for i, t in zip(images, trfs)])


def _init_device(generator: Optional[torch.Generator]):
    """Build parameters on the generator's device, so that a CUDA generator
    draws them there (a full-width joint model has about 890 M)."""
    return contextlib.nullcontext() if generator is None else torch.device(generator.device)


class _FeatureEncoder(nn.Module):
    """The detector's conv encoder(-decoder): ``enc_nf`` levels of
    ``per_level`` conv + LeakyReLU(0.2) blocks, each followed by a 2x max
    pool, ``dec_nf`` levels of convs, each followed by nearest 2x
    upsampling and the matching encoder level's output, ``add_nf`` convs,
    and the ``feat`` conv of ``num_feat`` channels with a ReLU, cast to
    float32. Its convs are flax's ``nn.Conv`` (lecun-normal kernel, zero
    bias) in ``dtype``, the bias added to the rounded output; its pools
    pass a window's gradient to its first maximum, as flax's ``max_pool``
    does. ``forward`` takes and returns channels-last ``(B, *S, C)``; images
    have one channel."""

    def __init__(self, ndims: int, num_feat: int = 64, enc_nf=(256, 256, 256, 256),
                 dec_nf=(), add_nf=(256, 256, 256, 256), per_level: int = 1,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ndims = ndims
        self.enc_nf, self.dec_nf, self.add_nf = tuple(enc_nf), tuple(dec_nf), tuple(add_nf)
        self.per_level = per_level
        self.dtype = _DTYPES.get(dtype, dtype)
        conv_cls = getattr(nn, f"Conv{ndims}d")

        def conv(name, cin, n):
            layer = conv_cls(cin, n, 3, padding=1)
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(name, layer)
            return n

        with _init_device(generator):
            ch, skips = 1, []
            for li, n in enumerate(self.enc_nf):
                for ci in range(per_level):
                    ch = conv(f"enc_{li}_{ci}", ch, n)
                skips.append(ch)
            for li, n in enumerate(self.dec_nf):
                for ci in range(per_level):
                    ch = conv(f"dec_{li}_{ci}", ch, n)
                ch += skips.pop()
            for li, n in enumerate(self.add_nf):
                ch = conv(f"add_{li}", ch, n)
            conv("feat", ch, num_feat)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        out = getattr(F, f"conv{self.ndims}d")(x, layer.weight.to(self.dtype), padding=1)
        return out + layer.bias.to(self.dtype).view(-1, *[1] * self.ndims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = self.ndims
        x = x.movedim(-1, 1).to(self.dtype)
        enc = []
        for li in range(len(self.enc_nf)):
            for ci in range(self.per_level):
                x = leaky_relu(self._conv(f"enc_{li}_{ci}", x), 0.2)
            enc.append(x)
            x = getattr(F, f"max_pool{nd}d")(x, 2, 2)
        for li in range(len(self.dec_nf)):
            for ci in range(self.per_level):
                x = leaky_relu(self._conv(f"dec_{li}_{ci}", x), 0.2)
            x = torch.cat([_upsample_nearest(x, 2, nd), enc.pop()], dim=1)
        for li in range(len(self.add_nf)):
            x = leaky_relu(self._conv(f"add_{li}", x), 0.2)
        return F.relu(self._conv("feat", x)).float().movedim(1, -1)


class VxmAffineFeatureDetector(nn.Module):
    """Symmetric affine (or rigid) registration by feature-map barycenters.

    A shared ``_FeatureEncoder`` (``detector``) maps each image to
    ``num_feat`` non-negative maps; their centres of mass are soft
    landmarks, and a least-squares fit in each direction (weighted by the
    product of the two images' normalised channel powers with
    ``weighted``), averaged with the inverse of the other, gives a
    symmetric affine. ``forward(im_1, im_2)`` takes full-resolution
    single-channel images ``(B, *in_shape, 1)`` and returns ``aff_1`` and
    ``aff_2``, inverse matrices ``(B, N, N + 1)`` on zero-based indices at
    full resolution (or half with ``return_trans_to_half_res``), plus
    ``dense_1``/``dense_2`` (``make_dense``), ``moved_1``/``moved_2``
    (``return_moved``, zero fill) and ``feat_1``/``feat_2``
    (``return_feat``). ``half_res`` detects on images downsampled by 2,
    ``rigid`` keeps the fit's shift and rotation, and
    ``return_trans_to_mid_space`` returns each matrix's square root. The
    constructor takes the JAX module's fields; ``generator`` draws the
    initial weights, on its device.
    """

    def __init__(self, in_shape: Sequence[int], num_feat: int = 64,
                 enc_nf=(256, 256, 256, 256), dec_nf=(), add_nf=(256, 256, 256, 256),
                 per_level: int = 1, half_res: bool = True, weighted: bool = True,
                 rigid: bool = False, make_dense: bool = True, bidir: bool = False,
                 return_trans_to_mid_space: bool = False,
                 return_trans_to_half_res: bool = False, return_moved: bool = False,
                 return_feat: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = _DTYPES.get(dtype, dtype)
        self.config = dict(
            in_shape=tuple(in_shape), num_feat=num_feat, enc_nf=tuple(enc_nf),
            dec_nf=tuple(dec_nf), add_nf=tuple(add_nf), per_level=per_level,
            half_res=half_res, weighted=weighted, rigid=rigid, make_dense=make_dense,
            bidir=bidir, return_trans_to_mid_space=return_trans_to_mid_space,
            return_trans_to_half_res=return_trans_to_half_res, return_moved=return_moved,
            return_feat=return_feat, dtype=dtype)
        for key, val in self.config.items():
            setattr(self, key, val)
        if len(self.in_shape) not in (2, 3):
            raise ValueError("only 2D and 3D supported")
        if return_trans_to_half_res and not half_res:
            raise ValueError("return_trans_to_half_res needs half_res=True")
        self.detector = _FeatureEncoder(len(self.in_shape), num_feat, enc_nf, dec_nf, add_nf,
                                        per_level, dtype, generator)

    def forward(self, im_1: torch.Tensor, im_2: torch.Tensor) -> dict:
        shape_full = tuple(self.in_shape)
        shape_half = tuple(s // 2 for s in shape_full)
        nd = len(shape_full)
        device = im_1.device
        batch = im_1.shape[0]

        def rep(m):
            return m[None].expand(batch, *m.shape)

        inp_1, inp_2 = im_1, im_2
        if self.half_res:
            scale2 = rep(_scale_matrix(2.0, nd, device))
            inp_1, inp_2 = _warp_to(im_1, scale2, shape_half), _warp_to(im_2, scale2, shape_half)
        feat_1, feat_2 = self.detector(inp_1), self.detector(inp_2)

        # barycenters in centred coordinates, scaled to full resolution
        size = _on_device(shape_full, device)
        cen_1, cen_2 = barycenter(feat_1) * size, barycenter(feat_2) * size

        # channel weights from the total power of each feature
        axes = tuple(range(1, nd + 1))
        pow_1, pow_2 = feat_1.sum(dim=axes), feat_2.sum(dim=axes)
        pow_1 = pow_1 / pow_1.sum(dim=-1, keepdim=True)
        pow_2 = pow_2 / pow_2.sum(dim=-1, keepdim=True)
        weights = pow_1 * pow_2 if self.weighted else None

        aff_1 = affine_ops.fit_affine(cen_1, cen_2, weights=weights)
        aff_2 = affine_ops.fit_affine(cen_2, cen_1, weights=weights)
        aff_1 = 0.5 * (affine_ops.invert_affine(aff_2) + aff_1)
        if self.rigid:
            par = affine_ops.affine_matrix_to_params(aff_1)[:, :nd * (nd + 1) // 2]
            aff_1 = affine_ops.params_to_affine_matrix(par, ndims=nd)
        aff_2 = affine_ops.invert_affine(aff_1)
        if self.return_trans_to_mid_space:
            aff_1 = sqrtm(affine_ops.make_square_affine(aff_1))[:, :-1, :]
            aff_2 = sqrtm(affine_ops.make_square_affine(aff_2))[:, :-1, :]

        # from centred to zero-based indices at full resolution
        un_cen = rep(_cen_matrix(shape_full, +1.0, device))
        cen = rep(_cen_matrix(shape_full, -1.0, device))
        aff_1, aff_2 = _compose(un_cen, aff_1, cen), _compose(un_cen, aff_2, cen)
        if self.return_trans_to_half_res:
            s2 = rep(_scale_matrix(2.0, nd, device))
            aff_1, aff_2 = _compose(aff_1, s2), _compose(aff_2, s2)

        out = {"aff_1": aff_1, "aff_2": aff_2}
        shape_out = shape_half if self.return_trans_to_half_res else shape_full
        if self.make_dense:
            out["dense_1"] = affine_ops.affine_to_dense_shift(aff_1, shape_out,
                                                              shift_center=False)
            out["dense_2"] = affine_ops.affine_to_dense_shift(aff_2, shape_out,
                                                              shift_center=False)
        if self.return_moved:
            out["moved_1"] = _warp_to(im_1, aff_1, shape_out)
            out["moved_2"] = _warp_to(im_2, aff_2, shape_out)
        if self.return_feat:
            out["feat_1"], out["feat_2"] = feat_1, feat_2
        return out


class HyperVxmJoint(nn.Module):
    """Joint affine and deformable registration at half resolution.

    The affine stage (``affine``) is a ``VxmAffineFeatureDetector`` on the
    pair downsampled by 2. The deformable stage is an encoder-decoder of
    ``HyperConv``s (``def_enc_*``, ``def_dec_*``, ``def_add_*``,
    ``def_flow``: one set, run in both directions) whose kernels the
    embedding of ``hyp`` by ``hyp_dense_*`` (ReLU Dense layers, float32)
    generates, on the affinely aligned half-resolution pair. Its two SVFs
    are symmetrised, ``svf_1 = (svf_12 - svf_21) / 2`` and
    ``svf_2 = -svf_1``, and integrated by ``int_steps`` squarings
    (``ops.warp.integrate_vec_batched``: the tiered warp's kernels on the
    card; ``int_steps=0`` keeps the SVFs). The total transforms map
    zero-based indices of the full-resolution inputs, to a full-resolution
    output (or half with ``return_trans_to_half_res``).

    ``forward(hyp, full_1, full_2)`` takes ``hyp`` ``(B, 1)`` and
    single-channel images ``(B, *in_shape, 1)``; it returns ``svf_1``,
    ``svf_2``, ``def_1``, ``def_2``, ``aff_1``, ``aff_2`` (full to half
    resolution), ``tot_1`` and ``tot_2``, and with ``return_moved``
    ``moved_1`` and ``moved_2`` (zero fill). ``mid_space`` registers both
    images to their affine mid-space; ``skip_affine`` drops the affine
    stage. The constructor takes the JAX module's fields; ``generator``
    draws the initial weights, on its device.

    Over a mesh's 'space' axis the images arrive whole (the affine warps
    read anywhere), and the affine stage runs whole on every rank of a row:
    its gradients, whole on each rank, are averaged over 'space'
    (``whole_parameters``). The deformable stage runs twice on this rank's
    slabs of the aligned half-resolution pair (``parallel.mesh.slab_of``,
    in units of ``2**len(enc_nf)`` planes, its pools' product), each conv on
    the slab widened by a plane of each neighbour's, and its SVF is
    gathered whole; its and the MLP's gradients are a slab's part.
    """

    slab_inputs = ()

    @property
    def slab_align(self) -> int:
        return 2 ** len(self.enc_nf)

    @property
    def slab_depth(self) -> int:
        return self.in_shape[0] // 2

    def whole_parameters(self):
        return list(self.affine.parameters())

    def __init__(self, in_shape: Sequence[int], hyp_units=(32, 32, 32, 32),
                 enc_nf=(256, 256, 256, 256), dec_nf=(256, 256, 256, 256),
                 add_nf=(256, 256, 256, 256), per_level: int = 1, int_steps: int = 7,
                 bidir: bool = False, skip_affine: bool = False, mid_space: bool = False,
                 return_trans_to_half_res: bool = False, return_moved: bool = False,
                 aff_num_feat: int = 64, aff_enc_nf=(256, 256, 256, 256),
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = _DTYPES.get(dtype, dtype)
        self.config = dict(
            in_shape=tuple(in_shape), hyp_units=tuple(hyp_units), enc_nf=tuple(enc_nf),
            dec_nf=tuple(dec_nf), add_nf=tuple(add_nf), per_level=per_level,
            int_steps=int_steps, bidir=bidir, skip_affine=skip_affine, mid_space=mid_space,
            return_trans_to_half_res=return_trans_to_half_res, return_moved=return_moved,
            aff_num_feat=aff_num_feat, aff_enc_nf=tuple(aff_enc_nf), dtype=dtype)
        for key, val in self.config.items():
            setattr(self, key, val)
        nd = len(self.in_shape)
        self.affine = VxmAffineFeatureDetector(
            tuple(s // 2 for s in self.in_shape), num_feat=aff_num_feat, enc_nf=aff_enc_nf,
            half_res=False, make_dense=False, bidir=True,
            return_trans_to_mid_space=mid_space, dtype=dtype, generator=generator)
        with _init_device(generator):
            units = 1
            for i, n in enumerate(self.hyp_units):
                layer = nn.Linear(units, n)
                lecun_normal_(layer.weight, generator)
                nn.init.zeros_(layer.bias)
                self.add_module(f"hyp_dense_{i}", layer)
                units = n

            def hyper_conv(name, cin, n):
                self.add_module(name, HyperConv(cin, n, nd, units, dtype, generator))
                return n

            ch, skips = 2, [2]
            for li, n in enumerate(self.enc_nf):
                for ci in range(per_level):
                    ch = hyper_conv(f"def_enc_{li}_{ci}", ch, n)
                skips.append(ch)
            for li, n in enumerate(self.dec_nf):
                for ci in range(per_level):
                    ch = hyper_conv(f"def_dec_{li}_{ci}", ch, n)
                ch += skips.pop()
            for li, n in enumerate(self.add_nf):
                ch = hyper_conv(f"def_add_{li}", ch, n)
            hyper_conv("def_flow", ch, nd)

    def _def_net(self, x1: torch.Tensor, x2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The deformable stage's SVF ``(B, *S, N)`` in float32 from
        channels-last images ``(B, *S, 1)`` and the embedding ``h``; inside
        ``parallel.mesh.spatial``, on this rank's slabs of the images, the
        SVF gathered whole."""
        nd = len(self.in_shape)
        with mesh_lib.slabs(self.slab_depth, self.slab_align) as space:

            def conv(name, x):
                if space is None:
                    return getattr(self, name)(x, h)
                return getattr(self, name)(mesh_lib.halo_exchange(x, 1, 2, space), h, slab=True)

            x = mesh_lib.slab_of(torch.cat([x1, x2], dim=-1), 1, self.slab_align,
                                 space).movedim(-1, 1)
            enc = [x]
            for li in range(len(self.enc_nf)):
                for ci in range(self.per_level):
                    x = leaky_relu(conv(f"def_enc_{li}_{ci}", x), 0.2)
                enc.append(x)
                x = getattr(F, f"max_pool{nd}d")(x, 2, 2)
            for li in range(len(self.dec_nf)):
                for ci in range(self.per_level):
                    x = leaky_relu(conv(f"def_dec_{li}_{ci}", x), 0.2)
                x = torch.cat([_upsample_nearest(x, 2, nd), enc.pop()], dim=1)
            for li in range(len(self.add_nf)):
                x = leaky_relu(conv(f"def_add_{li}", x), 0.2)
            svf = conv("def_flow", x).float().movedim(1, -1)
            return svf if space is None else mesh_lib.gather_space(svf, 1, space)

    def forward(self, hyp: torch.Tensor, full_1: torch.Tensor, full_2: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """(``generator``: the Trainer's; the model draws nothing.)"""
        shape_full = tuple(self.in_shape)
        shape_half = tuple(s // 2 for s in shape_full)
        nd = len(shape_full)
        device = full_1.device
        batch = full_1.shape[0]

        def rep(m):
            return m[None].expand(batch, *m.shape)

        scale2 = rep(_scale_matrix(2.0, nd, device))
        ima_1, ima_2 = _warp_to(full_1, scale2, shape_half), _warp_to(full_2, scale2, shape_half)
        if self.skip_affine:
            # the affine stage's output would be dropped: it is not run
            aff_1 = aff_2 = scale2
            mov_1, mov_2 = ima_1, ima_2
        else:
            # the affine stage at half resolution, then full -> half resolution
            aff = self.affine(ima_1, ima_2)
            aff_1, aff_2 = _compose(scale2, aff["aff_1"]), _compose(scale2, aff["aff_2"])
            mov_1 = _warp_to(full_1, aff_1, shape_half)
            mov_2 = _warp_to(full_2, aff_2, shape_half) if self.mid_space else ima_2

        h = hyp.float()
        for i in range(len(self.hyp_units)):
            h = F.relu(getattr(self, f"hyp_dense_{i}")(h))

        svf_1 = self._def_net(mov_1, mov_2, h)
        svf_2 = self._def_net(mov_2, mov_1, h)
        svf_1 = 0.5 * (svf_1 - svf_2)
        svf_2 = -svf_1
        if self.int_steps > 0:
            def_1 = warp_ops.integrate_vec_batched(svf_1, nb_steps=self.int_steps)
            def_2 = warp_ops.integrate_vec_batched(svf_2, nb_steps=self.int_steps)
        else:
            def_1, def_2 = svf_1, svf_2

        # total transforms: full-resolution input -> half-resolution output
        if self.mid_space and not self.skip_affine:
            scale_half = rep(_scale_matrix(0.5, nd, device))
            tot_1 = _compose(aff_1, def_1, scale_half, aff_1)
            tot_2 = _compose(aff_2, def_2, scale_half, aff_2)
        else:
            tot_1, tot_2 = _compose(aff_1, def_1), _compose(aff_2, def_2)
        out = {"svf_1": svf_1, "svf_2": svf_2, "def_1": def_1, "def_2": def_2,
               "aff_1": aff_1, "aff_2": aff_2}
        if not self.return_trans_to_half_res:
            # composed with the half -> full upsampling on the right
            up = affine_ops.affine_to_dense_shift(_scale_matrix(0.5, nd, device), shape_full,
                                                  shift_center=False)
            tot_1, tot_2 = _compose(tot_1, rep(up)), _compose(tot_2, rep(up))
        out["tot_1"], out["tot_2"] = tot_1, tot_2
        if self.return_moved:
            out["moved_1"] = _warp_to(full_1, tot_1)
            out["moved_2"] = _warp_to(full_2, tot_2)
        return out
