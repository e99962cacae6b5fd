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
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import warp as warp_ops
from ..ops.image import gaussian_blur, multiscale_noise_draws, multiscale_noise_from_draws
from ..ops.interp import interpn_label_onehot, ndgrid
from .vxm import _DTYPES, VxmDense

__all__ = ["LabelsToImageConfig", "labels_to_image", "labels_to_image_draws",
           "labels_to_image_from_draws", "shared_intensity", "SynthMorphDense",
           "registration_model"]


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


class SynthMorphDense(nn.Module):
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
    """

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
        (``src``), then the target's (``trg``)."""
        share = None
        if self.shared_contrast > 0:
            share = torch.rand((), generator=generator, device=device) < self.shared_contrast
        return {"share": share,
                "src": labels_to_image_draws(generator, self.cfg, batch, device),
                "trg": labels_to_image_draws(generator, self.cfg, batch, device)}

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

        out = self.vxm(ima_1, ima_2, generator=generator)
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
