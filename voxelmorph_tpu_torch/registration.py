"""Registration API: one call from an image pair to (moved image, warp).

Counterpart of ``voxelmorph_tpu/registration.py`` for VxmDense models, the
VxmDense inside a semi-supervised (segmentation or point-cloud) or a
SynthMorph checkpoint, HyperMorph's ``HyperVxmDense``, which takes its
hyperparameter as a third input (``hyper``, baked into the function that
``build_register_fn`` returns), and SynthMorph's joint affine and deformable
``HyperVxmJoint`` (``build_joint_register_fn``), whose transform acts on
zero-based indices.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import synthmorph
from .models.hyper import HyperVxmDense
from .models.vxm import (VxmDense, VxmDenseSemiSupervisedPointCloud, VxmDenseSemiSupervisedSeg,
                         registration_model)
from .ops import warp as warp_ops

__all__ = ["enable_fast_warp", "resolve_registration_model", "build_register_fn",
           "build_register_seg_fn", "build_joint_register_fn", "build_eval_register_fn",
           "register_pair"]


def _rebuilt(model, **config):
    """A copy of ``model`` (a VxmDense or HyperVxmDense) with ``config``
    fields replaced, same weights."""
    device = next(model.parameters()).device
    if isinstance(model, VxmDense) and model.hyper:
        config = dict(nb_hyp_units=model.nb_hyp_units, **config)
    copy = type(model)(**{**model.config, **config})
    copy.load_state_dict(model.state_dict())
    return copy.to(device).train(model.training)


def enable_fast_warp(model, phases: int = 2, halo: int = 2):
    """A copy of ``model`` with the phase-warp inference path on: the moved
    image is 2^phases bounded warps (the CUDA kernel) by the integration
    root instead of one full-resolution gather, falling back to the exact
    gather when the root exceeds ``halo`` (``ops.warp.phase_warp_batched``).
    A VxmDense without integration, and any other model (a HyperVxmDense or
    a HyperVxmJoint, as in the JAX package, has no such field), passes
    through unchanged."""
    if isinstance(model, VxmDense) and model.int_steps > 0:
        return _rebuilt(model, fast_warp_phases=phases, fast_warp_halo=halo)
    return model


def resolve_registration_model(model, inshape: Optional[Sequence[int]] = None):
    """Return the net that registers images, re-targeted to ``inshape``.

    A semi-supervised segmentation or point-cloud model registers through
    its inner VxmDense (``models.vxm.registration_model``), a SynthMorphDense
    through its own (``models.synthmorph.registration_model``: it trains on
    synthesized images and is deployed on acquired ones); every other model
    (a VxmDense, a HyperVxmDense, a HyperVxmJoint) registers directly and
    passes through. ``inshape`` re-targets a VxmDense or a HyperVxmDense,
    which are fully convolutional: it only sizes the svf and integration
    rescale grids, so a checkpoint trained at one resolution serves another
    with the same weights.
    """
    if isinstance(model, (VxmDenseSemiSupervisedSeg, VxmDenseSemiSupervisedPointCloud)):
        model = registration_model(model)[0]
    elif isinstance(model, synthmorph.SynthMorphDense):
        model = synthmorph.registration_model(model)[0]
    if (inshape is not None and isinstance(model, (VxmDense, HyperVxmDense))
            and tuple(model.inshape) != tuple(inshape)):
        model = _rebuilt(model, inshape=tuple(inshape)).eval()
    return model


def _apply_image_model(model, moving: torch.Tensor, fixed: torch.Tensor, hyper: float) -> dict:
    """The model's outputs for (moving, fixed): a HyperVxmDense also takes
    ``hyp`` ``(B, nb_hyp_params)`` filled with ``hyper``; every other model
    ignores ``hyper``."""
    if isinstance(model, HyperVxmDense):
        hyp = torch.full((moving.shape[0], model.nb_hyp_params), float(hyper),
                         device=moving.device)
        return model(moving, fixed, hyp)
    return model(moving, fixed)


def build_register_fn(model, hyper: float = 0.5) -> Callable[
        [torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Return fn(moving, fixed) -> (moved, warp), tensors on the model's
    device; ``hyper`` is a HyperVxmDense's hyperparameter."""

    @torch.inference_mode()
    def register(moving: torch.Tensor, fixed: torch.Tensor):
        out = _apply_image_model(model, moving, fixed, hyper)
        return out["y_source"], out["pos_flow"]

    return register


def build_register_seg_fn(model, hyper: float = 0.5) -> Callable[
        [torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Return fn(moving, fixed, moving_seg) -> (moved, warp, moved_seg): the
    segmentation rides the same warp (pos_flow) with nearest interpolation."""

    @torch.inference_mode()
    def register(moving: torch.Tensor, fixed: torch.Tensor, moving_seg: torch.Tensor):
        out = _apply_image_model(model, moving, fixed, hyper)
        warp = out["pos_flow"]
        moved_seg = warp_ops.transform_batched(moving_seg, warp, interp_method="nearest")
        return out["y_source"], warp, moved_seg

    return register


def build_joint_register_fn(model) -> Callable[
        [torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Return fn(hyp, moving, fixed) -> (moved, warp) for a HyperVxmJoint:
    ``hyp`` ``(B, 1)`` is the regularisation weight its deformable stage was
    amortised over, ``warp`` its total transform ``tot_1``, and the moved
    image that transform applied with zero fill on zero-based indices."""

    @torch.inference_mode()
    def register(hyp: torch.Tensor, moving: torch.Tensor, fixed: torch.Tensor):
        warp = model(hyp, moving, fixed)["tot_1"]
        return synthmorph._warp_to(moving, warp), warp

    return register


def _joint_hyp(moving: torch.Tensor, hyper: float) -> torch.Tensor:
    """A HyperVxmJoint's ``hyp`` ``(B, 1)`` filled with ``hyper``, made on
    the device."""
    return torch.full((moving.shape[0], 1), float(hyper), device=moving.device)


def build_eval_register_fn(model, hyper: float = 0.5) -> Callable[
        [torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]:
    """The evaluation entry for any registration model: fn(moving, fixed,
    moving_seg) -> (moved, warp, moved_seg), ``build_register_seg_fn`` with
    ``hyper``; for a HyperVxmJoint, its ``tot_1`` with ``hyp`` filled with
    ``hyper``, the image warped linear and the segmentation nearest, both
    with zero fill on zero-based indices."""
    if not isinstance(model, synthmorph.HyperVxmJoint):
        return build_register_seg_fn(model, hyper=hyper)

    @torch.inference_mode()
    def register(moving: torch.Tensor, fixed: torch.Tensor, moving_seg: torch.Tensor):
        warp = model(_joint_hyp(moving, hyper), moving, fixed)["tot_1"]
        return (synthmorph._warp_to(moving, warp), warp,
                synthmorph._warp_to(moving_seg, warp, interp_method="nearest"))

    return register


def register_pair(model, moving, fixed, hyper: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot registration of numpy arrays ``(B, *S, C)``: (moved, warp);
    a HyperVxmJoint takes ``hyper`` as its ``hyp`` (``scripts/register.py``'s
    joint branch)."""
    device = next(model.parameters()).device
    mv = torch.as_tensor(np.asarray(moving, np.float32), device=device)
    fx = torch.as_tensor(np.asarray(fixed, np.float32), device=device)
    if isinstance(model, synthmorph.HyperVxmJoint):
        moved, warp = build_joint_register_fn(model)(_joint_hyp(mv, hyper), mv, fx)
    else:
        moved, warp = build_register_fn(model, hyper=hyper)(mv, fx)
    return moved.cpu().numpy(), warp.cpu().numpy()
