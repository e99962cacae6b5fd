"""Registration API: one call from an image pair to (moved image, warp).

Counterpart of ``voxelmorph_tpu/registration.py`` for VxmDense models, the
VxmDense inside a semi-supervised (segmentation or point-cloud) or a
SynthMorph checkpoint, and HyperMorph's ``HyperVxmDense``, which takes its
hyperparameter as a third input (``hyper``, baked into the function that
``build_register_fn`` returns).
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
           "build_register_seg_fn", "build_eval_register_fn", "register_pair"]


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
    A VxmDense without integration, and any other model (a HyperVxmDense,
    as in the JAX package, has no such field), passes through unchanged."""
    if isinstance(model, VxmDense) and model.int_steps > 0:
        return _rebuilt(model, fast_warp_phases=phases, fast_warp_halo=halo)
    return model


def resolve_registration_model(model, inshape: Optional[Sequence[int]] = None):
    """Return the net that registers images, re-targeted to ``inshape``.

    A semi-supervised segmentation or point-cloud model registers through
    its inner VxmDense (``models.vxm.registration_model``), a SynthMorphDense
    through its own (``models.synthmorph.registration_model``: it trains on
    synthesized images and is deployed on acquired ones); a VxmDense or a
    HyperVxmDense registers directly. Both are fully convolutional:
    ``inshape`` only sizes the svf and integration rescale grids, so a
    checkpoint trained at one resolution serves another with the same
    weights.
    """
    if isinstance(model, (VxmDenseSemiSupervisedSeg, VxmDenseSemiSupervisedPointCloud)):
        model = registration_model(model)[0]
    elif isinstance(model, synthmorph.SynthMorphDense):
        model = synthmorph.registration_model(model)[0]
    if not isinstance(model, (VxmDense, HyperVxmDense)):
        raise NotImplementedError(f"{type(model).__name__} is not ported yet")
    if inshape is not None and tuple(model.inshape) != tuple(inshape):
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


def build_eval_register_fn(model, hyper: float = 0.5) -> Callable[
        [torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]:
    """The evaluation entry for any registration model: fn(moving, fixed,
    moving_seg) -> (moved, warp, moved_seg), ``build_register_seg_fn`` with
    ``hyper``. SynthMorph's HyperVxmJoint is not ported and raises."""
    if type(model).__name__ == "HyperVxmJoint":
        raise NotImplementedError("HyperVxmJoint is not ported yet")
    return build_register_seg_fn(model, hyper=hyper)


def register_pair(model, moving, fixed, hyper: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot registration of numpy arrays ``(B, *S, C)``: (moved, warp)."""
    device = next(model.parameters()).device
    mv = torch.as_tensor(np.asarray(moving, np.float32), device=device)
    fx = torch.as_tensor(np.asarray(fixed, np.float32), device=device)
    moved, warp = build_register_fn(model, hyper=hyper)(mv, fx)
    return moved.cpu().numpy(), warp.cpu().numpy()
