"""Registration API: one call from an image pair to (moved image, warp).

Counterpart of ``voxelmorph_tpu/registration.py`` for VxmDense models.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.vxm import VxmDense
from .ops import warp as warp_ops

__all__ = ["enable_fast_warp", "resolve_registration_model", "build_register_fn",
           "build_register_seg_fn", "register_pair"]


def _rebuilt(model: VxmDense, **config) -> VxmDense:
    """A copy of ``model`` with ``config`` fields replaced, same weights."""
    device = next(model.parameters()).device
    copy = VxmDense(**{**model.config, **config})
    copy.load_state_dict(model.state_dict())
    return copy.to(device).train(model.training)


def enable_fast_warp(model: VxmDense, phases: int = 2, halo: int = 2) -> VxmDense:
    """A copy of ``model`` with the phase-warp inference path on: the moved
    image is 2^phases bounded warps (the CUDA kernel) by the integration
    root instead of one full-resolution gather, falling back to the exact
    gather when the root exceeds ``halo`` (``ops.warp.phase_warp_batched``).
    Models without integration pass through unchanged."""
    if model.int_steps > 0:
        return _rebuilt(model, fast_warp_phases=phases, fast_warp_halo=halo)
    return model


def resolve_registration_model(model: VxmDense,
                               inshape: Optional[Sequence[int]] = None) -> VxmDense:
    """Return the net that registers images, re-targeted to ``inshape``.

    VxmDense is fully convolutional: ``inshape`` only sizes the svf and
    integration rescale grids, so a checkpoint trained at one resolution
    serves another with the same weights.
    """
    if not isinstance(model, VxmDense):
        raise NotImplementedError(f"{type(model).__name__} is not ported yet")
    if inshape is not None and tuple(model.inshape) != tuple(inshape):
        model = _rebuilt(model, inshape=tuple(inshape)).eval()
    return model


def build_register_fn(model: VxmDense) -> Callable[[torch.Tensor, torch.Tensor],
                                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Return fn(moving, fixed) -> (moved, warp), tensors on the model's device."""

    @torch.inference_mode()
    def register(moving: torch.Tensor, fixed: torch.Tensor):
        out = model(moving, fixed)
        return out["y_source"], out["pos_flow"]

    return register


def build_register_seg_fn(model: VxmDense) -> Callable[
        [torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Return fn(moving, fixed, moving_seg) -> (moved, warp, moved_seg): the
    segmentation rides the same warp (pos_flow) with nearest interpolation."""

    @torch.inference_mode()
    def register(moving: torch.Tensor, fixed: torch.Tensor, moving_seg: torch.Tensor):
        out = model(moving, fixed)
        warp = out["pos_flow"]
        moved_seg = warp_ops.transform_batched(moving_seg, warp, interp_method="nearest")
        return out["y_source"], warp, moved_seg

    return register


def register_pair(model: VxmDense, moving, fixed) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot registration of numpy arrays ``(B, *S, C)``: (moved, warp)."""
    device = next(model.parameters()).device
    mv = torch.as_tensor(np.asarray(moving, np.float32), device=device)
    fx = torch.as_tensor(np.asarray(fixed, np.float32), device=device)
    moved, warp = build_register_fn(model)(mv, fx)
    return moved.cpu().numpy(), warp.cpu().numpy()
