"""Registration API: one call from an image pair to (moved image, warp).

Counterpart of ``voxelmorph_tpu/registration.py`` for VxmDense models.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.vxm import VxmDense

__all__ = ["resolve_registration_model", "build_register_fn", "register_pair"]


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
        device = next(model.parameters()).device
        retargeted = VxmDense(**{**model.config, "inshape": tuple(inshape)})
        retargeted.load_state_dict(model.state_dict())
        model = retargeted.to(device).eval()
    return model


def build_register_fn(model: VxmDense) -> Callable[[torch.Tensor, torch.Tensor],
                                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Return fn(moving, fixed) -> (moved, warp), tensors on the model's device."""

    @torch.inference_mode()
    def register(moving: torch.Tensor, fixed: torch.Tensor):
        out = model(moving, fixed)
        return out["y_source"], out["pos_flow"]

    return register


def register_pair(model: VxmDense, moving, fixed) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot registration of numpy arrays ``(B, *S, C)``: (moved, warp)."""
    device = next(model.parameters()).device
    mv = torch.as_tensor(np.asarray(moving, np.float32), device=device)
    fx = torch.as_tensor(np.asarray(fixed, np.float32), device=device)
    moved, warp = build_register_fn(model)(mv, fx)
    return moved.cpu().numpy(), warp.cpu().numpy()
