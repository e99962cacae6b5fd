"""Dense warps: apply, rescale and integrate displacement fields.

Counterpart of ``voxelmorph_tpu/ops/warp.py`` for the serving and training
paths. A warp whose displacements are all within a small halo runs the
bounded-warp kernel (``ops.warp_bounded``); any other warp runs the general
gather (``ops.interp.interpn``). The choice is made per call on the host from
``max|shift|``, as the JAX package's ``lax.switch`` makes it on the device.
Every tier is differentiable in the volume and the shift: the kernel tiers
through the bounded warp's autograd Function (its backward kernel on CUDA),
the gather through autograd of ``interpn``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .interp import interpn, ndgrid, resize
from .warp_bounded import warp_bounded

__all__ = ["transform", "transform_batched", "integrate_vec_batched",
           "rescale_dense_transform"]

DEFAULT_WINDOW_HALO = "auto"

# Wider volumes always take the gather, as in the JAX package.
_WINDOWED_MAX_CHANNELS = 4


def _resolve_halo(window_halo, device) -> Optional[int]:
    """The bounded-warp halo for a call on ``device``.

    ``"auto"`` is 1 on CUDA and None (gather only) on the CPU, unless the
    VXM_WINDOW_HALO environment variable sets it (0 disables everywhere).
    """
    if window_halo != "auto":
        return window_halo
    env = os.environ.get("VXM_WINDOW_HALO")
    if env is not None:
        v = int(env)
        return v if v > 0 else None
    return 1 if torch.device(device).type == "cuda" else None


def _tiered_windowed_switch(args, windowed_fn, gather_fn, window_halo: int, max_d: float):
    """Dispatch a warp on its displacement bound, choosing the smallest
    sufficient halo: max|d| <= 1 runs the halo-1 kernel, <= window_halo the
    full-halo kernel, anything larger the gather."""
    for h in sorted({1, int(window_halo)}):
        if max_d <= float(h):
            return windowed_fn(args, h)
    return gather_fn(args)


def _use_window(window_halo, interp_method, fill_value, vols, shifts, batched) -> bool:
    # the bounded-warp kernel is 3-D; other dimensionalities take the gather
    nd = shifts.shape[-1]
    return (window_halo is not None
            and interp_method == "linear"
            and fill_value is None
            and nd == 3
            and vols.shape[-1] <= _WINDOWED_MAX_CHANNELS
            and vols.dim() == nd + 1 + batched
            and tuple(shifts.shape[:-1]) == tuple(vols.shape[:-1]))


def transform(vol: torch.Tensor, loc_shift: torch.Tensor, interp_method: str = "linear",
              fill_value: Optional[float] = None,
              window_halo=DEFAULT_WINDOW_HALO) -> torch.Tensor:
    """Warp a single (non-batched) image by a dense displacement.

    The output at x holds the input at ``x + loc_shift(x)``.

    Args:
      vol: ``(*S, C)`` or ``(*S,)``.
      loc_shift: ``(*S_out, N)`` dense displacement.
      interp_method: 'linear' or 'nearest'.
      fill_value: out-of-domain fill; None clamps to the edge.
      window_halo: halo of the bounded-warp fast path, None for the gather
        only, or "auto" (see ``_resolve_halo``).
    """
    if not vol.is_floating_point():
        vol = vol.to(torch.float32)
    if not loc_shift.is_floating_point():
        loc_shift = loc_shift.to(torch.float32)
    nd = loc_shift.shape[-1]
    squeeze_channel = vol.dim() == nd
    if squeeze_channel:
        vol = vol[..., None]

    def gather(args):
        v, s = args
        grid = ndgrid(s.shape[:-1], dtype=s.dtype, device=s.device)
        return interpn(v, grid + s, interp_method=interp_method, fill_value=fill_value)

    window_halo = _resolve_halo(window_halo, vol.device)
    if _use_window(window_halo, interp_method, fill_value, vol, loc_shift, batched=False):
        out = _tiered_windowed_switch(
            (vol, loc_shift), lambda a, h: warp_bounded(a[0][None], a[1][None], h)[0],
            gather, window_halo, loc_shift.abs().max().item())
    else:
        out = gather((vol, loc_shift))
    return out[..., 0] if squeeze_channel else out


def transform_batched(vols: torch.Tensor, shifts: torch.Tensor, interp_method: str = "linear",
                      fill_value: Optional[float] = None,
                      window_halo=DEFAULT_WINDOW_HALO) -> torch.Tensor:
    """Batched dense warp, vols ``(B, *S, C)`` by shifts ``(B, *S, N)``, with
    one fast-path decision for the whole batch."""
    def gather(args):
        return torch.stack([
            transform(v, s, interp_method=interp_method, fill_value=fill_value,
                      window_halo=None) for v, s in zip(*args)])

    window_halo = _resolve_halo(window_halo, vols.device)
    if not _use_window(window_halo, interp_method, fill_value, vols, shifts, batched=True):
        return gather((vols, shifts))
    return _tiered_windowed_switch(
        (vols, shifts), lambda a, h: warp_bounded(a[0], a[1], h), gather,
        window_halo, shifts.abs().max().item())


def integrate_vec_batched(vec: torch.Tensor, nb_steps: int = 7,
                          window_halo=DEFAULT_WINDOW_HALO) -> torch.Tensor:
    """Scaling and squaring of a batch of stationary velocity fields
    ``(B, *S, N)``: ``v /= 2**nb_steps``, then ``nb_steps`` times
    ``v <- v + v o (id + v)``."""
    if nb_steps < 0:
        raise ValueError(f"nb_steps must be >= 0, got {nb_steps}")
    vec = vec / (2.0 ** nb_steps)
    for _ in range(nb_steps):
        vec = vec + transform_batched(vec, vec, window_halo=window_halo)
    return vec


def rescale_dense_transform(trf: torch.Tensor, factor, interp_method: str = "linear") -> torch.Tensor:
    """Resize a dense warp and scale its vectors by ``factor``; batched
    ``(B, *S, N)`` or single ``(*S, N)``. Multiplies in the smaller space."""
    def single(f):
        if factor < 1:
            return resize(f, factor, interp_method=interp_method) * factor
        return resize(f * factor, factor, interp_method=interp_method)

    if trf.dim() > trf.shape[-1] + 1:
        return torch.stack([single(f) for f in trf])
    return single(trf)
