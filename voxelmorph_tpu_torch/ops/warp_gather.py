"""The general gather warp: CUDA kernels and their plain versions.

A batched trilinear warp of vol ``(B, D, H, W, C)`` by any displacement
``(B, D, H, W, 3)``: each sample is ``interpn(vol, grid + shift)``, the
corner-table gather of ``ops/interp.py`` (the JAX package's
``interp.interpn``), with its edge rules and, above a 1 GiB corner table,
its wide-channel path. ``warp_gather_plain`` computes it with tensor ops and
``warp_gather_bwd_plain`` its VJP by autograd. ``launch_gather_fwd`` and
``launch_gather_bwd`` launch the kernels of ``csrc/warp_gather.cu``, which
compute the same terms in the same order (the backward's dvol by atomic
adds into a buffer the caller zeroes, so in another order): the gather
branch of the tiered warp of ``ops/warp.py``, predicated on the device's
tier word as the bounded kernels are. No Pallas kernel computes this
function; the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import interp as _interp
from .interp import interpn, ndgrid
from .warp_bounded import _f32, work_counter

__all__ = ["is_wide", "warp_gather_plain", "warp_gather_bwd_plain", "launch_gather_fwd",
           "launch_gather_bwd", "MAX_CHANNELS"]

# the most channels the kernels take, as the bounded warp's
MAX_CHANNELS = 4

# ctypes types of the entry points' arguments: the tensors, B, D, H, W, C,
# the wide flag, the tier word, the branch it serves, the work counter and
# the stream
_ARGTYPES = {name: [ctypes.c_void_p] * n + [ctypes.c_int] * 6
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
             for name, n in (("vxm_warp_gather_fwd", 3), ("vxm_warp_gather_bwd", 5))}


def is_wide(spatial, nch: int) -> bool:
    """Whether ``interpn`` takes its wide-channel path for one sample of
    ``spatial`` voxels and ``nch`` float32 channels: a corner table of more
    than 1 GiB, decided from the shape alone."""
    vox = 1
    for s in spatial:
        vox *= int(s)
    return nch > 1 and vox * 2 ** len(spatial) * nch * 4 > _interp._CORNER_TABLE_BYTES_LIMIT


def warp_gather_plain(vol: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Each sample of vol ``(B, *S, C)`` sampled (linear, edge-clamped) at
    ``grid + shift``: the port's gather warp, with tensor ops."""
    grid = ndgrid(shift.shape[1:-1], dtype=shift.dtype, device=shift.device)
    return torch.stack([interpn(v, grid + s) for v, s in zip(vol, shift)])


def warp_gather_bwd_plain(vol: torch.Tensor, shift: torch.Tensor, g: torch.Tensor):
    """(dvol, dshift): autograd's VJP of ``warp_gather_plain`` for the
    cotangent ``g``."""
    with torch.enable_grad():
        v = vol.detach().requires_grad_(True)
        s = shift.detach().requires_grad_(True)
        return torch.autograd.grad(warp_gather_plain(v, s), (v, s), g)


def _launch(name: str, tensors, wide: bool, tier, serve: int, slot: str) -> None:
    B, D, H, W, C = tensors[0].shape
    fn = _build.entry_point("warp_gather", name, _ARGTYPES[name])
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in tensors), B, D, H, W, C,
                 int(wide),
                 None if tier is None else tier.data_ptr(), int(serve),
                 work_counter(device, slot), stream)
    if err != 0:
        raise RuntimeError(f"{name} CUDA kernel failed to launch: CUDA error {err} "
                           f"(B={B}, D={D}, H={H}, W={W}, C={C})")


def _check(vol: torch.Tensor, shift: torch.Tensor) -> None:
    if vol.dim() != 5 or shift.shape != (*vol.shape[:-1], 3):
        raise ValueError(f"the gather kernel takes vol (B, D, H, W, C) and shift "
                         f"(B, D, H, W, 3); got {tuple(vol.shape)} and {tuple(shift.shape)}")
    if not 1 <= vol.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"the gather kernel takes 1 to {MAX_CHANNELS} channels, "
                         f"got {vol.shape[-1]}")
    if vol.device.type != "cuda" or shift.device != vol.device:
        raise ValueError(f"the gather kernel runs on CUDA tensors, not {vol.device} "
                         f"and {shift.device}")
    if shift.dtype != torch.float32 or torch.promote_types(vol.dtype, torch.float32) \
            != torch.float32:
        raise TypeError(f"the gather kernel computes in float32: shift float32 and vol "
                        f"of at most float32, not {shift.dtype} and {vol.dtype}")


def _check_out(out: torch.Tensor, like: torch.Tensor, name: str) -> None:
    """The kernels write contiguous float32 buffers of ``like``'s shape."""
    if out.shape != like.shape or out.dtype != torch.float32 or not out.is_contiguous() \
            or out.device != like.device:
        raise ValueError(f"the gather kernel writes {name} as a contiguous float32 tensor of "
                         f"shape {tuple(like.shape)} on {like.device}; got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}, contiguous {out.is_contiguous()}")


def launch_gather_fwd(vol: torch.Tensor, shift: torch.Tensor, out: torch.Tensor,
                      tier=None, serve: int = 0) -> None:
    """Write the gather of ``vol`` by ``shift`` into ``out`` (float32, the
    shape of ``vol``) on the current stream, where the device word ``tier``
    (an int32 tensor, or None to run unconditionally) equals ``serve``.
    ``launch_gather_fwd.launches`` counts the launches."""
    _check(vol, shift)
    _check_out(out, vol, "out")
    _launch("vxm_warp_gather_fwd", (_f32(vol), shift.contiguous(), out),
            is_wide(vol.shape[1:-1], vol.shape[-1]), tier, serve, "warp_gather_fwd")
    launch_gather_fwd.launches += 1


launch_gather_fwd.launches = 0


def launch_gather_bwd(vol: torch.Tensor, shift: torch.Tensor, g: torch.Tensor,
                      dvol: Optional[torch.Tensor], dshift: torch.Tensor, tier=None,
                      serve: int = 0) -> None:
    """Write the VJP of the gather for the cotangent ``g`` into ``dvol`` and
    ``dshift`` (float32, the shapes of vol and shift) where ``tier`` equals
    ``serve``, in one launch: the volume gradient is added into ``dvol``
    with atomics (so the caller zeroes it; None computes no volume
    gradient), dshift is written, bit-equal to ``warp_gather_bwd_plain``'s.
    ``launch_gather_bwd.launches`` counts the launches."""
    _check(vol, shift)
    if dvol is not None:
        _check_out(dvol, vol, "dvol")
    _check_out(dshift, shift, "dshift")
    _launch("vxm_warp_gather_bwd", (_f32(vol), shift.contiguous(), _f32(g), dvol, dshift),
            is_wide(vol.shape[1:-1], vol.shape[-1]), tier, serve, "warp_gather_bwd")
    launch_gather_bwd.launches += 1


launch_gather_bwd.launches = 0
