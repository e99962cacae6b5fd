"""Bounded-displacement trilinear warp: CUDA kernel wrapper and plain version.

Counterpart of ``voxelmorph_tpu/ops/pallas_interp.py`` (forward only). For
``|shift| <= halo`` the trilinear warp is exactly

    out[x] = sum_{o in [-halo, halo]^3} prod_d max(0, 1 - |d_d(x) - o_d|) * vol[x + o]

with ``d = clamp(x + shift, 0, dim - 1) - x`` and ``vol`` edge-padded.
``windowed_transform`` computes that sum of shifted slices with plain tensor
ops (the port of ``voxelmorph_tpu.ops.warp.windowed_transform``);
``warp_bounded`` runs the hand-written CUDA kernel ``csrc/warp_bounded.cu``
on CUDA tensors and the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from .. import _build
from .interp import ndgrid

__all__ = ["windowed_transform", "warp_bounded"]

_MAX_CHANNELS = 4


def windowed_transform(vol: torch.Tensor, loc_shift: torch.Tensor, halo: int) -> torch.Tensor:
    """Dense warp for displacements bounded by ``halo`` voxels, as a sum of
    ``(2 halo + 1)^N`` contiguous shifted slices of the edge-padded volume.

    vol: ``(..., *S, C)``; loc_shift: ``(..., *S, N)`` with ``N == len(S)``
    and the same leading (batch) axes. Only correct where ``|shift| <= halo``
    element-wise. Coordinates are clamped to ``[0, dim - 1]`` like the gather.
    """
    nd = loc_shift.shape[-1]
    spatial = vol.shape[-nd - 1:-1]
    first = vol.dim() - nd - 1  # first spatial axis
    grid = ndgrid(spatial, dtype=loc_shift.dtype, device=loc_shift.device)
    max_loc = torch.tensor([s - 1 for s in spatial], dtype=loc_shift.dtype,
                           device=loc_shift.device)
    coords = torch.minimum(torch.clamp(grid + loc_shift, min=0.0), max_loc)
    d = coords - grid  # effective shift after clamping, |d| <= halo

    # edge padding by clamped index
    vol_p = vol
    for axis, s in enumerate(spatial):
        idx = torch.arange(-halo, s + halo, device=vol.device).clamp(0, s - 1)
        vol_p = vol_p.index_select(first + axis, idx)

    out = torch.zeros_like(vol)
    lead = (slice(None),) * first
    for off in itertools.product(range(-halo, halo + 1), repeat=nd):
        w = None
        for axis in range(nd):
            t = torch.clamp(1.0 - torch.abs(d[..., axis] - off[axis]), min=0.0)
            w = t if w is None else w * t
        idx = lead + tuple(slice(halo + off[a], halo + off[a] + spatial[a])
                           for a in range(nd))
        out = out + vol_p[idx] * w[..., None]
    return out


def _check(vol: torch.Tensor, loc_shift: torch.Tensor, halo: int) -> None:
    if vol.dim() != 5 or loc_shift.dim() != 5 or loc_shift.shape[-1] != 3:
        raise ValueError("warp_bounded takes vol (B, D, H, W, C) and shift "
                         f"(B, D, H, W, 3); got {tuple(vol.shape)} and "
                         f"{tuple(loc_shift.shape)}")
    if vol.shape[:-1] != loc_shift.shape[:-1]:
        raise ValueError(f"vol {tuple(vol.shape)} and shift "
                         f"{tuple(loc_shift.shape)} differ in batch or space")
    if not 1 <= vol.shape[-1] <= _MAX_CHANNELS:
        raise ValueError(f"warp_bounded takes 1 to {_MAX_CHANNELS} channels, "
                         f"got {vol.shape[-1]}")
    if not (vol.is_floating_point() and loc_shift.is_floating_point()):
        raise TypeError("warp_bounded takes floating-point vol and shift")
    if int(halo) != halo or not 1 <= halo <= 4:
        raise ValueError(f"halo must be an integer in [1, 4], got {halo}")
    if vol.device != loc_shift.device:
        raise ValueError(f"vol on {vol.device} and shift on {loc_shift.device}")


def warp_bounded(vol: torch.Tensor, loc_shift: torch.Tensor, halo: int) -> torch.Tensor:
    """Trilinear warp of vol (B, D, H, W, C) by loc_shift (B, D, H, W, 3),
    valid where ``|loc_shift| <= halo`` element-wise (the caller checks).

    On CUDA tensors this launches the CUDA kernel (building it at first use)
    and raises if the build or the launch fails; on CPU tensors it computes
    ``windowed_transform``. The output has the promoted dtype of the inputs;
    the kernel itself computes in float32. ``warp_bounded.launches`` counts
    kernel launches.
    """
    _check(vol, loc_shift, halo)
    out_dtype = torch.promote_types(vol.dtype, loc_shift.dtype)
    if vol.device.type == "cpu":
        return windowed_transform(vol, loc_shift, int(halo)).to(out_dtype)
    if vol.device.type != "cuda":
        raise ValueError(f"warp_bounded runs on CUDA or CPU tensors, not {vol.device}")

    v = vol.to(torch.float32).contiguous()
    s = loc_shift.to(torch.float32).contiguous()
    out = torch.empty_like(v)
    B, D, H, W, C = v.shape
    lib = _build.load("warp_bounded")
    fn = lib.vxm_warp_bounded_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(v.data_ptr(), s.data_ptr(), out.data_ptr(),
                 B, D, H, W, C, int(halo), stream)
    if err != 0:
        raise RuntimeError(f"warp_bounded CUDA kernel failed to launch: CUDA error {err} "
                           f"(B={B}, D={D}, H={H}, W={W}, C={C}, halo={halo})")
    warp_bounded.launches += 1
    return out.to(out_dtype)


warp_bounded.launches = 0
