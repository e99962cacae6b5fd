"""Bounded-displacement trilinear warp: CUDA kernels, plain versions, autograd.

Counterpart of ``voxelmorph_tpu/ops/pallas_interp.py``. For
``|shift| <= halo`` the trilinear warp is exactly

    out[x] = sum_{o in [-halo, halo]^3} prod_d max(0, 1 - |d_d(x) - o_d|) * vol[x + o]

with ``d = clamp(x + shift, 0, dim - 1) - x`` and ``vol`` edge-padded.
``windowed_transform`` computes that sum of shifted slices with plain tensor
ops (the port of ``voxelmorph_tpu.ops.warp.windowed_transform``), and
``warp_bounded_bwd_plain`` its VJP as the Pallas backward kernel defines it
(the port of ``_warp_cf_bwd_ref``). ``warp_bounded`` is differentiable: on
CUDA tensors its forward and backward run the hand-written kernels of
``csrc/warp_bounded.cu``, on CPU tensors the two plain versions.
``launch_bounded_fwd`` and ``launch_bounded_bwd`` launch the kernels
predicated on a device word (the tiered warp of ``ops/warp.py``), and
``work_counter`` holds the device counts of the launches that ran.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from .. import _build
from .interp import ndgrid

__all__ = ["windowed_transform", "warp_bounded_bwd_plain", "warp_bounded",
           "warp_bounded_bwd", "launch_bounded_fwd", "launch_bounded_bwd", "work_counter",
           "read_work", "reset_work", "WORK_SLOTS"]

# the most channels the kernels take
MAX_CHANNELS = 4


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

    vol_p = _pad(vol, spatial, halo, first, "edge")
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


def _pad(x: torch.Tensor, spatial, halo: int, first: int, mode: str) -> torch.Tensor:
    """Pad the spatial axes (from axis ``first``) by ``halo`` voxels on each
    side: "edge" repeats the edge voxel (by clamped index), "zero" adds 0."""
    for axis, s in enumerate(spatial):
        if mode == "edge":
            idx = torch.arange(-halo, s + halo, device=x.device).clamp(0, s - 1)
            x = x.index_select(first + axis, idx)
        else:
            shape = list(x.shape)
            shape[first + axis] = halo
            zeros = x.new_zeros(shape)
            x = torch.cat([zeros, x, zeros], dim=first + axis)
    return x


def _check(vol: torch.Tensor, loc_shift: torch.Tensor, halo: int) -> None:
    if vol.dim() != 5 or loc_shift.dim() != 5 or loc_shift.shape[-1] != 3:
        raise ValueError("warp_bounded takes vol (B, D, H, W, C) and shift "
                         f"(B, D, H, W, 3); got {tuple(vol.shape)} and "
                         f"{tuple(loc_shift.shape)}")
    if vol.shape[:-1] != loc_shift.shape[:-1]:
        raise ValueError(f"vol {tuple(vol.shape)} and shift "
                         f"{tuple(loc_shift.shape)} differ in batch or space")
    if not 1 <= vol.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"warp_bounded takes 1 to {MAX_CHANNELS} channels, "
                         f"got {vol.shape[-1]}")
    if not (vol.is_floating_point() and loc_shift.is_floating_point()):
        raise TypeError("warp_bounded takes floating-point vol and shift")
    if int(halo) != halo or not 1 <= halo <= 4:
        raise ValueError(f"halo must be an integer in [1, 4], got {halo}")
    if vol.device != loc_shift.device:
        raise ValueError(f"vol on {vol.device} and shift on {loc_shift.device}")


def _tri(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _dtri(t: torch.Tensor) -> torch.Tensor:
    """Derivative of ``_tri``: -sign(t) where |t| < 1, else 0 (0 at t = 0)."""
    return torch.where(torch.abs(t) < 1.0, -torch.sign(t), torch.zeros_like(t))


def warp_bounded_bwd_plain(vol: torch.Tensor, loc_shift: torch.Tensor, g: torch.Tensor,
                           halo: int):
    """VJP of the bounded warp, as the Pallas backward kernel computes it.

    vol, g: ``(B, *S, C)``; loc_shift: ``(B, *S, 3)``. Returns (dvol, dshift)
    in the promoted floating dtype of the inputs (at least float32):

        dvol[u]     = sum_o w_o(u - o) g(u - o)   (zero where u - o is outside)
        dshift_a(x) = [0 < x_a + shift_a < dim_a - 1]
                      * sum_o dw_o/dd_a(x) <vol[x + o], g(x)>

    The strict interior mask gives a zero dshift where ``x + shift`` lies
    exactly on 0 or dim - 1, as the Pallas kernel does; autograd of
    ``windowed_transform`` passes a gradient there.
    """
    dt = torch.promote_types(torch.promote_types(vol.dtype, loc_shift.dtype),
                             torch.promote_types(g.dtype, torch.float32))
    vol, loc_shift, g = vol.to(dt), loc_shift.to(dt), g.to(dt)
    spatial = vol.shape[1:-1]
    grid = ndgrid(spatial, dtype=dt, device=vol.device)
    max_loc = torch.tensor([s - 1 for s in spatial], dtype=dt, device=vol.device)
    raw = grid + loc_shift
    d = torch.minimum(torch.clamp(raw, min=0.0), max_loc) - grid
    interior = (raw > 0.0) & (raw < max_loc)

    def window(x_p, off):
        return x_p[(slice(None),) + tuple(slice(halo + o, halo + o + s)
                                          for o, s in zip(off, spatial))]

    vol_p = _pad(vol, spatial, halo, 1, "edge")
    dvol = torch.zeros_like(vol)
    dshift = torch.zeros_like(loc_shift)
    for off in itertools.product(range(-halo, halo + 1), repeat=3):
        t = [d[..., a] - off[a] for a in range(3)]
        wz, wy, wx = (_tri(x) for x in t)
        w = wz * wy * wx
        # dvol[u] = sum_o (w_o g)(u - o): the weighted cotangent, zero-padded
        # and read at the flipped offset (edge taps carry zero weight)
        dvol = dvol + window(_pad(w[..., None] * g, spatial, halo, 1, "zero"),
                             tuple(-o for o in off))
        gv = torch.sum(g * window(vol_p, off), dim=-1)
        dshift = dshift + torch.stack([
            gv * _dtri(t[0]) * wy * wx,
            gv * wz * _dtri(t[1]) * wx,
            gv * wz * wy * _dtri(t[2]),
        ], dim=-1)
    dshift = torch.where(interior, dshift, torch.zeros_like(dshift))
    return dvol, dshift


# ctypes types of the entry points' arguments: the tensors, B, D, H, W, C,
# the halo, the tier word, the branch it serves, the work counter and the
# stream
_ARGTYPES = {name: [ctypes.c_void_p] * n + [ctypes.c_int] * 6
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
             for name, n in (("vxm_warp_bounded_fwd", 3), ("vxm_warp_bounded_bwd", 5))}

# The device counters of the warp kernels' launches that ran (past their
# tier word), one int32 each, by kernel; read once after a run
# (``read_work``), so that counting costs no host synchronisation.
WORK_SLOTS = ("warp_bounded_fwd", "warp_bounded_bwd", "warp_gather_fwd", "warp_gather_bwd")
_WORK = {}


def _work_counters(device) -> torch.Tensor:
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    counters = _WORK.get(index)
    if counters is None:
        counters = torch.zeros(len(WORK_SLOTS), dtype=torch.int32,
                               device=torch.device("cuda", index))
        _WORK[index] = counters
    return counters


def work_counter(device, kernel: str) -> int:
    """The device address of ``kernel``'s counter of launches that ran."""
    return _work_counters(device).data_ptr() + 4 * WORK_SLOTS.index(kernel)


def read_work(device="cuda") -> dict:
    """The launches of each warp kernel that ran since ``reset_work``; one
    host fetch."""
    return dict(zip(WORK_SLOTS, _work_counters(device).tolist()))


def reset_work(device="cuda") -> None:
    _work_counters(device).zero_()


def _launch(name: str, tensors, halo: int, tier, serve: int) -> None:
    """Launch the kernel entry point ``name`` of ``csrc/warp_bounded.cu`` on
    the current stream: ``tensors`` are its float32 inputs then outputs, the
    first shaped (B, D, H, W, C); it runs where the device word ``tier`` (an
    int32 tensor, or None for always) equals ``serve``. Raises if the launch
    fails."""
    B, D, H, W, C = tensors[0].shape
    fn = _build.entry_point("warp_bounded", name, _ARGTYPES[name])
    device = tensors[0].device
    slot = "warp_bounded_fwd" if name == "vxm_warp_bounded_fwd" else "warp_bounded_bwd"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), B, D, H, W, C, int(halo),
                 None if tier is None else tier.data_ptr(), int(serve),
                 work_counter(device, slot), stream)
    if err != 0:
        raise RuntimeError(f"{name} CUDA kernel failed to launch: CUDA error {err} "
                           f"(B={B}, D={D}, H={H}, W={W}, C={C}, halo={halo})")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def launch_bounded_fwd(vol: torch.Tensor, shift: torch.Tensor, out: torch.Tensor, halo: int,
                       tier, serve: int) -> None:
    """Write the bounded warp at ``halo`` of the float32 contiguous ``vol``
    by ``shift`` into ``out`` where the device word ``tier`` (an int32
    tensor, or None to run unconditionally) equals ``serve`` (counted on
    ``warp_bounded.launches``)."""
    _check(vol, shift, halo)
    _launch("vxm_warp_bounded_fwd", (vol, shift, out), halo, tier, serve)
    warp_bounded.launches += 1


def launch_bounded_bwd(vol: torch.Tensor, shift: torch.Tensor, g: torch.Tensor,
                       dvol: torch.Tensor, dshift: torch.Tensor, halo: int, tier,
                       serve: int) -> None:
    """Write the bounded warp's VJP at ``halo`` (float32 contiguous tensors)
    into ``dvol`` and ``dshift`` where the device word ``tier`` equals
    ``serve`` (counted on ``warp_bounded_bwd.launches``)."""
    _check(vol, shift, halo)
    _launch("vxm_warp_bounded_bwd", (vol, shift, g, dvol, dshift), halo, tier, serve)
    warp_bounded_bwd.launches += 1


def _warp_fwd_cuda(vol: torch.Tensor, loc_shift: torch.Tensor, halo: int) -> torch.Tensor:
    """Launch the forward kernel; float32 output."""
    v, s = _f32(vol), _f32(loc_shift)
    out = torch.empty_like(v)
    launch_bounded_fwd(v, s, out, halo, None, 0)
    return out


class _WarpBounded(torch.autograd.Function):
    """The bounded warp with the Pallas kernel's VJP (``_warp_bounded_cf``)."""

    @staticmethod
    def forward(ctx, vol, loc_shift, halo):
        ctx.halo = halo
        ctx.save_for_backward(vol, loc_shift)
        out_dtype = torch.promote_types(vol.dtype, loc_shift.dtype)
        if vol.device.type == "cpu":
            return windowed_transform(vol, loc_shift, halo).to(out_dtype)
        return _warp_fwd_cuda(vol, loc_shift, halo).to(out_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        vol, loc_shift = ctx.saved_tensors
        dvol, dshift = warp_bounded_bwd(vol, loc_shift, g, ctx.halo)
        # each gradient in its input's dtype (the output was promoted)
        return dvol.to(vol.dtype), dshift.to(loc_shift.dtype), None


def warp_bounded(vol: torch.Tensor, loc_shift: torch.Tensor, halo: int) -> torch.Tensor:
    """Trilinear warp of vol (B, D, H, W, C) by loc_shift (B, D, H, W, 3),
    valid where ``|loc_shift| <= halo`` element-wise (the caller checks).

    Differentiable in both arguments, with the VJP of the Pallas kernel
    (``warp_bounded_bwd``). On CUDA tensors the forward and the backward
    launch their CUDA kernels (built at first use) and raise if the build or
    a launch fails; on CPU tensors they run ``windowed_transform`` and
    ``warp_bounded_bwd_plain``. The output has the promoted dtype of the
    inputs; the kernels compute in float32. ``warp_bounded.launches`` counts
    forward kernel launches.
    """
    _check(vol, loc_shift, halo)
    if vol.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp_bounded runs on CUDA or CPU tensors, not {vol.device}")
    return _WarpBounded.apply(vol, loc_shift, int(halo))


warp_bounded.launches = 0


def warp_bounded_bwd(vol: torch.Tensor, loc_shift: torch.Tensor, g: torch.Tensor,
                     halo: int):
    """(dvol, dshift), the VJP of ``warp_bounded`` for the cotangent ``g``.

    On CUDA tensors this launches the backward kernel and raises if the
    build or the launch fails; on CPU tensors it computes
    ``warp_bounded_bwd_plain``. The kernel takes and returns float32.
    ``warp_bounded_bwd.launches`` counts kernel launches.
    """
    _check(vol, loc_shift, halo)
    if g.shape != vol.shape or g.device != vol.device:
        raise ValueError(f"cotangent {tuple(g.shape)} on {g.device} does not match vol "
                         f"{tuple(vol.shape)} on {vol.device}")
    if vol.device.type == "cpu":
        return warp_bounded_bwd_plain(vol, loc_shift, g, int(halo))
    if vol.device.type != "cuda":
        raise ValueError(f"warp_bounded_bwd runs on CUDA or CPU tensors, not {vol.device}")
    v, s = _f32(vol), _f32(loc_shift)
    dvol, dshift = torch.empty_like(v), torch.empty_like(s)
    launch_bounded_bwd(v, s, _f32(g), dvol, dshift, halo, None, 0)
    return dvol, dshift


warp_bounded_bwd.launches = 0
