"""Dense warps: apply, compose, rescale and integrate transforms.

Counterpart of ``voxelmorph_tpu/ops/warp.py``. A warp whose displacements are
all within a small halo runs the bounded-warp kernel (``ops.warp_bounded``);
any other warp runs the general gather (``ops.interp.interpn``), by the
tier index of the JAX package's ``lax.switch`` on ``max|shift|``. On CUDA
tensors the index stays on the device: every branch's kernel is launched
with it and only the one it names runs (``_TieredWarp``: the halo-1 and
full-halo bounded kernels, then the gather kernel of ``ops.warp_gather``),
forward and backward, so a warp never waits for the host. On the CPU the
host reads the index and runs that branch's plain version. Every tier is
differentiable in the volume and the shift: on the CPU the kernel tiers
through the bounded warp's autograd Function, the gather through autograd
of ``interpn``; on CUDA the predicated backward kernels compute the same
VJPs. ``transform`` also takes affine matrices and channelwise
shifts; ``compose``, ``integrate_vec`` (every method of the JAX package), the
point-cloud ops and ``jacobian_determinant`` run on the gather, as in JAX.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .affine import affine_to_dense_shift, is_affine_shape, make_square_affine
from .interp import interpn, ndgrid, resize
from . import warp_bounded as _wb
from .warp_bounded import warp_bounded
from .warp_gather import launch_gather_bwd, launch_gather_fwd

__all__ = ["transform", "transform_batched", "batch_transform", "compose",
           "integrate_vec", "integrate_vec_batched", "phase_warp_batched",
           "rescale_dense_transform", "point_spatial_transformer", "value_at_location",
           "jacobian_determinant"]

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
    full-halo kernel, anything larger the gather (the CPU's host choice)."""
    for h in sorted({1, int(window_halo)}):
        if max_d <= float(h):
            return windowed_fn(args, h)
    return gather_fn(args)


@functools.lru_cache(maxsize=None)
def _thresholds(halos, dtype, device) -> torch.Tensor:
    """The halos as a tensor of ``dtype`` on ``device``, made there (a fill,
    not a copy from the host)."""
    with torch.inference_mode(False):
        return torch.stack([torch.full((), float(h), dtype=dtype, device=device)
                            for h in halos])


def tier_index(shift: torch.Tensor, halos) -> torch.Tensor:
    """``sum(max|shift| > h for h in halos)`` as an int32 tensor on the
    shift's device (the JAX package's ``lax.switch`` index), compared in the
    shift's dtype, with no host synchronisation."""
    max_d = torch.linalg.vector_norm(shift.detach(), ord=float("inf"))
    return (max_d > _thresholds(tuple(halos), shift.dtype, shift.device)).sum(
        dtype=torch.int32)


class _TieredWarp(torch.autograd.Function):
    """The tiered warp of vol ``(B, D, H, W, C)`` by shift ``(B, D, H, W, 3)``
    on CUDA tensors: the tier index is computed on the device, and the
    bounded kernel at each of ``halos`` and then the gather kernel are
    launched with it, each running only where the index names it, into one
    output buffer. The backward launches the predicated backward kernels
    with the saved index, the branch the forward took (``lax.switch``'s
    VJP). The bounded kernels write every element of dvol and the gather
    adds into it, so dvol starts zeroed; where the volume needs no gradient
    (the image warp of a train step) the gather computes none."""

    @staticmethod
    def forward(ctx, vol, shift, halos):
        v, s = _wb._f32(vol), _wb._f32(shift)
        tier = tier_index(shift, halos)
        out = torch.empty_like(v)
        for i, h in enumerate(halos):
            _wb.launch_bounded_fwd(v, s, out, h, tier, i)
        launch_gather_fwd(v, s, out, tier, len(halos))
        ctx.halos = halos
        ctx.save_for_backward(vol, shift, tier)
        return out.to(torch.promote_types(vol.dtype, shift.dtype))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        vol, shift, tier = ctx.saved_tensors
        v, s, gg = _wb._f32(vol), _wb._f32(shift), _wb._f32(g)
        need_vol = ctx.needs_input_grad[0]
        dvol = torch.zeros_like(v) if need_vol else torch.empty_like(v)
        dshift = torch.empty_like(s)
        for i, h in enumerate(ctx.halos):
            _wb.launch_bounded_bwd(v, s, gg, dvol, dshift, h, tier, i)
        launch_gather_bwd(v, s, gg, dvol if need_vol else None, dshift, tier, len(ctx.halos))
        return dvol.to(vol.dtype) if need_vol else None, dshift.to(shift.dtype), None


def _tiered_warp(vols: torch.Tensor, shifts: torch.Tensor, window_halo: int) -> torch.Tensor:
    """The tiered warp of a batch (one tier for the whole batch): on CUDA
    with the index on the device, on the CPU by the host's choice."""
    if vols.device.type == "cuda":
        return _TieredWarp.apply(vols, shifts, tuple(sorted({1, int(window_halo)})))

    def gather(args):
        return torch.stack([transform(v, s, window_halo=None) for v, s in zip(*args)])

    return _tiered_windowed_switch((vols, shifts), lambda a, h: warp_bounded(a[0], a[1], h),
                                   gather, window_halo, shifts.abs().max().item())


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
              fill_value: Optional[float] = None, shift_center: bool = True,
              shape: Optional[Sequence[int]] = None,
              window_halo=DEFAULT_WINDOW_HALO) -> torch.Tensor:
    """Apply an affine or dense transform to a single (non-batched) image.

    The output at x holds the input at ``x + loc_shift(x)``.

    Args:
      vol: ``(*S, C)`` or ``(*S,)``.
      loc_shift: an affine ``(N, N+1)`` or ``(N+1, N+1)`` matrix, a dense
        displacement ``(*S_out, N)``, or channelwise ``(*S_out, C, N)``, one
        field per channel.
      interp_method: 'linear' or 'nearest'.
      fill_value: out-of-domain fill; None clamps to the edge.
      shift_center: centre the grid when densifying an affine.
      shape: output spatial shape when densifying an affine (incompatible
        with ``shift_center``).
      window_halo: halo of the bounded-warp fast path, None for the gather
        only, or "auto" (see ``_resolve_halo``).
    """
    if shape is not None and shift_center:
        raise ValueError("`shape` option incompatible with `shift_center=True`")
    if not vol.is_floating_point():
        vol = vol.to(torch.float32)
    if not loc_shift.is_floating_point():
        loc_shift = loc_shift.to(torch.float32)

    squeeze_channel = False
    if is_affine_shape(loc_shift.shape):
        target_shape = vol.shape[:-1] if shape is None else shape
        if vol.dim() == loc_shift.shape[-1] - 1:  # vol has no channel axis
            target_shape = vol.shape if shape is None else shape
            vol = vol[..., None]
            squeeze_channel = True
        loc_shift = affine_to_dense_shift(loc_shift, target_shape, shift_center=shift_center)
    nd = loc_shift.shape[-1]
    if vol.dim() == nd:
        vol = vol[..., None]
        squeeze_channel = True

    if loc_shift.dim() - 1 == vol.dim():
        # channelwise (*S_out, C, N): each channel warped by its own field
        out = torch.stack([
            transform(vol[..., c], loc_shift[..., c, :], interp_method=interp_method,
                      fill_value=fill_value, window_halo=None)
            for c in range(vol.shape[-1])], dim=-1)
        return out[..., 0] if squeeze_channel else out

    def gather(args):
        v, s = args
        grid = ndgrid(s.shape[:-1], dtype=s.dtype, device=s.device)
        return interpn(v, grid + s, interp_method=interp_method, fill_value=fill_value)

    window_halo = _resolve_halo(window_halo, vol.device)
    if _use_window(window_halo, interp_method, fill_value, vol, loc_shift, batched=False):
        out = _tiered_warp(vol[None], loc_shift[None], window_halo)[0]
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
    return _tiered_warp(vols, shifts, window_halo)


def integrate_vec_batched(vec: torch.Tensor, nb_steps: int = 7, remat: bool = True,
                          window_halo=DEFAULT_WINDOW_HALO, return_root_steps: int = 0):
    """Scaling and squaring of a batch of stationary velocity fields
    ``(B, *S, N)``: ``v /= 2**nb_steps``, then ``nb_steps`` times
    ``v <- v + v o (id + v)``, each warp on its own tier (bounded kernel or
    gather) for the whole batch.

    ``remat`` recomputes each squaring step in the backward pass instead of
    keeping its intermediates (``_rematerialised``), as the JAX package's
    ``jax.checkpoint`` does: the recomputation sees the same field, so it
    takes the same tier. With ``return_root_steps = s > 0`` it also returns
    ``root``, the field after ``nb_steps - s`` squarings: the 2^s-th root of
    the result (composed with itself 2^s times it gives the result, up to
    interpolation error), as ``(final, root)``; see ``phase_warp_batched``.
    """
    if nb_steps < 0:
        raise ValueError(f"nb_steps must be >= 0, got {nb_steps}")
    if not 0 <= return_root_steps <= nb_steps:
        raise ValueError(f"return_root_steps must be in [0, {nb_steps}], got {return_root_steps}")
    step = _rematerialised(lambda v: v + transform_batched(v, v, window_halo=window_halo),
                           remat)
    vec = vec / (2.0 ** nb_steps)
    root = vec
    for i in range(nb_steps):
        if i == nb_steps - return_root_steps:
            root = vec
        vec = step(vec)
    if return_root_steps:
        return vec, root
    return vec


def phase_warp_batched(vols: torch.Tensor, root: torch.Tensor, full_flow: torch.Tensor,
                       n_apps: int, halo: int) -> torch.Tensor:
    """Warp ``vols`` ``(B, *S, C)`` by ``full_flow`` as ``n_apps`` successive
    bounded warps by ``root``, its ``n_apps``-th root from
    ``integrate_vec_batched(..., return_root_steps=s)`` with ``n_apps = 2**s``:

        vols o full_flow  ==  ((vols o root) o root) ... (n_apps times)

    up to interpolation error (each application resamples the image). Each
    application is ``warp_bounded`` at ``halo`` (the CUDA kernel on CUDA
    tensors). When max|root| exceeds ``halo`` it warps once by ``full_flow``
    through the gather instead, the exact result: JAX's ``lax.cond``, on
    CUDA tensors with the condition on the device (``_PhaseWarp``). Returns
    float32.
    """
    if vols.device.type == "cuda":
        return _PhaseWarp.apply(vols, root, full_flow, int(n_apps), int(halo))
    if root.abs().max().item() <= float(halo):
        out = vols
        for _ in range(n_apps):
            out = warp_bounded(out, root, halo)
        return out.to(torch.float32)
    return torch.stack([transform(v, f, window_halo=None)
                        for v, f in zip(vols, full_flow)]).to(torch.float32)


class _PhaseWarp(torch.autograd.Function):
    """``phase_warp_batched`` on CUDA tensors: the branch index (0 where
    max|root| <= halo, else 1) stays on the device; the fast branch's
    ``n_apps`` bounded warps and the slow branch's gather are all launched
    with it, the last application and the gather into one output buffer,
    and only the named branch runs. The backward runs the same branch's
    predicated backward kernels into one zeroed dvols buffer (the bounded
    kernel writes all of it, the gather adds into it); the gradient of the
    branch not taken is zero, as for ``lax.cond``."""

    @staticmethod
    def forward(ctx, vols, root, full_flow, n_apps, halo):
        v, r, f = _wb._f32(vols), _wb._f32(root), _wb._f32(full_flow)
        tier = tier_index(root, (halo,))
        out = torch.empty_like(v)
        xs = [v]
        for k in range(n_apps):
            dst = out if k == n_apps - 1 else torch.empty_like(v)
            _wb.launch_bounded_fwd(xs[-1], r, dst, halo, tier, 0)
            xs.append(dst)
        launch_gather_fwd(v, f, out, tier, 1)
        ctx.halo = halo
        ctx.dtypes = vols.dtype, root.dtype, full_flow.dtype
        ctx.save_for_backward(*xs[:-1], r, f, tier)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *xs, r, f, tier = ctx.saved_tensors
        gg = _wb._f32(g)
        dvols = torch.zeros_like(xs[0])
        droot = None
        for k in reversed(range(len(xs))):
            dx = dvols if k == 0 else torch.empty_like(xs[0])
            dr = torch.empty_like(r)
            _wb.launch_bounded_bwd(xs[k], r, gg, dx, dr, ctx.halo, tier, 0)
            droot = dr if droot is None else droot + dr
            gg = dx
        dfull = torch.empty_like(f)
        launch_gather_bwd(xs[0], f, _wb._f32(g), dvols, dfull, tier, 1)
        droot = torch.where(tier == 0, droot, torch.zeros_like(droot))
        dfull = torch.where(tier == 1, dfull, torch.zeros_like(dfull))
        dt_v, dt_r, dt_f = ctx.dtypes
        return dvols.to(dt_v), droot.to(dt_r), dfull.to(dt_f), None, None


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


def batch_transform(vol: torch.Tensor, loc_shift: torch.Tensor, interp_method: str = "linear",
                    fill_value: Optional[float] = None) -> torch.Tensor:
    """Batched transform on the gather: vol ``(B, *S, C)`` by loc_shift
    ``(B, *S', N)`` (one field for all channels) or ``(B, *S', C, N)``
    (channelwise)."""
    if loc_shift.dim() not in (vol.dim(), vol.dim() + 1):
        raise ValueError(
            f"loc_shift rank {loc_shift.dim()} incompatible with vol rank {vol.dim()}")
    return torch.stack([transform(v, s, interp_method=interp_method, fill_value=fill_value,
                                  window_halo=None) for v, s in zip(vol, loc_shift)])


def compose(transforms: Sequence[torch.Tensor], interp_method: str = "linear",
            shift_center: bool = True, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Compose transforms listed in application order:
    ``compose([A, B, C])(x) = C(B(A(x)))``.

    Affine-only chains stay affine (a matrix product, ``(N, N+1)``); a dense
    member makes the result dense: a dense transform densifies an affine on
    its right, and an affine on the left folds a dense transform through
    ``affine_to_dense_shift(..., warp_right=)``.
    """
    if len(transforms) == 0:
        raise ValueError("Compose transform list cannot be empty")
    curr = None
    for nxt in reversed([torch.as_tensor(t) for t in transforms]):
        if not nxt.is_floating_point():
            nxt = nxt.to(torch.float32)
        if curr is None:
            curr = nxt
            continue
        if not is_affine_shape(nxt.shape):
            if is_affine_shape(curr.shape):
                curr = affine_to_dense_shift(curr, nxt.shape[:-1] if shape is None else shape,
                                             shift_center=shift_center)
            curr = curr + transform(nxt, curr, interp_method=interp_method, window_halo=None)
        elif not is_affine_shape(curr.shape):
            curr = affine_to_dense_shift(nxt, curr.shape[:-1], shift_center=shift_center,
                                         warp_right=curr)
        else:
            curr = (make_square_affine(nxt) @ make_square_affine(curr))[:-1]
    return curr


def _rematerialised(fn, remat: bool):
    """``fn`` recomputed in the backward pass instead of keeping its
    intermediates (``torch.utils.checkpoint``; JAX's ``jax.checkpoint``), when
    ``remat`` and autograd records. It changes memory, not values."""
    if not remat:
        return fn
    return lambda *args: (checkpoint(fn, *args, use_reentrant=False)
                          if torch.is_grad_enabled() else fn(*args))


def integrate_vec(vec: torch.Tensor, method: str = "ss", nb_steps: int = 7, remat: bool = True,
                  out_time_pt: float = 1.0, time_dep: bool = False) -> torch.Tensor:
    """Integrate a stationary or time-dependent velocity field, on the gather.

    Methods (integrating to time 1), as in the JAX package:
      'ss' / 'scaling_and_squaring': ``v /= 2**n``, then n times
        ``v <- v + v o (id + v)``. With ``time_dep``, ``vec`` has a leading
        time axis of length 2**n and adjacent pairs compose per level.
      'quadrature': ``v /= n``, then n - 1 compositions of the scaled field
        along the running displacement (time-dependent: one field per step).
      'ode': fixed-step RK4 of ``d(disp)/dt = vec o (id + disp)`` from 0 to
        ``out_time_pt`` in ``nb_steps`` steps.

    Args:
      vec: ``(*S, N)`` (single sample), or ``(T, *S, N)`` with ``time_dep``.
      remat: recompute each step in the backward pass (see
        ``_rematerialised``).
    """
    def t(a, b):
        return transform(a, b, window_halo=None)

    if method in ("ss", "scaling_and_squaring"):
        if nb_steps < 0:
            raise ValueError(f"nb_steps should be >= 0, found: {nb_steps}")
        if time_dep:
            if vec.shape[0] != 2 ** nb_steps:
                raise ValueError("time_dep ss needs a leading time axis of length 2**nb_steps")
            pair = _rematerialised(lambda a, b: b + t(a, b), remat)
            svec = vec / (2.0 ** nb_steps)
            for _ in range(nb_steps):
                svec = torch.stack([pair(a, b) for a, b in zip(svec[1::2], svec[0::2])])
            return svec[0]
        step = _rematerialised(lambda v: v + t(v, v), remat)
        vec = vec / (2.0 ** nb_steps)
        for _ in range(nb_steps):
            vec = step(vec)
        return vec
    if method == "quadrature":
        if nb_steps < 1:
            raise ValueError(f"nb_steps should be >= 1, found: {nb_steps}")
        vec = vec / nb_steps
        if time_dep:
            disp = vec[0]
            for si in range(nb_steps - 1):
                disp = disp + t(vec[si + 1], disp)
            return disp
        step = _rematerialised(lambda d: d + t(vec, d), remat)
        disp = vec
        for _ in range(nb_steps - 1):
            disp = step(disp)
        return disp
    if method == "ode":
        if time_dep:
            raise ValueError("ode not implemented for time-dependent fields")
        if nb_steps < 1:
            raise ValueError(f"nb_steps should be >= 1, found: {nb_steps}")
        h = out_time_pt / nb_steps

        def rk4_step(d):
            k1 = t(vec, d)
            k2 = t(vec, d + 0.5 * h * k1)
            k3 = t(vec, d + 0.5 * h * k2)
            k4 = t(vec, d + h * k3)
            return d + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

        rk4_step = _rematerialised(rk4_step, remat)
        disp = torch.zeros_like(vec)
        for _ in range(nb_steps):
            disp = rk4_step(disp)
        return disp
    raise ValueError(f"method must be 'ss', 'quadrature', or 'ode', found: {method}")


def point_spatial_transformer(points: torch.Tensor, trf: torch.Tensor,
                              sdt_vol_resize: float = 1.0) -> torch.Tensor:
    """Move points ``(M, N)`` (or ``(M, N+1)``, a trailing feature passed
    through) by a dense transform ``(*S, N)`` sampled at the points: the
    field that moves image A to B lives in B's space, so it maps points from
    B to A."""
    trf = trf * sdt_vol_resize
    pts_d, trf_d = points.shape[-1], trf.shape[-1]
    if pts_d not in (trf_d, trf_d + 1):
        raise ValueError(f"points of {pts_d} coordinates for a {trf_d}-D transform")
    extra = None
    if pts_d == trf_d + 1:
        extra = points[..., -1:]
        points = points[..., :-1]
    out = points + interpn(trf, points, interp_method="linear")
    if extra is not None:
        out = torch.cat([out, extra], dim=-1)
    return out


def value_at_location(vol: torch.Tensor, points: torch.Tensor,
                      force_post_absolute_val: bool = True) -> torch.Tensor:
    """A volume sampled (linear) at a point cloud, optionally ``abs()``. When
    the points cover every axis of ``vol``, the result gains a trailing
    singleton channel."""
    out = interpn(vol, points, interp_method="linear")
    if out.dim() == points.dim() - 1:
        out = out[..., None]
    return out.abs() if force_post_absolute_val else out


def jacobian_determinant(disp: torch.Tensor) -> torch.Tensor:
    """The Jacobian determinant of ``id + disp`` for a dense displacement
    ``(*S, N)``, N in (2, 3), by central differences (one-sided at the
    borders, ``np.gradient``'s convention); ``J[..., i, j] = d phi_i / d x_j``."""
    nd = disp.shape[-1]
    if nd not in (2, 3):
        raise ValueError("flow has to be 2D or 3D")
    grid = ndgrid(disp.shape[:-1], dtype=disp.dtype, device=disp.device)
    J = torch.stack(torch.gradient(grid + disp, dim=tuple(range(nd))), dim=-1)
    return torch.linalg.det(J)
