"""N-D interpolation: the general warp gather and separable resizing.

Counterpart of ``voxelmorph_tpu/ops/interp.py``. ``interpn`` samples a volume
at continuous ij locations with the JAX package's semantics: coordinates are
clamped to ``[0, dim - 1]`` before the floor (so samples past the edge take
the edge value), unless ``fill_value`` is given, in which case any location
outside ``[0, dim - 1]`` in any dimension gets ``fill_value``. Its autograd
gradients are those of the JAX package, at the volume's edges too. A
multi-channel volume whose corner table (``V * 2^N * C`` values) would pass
``_CORNER_TABLE_BYTES_LIMIT`` takes the JAX package's wide-channel path and
its rules (``_LinearGatherWide``). It is a plain tensor gather, not a kernel:
the JAX package leaves it to XLA too.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["ndgrid", "volshape_to_meshgrid", "interpn", "point_interpn",
           "interpn_label_onehot", "resize"]


# Above this corner-table footprint (V * 2^N * C * itemsize of the compute
# dtype) a multi-channel linear gather takes the wide-channel path, as in the
# JAX package (voxelmorph_tpu/ops/interp.py:_CORNER_TABLE_BYTES_LIMIT).
_CORNER_TABLE_BYTES_LIMIT = 1 << 30


def ndgrid(shape: Sequence[int], dtype=torch.float32, device=None, stacked: bool = True):
    """ij-indexed coordinate grid: ``(*shape, N)``, or with ``stacked=False``
    the list of its N ``(*shape,)`` coordinate arrays."""
    axes = [torch.arange(s, dtype=dtype, device=device) for s in shape]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(mesh, dim=-1) if stacked else list(mesh)


def volshape_to_meshgrid(shape: Sequence[int], indexing: str = "ij", dtype=torch.float32,
                         device=None):
    """The list of ij coordinate arrays of ``shape`` (neurite's name for
    ``ndgrid(..., stacked=False)``); only ij indexing exists."""
    if indexing != "ij":
        raise ValueError("only ij indexing is supported (xy was removed upstream)")
    return ndgrid(shape, dtype=dtype, device=device, stacked=False)


def _flatten_strides(spatial: Sequence[int]) -> list:
    strides, acc = [], 1
    for s in reversed(spatial):
        strides.append(acc)
        acc *= int(s)
    return list(reversed(strides))


def _clamp_with_jax_grad(loc: torch.Tensor, max_loc: int, edge_grad: float) -> torch.Tensor:
    """``loc`` clamped to ``[0, max_loc]``, with the derivative that the JAX
    package's ``interpn`` gives the clamp: 1 strictly inside, 0 strictly
    beyond, and ``edge_grad`` at exactly 0 or ``max_loc``. A single-channel
    volume takes JAX's hand-written gather VJP, which passes the whole
    gradient at the edge (``edge_grad`` 1); a wider one takes autodiff of
    ``jnp.clip``, whose max/min split a tie in half (``edge_grad`` 0.5)."""
    clamped = loc.clamp(0.0, max_loc)
    if not loc.requires_grad:
        return clamped
    inside = ((loc > 0) & (loc < max_loc)).to(loc.dtype)
    on_edge = ((loc == 0) | (loc == max_loc)).to(loc.dtype)
    slope = inside + edge_grad * on_edge
    return clamped.detach() + slope * (loc - loc.detach())


def _corners(nd: int, strides: Sequence[int]):
    """(bits, flat offset) of each of the 2^nd corners of a cell."""
    out = []
    for c in range(2 ** nd):
        bits = [(c >> d) & 1 for d in range(nd)]
        out.append((bits, sum(b * s for b, s in zip(bits, strides))))
    return out


def _floor_weights(loc_dims, max_loc, strides, dtype):
    """Per-dim floor-corner and +1-corner weights of the clamped locations,
    and the flat index of each location's floor corner."""
    idx0 = [torch.floor(l).long().clamp(0, m) for l, m in zip(loc_dims, max_loc)]
    w1 = [l.clamp(0.0, m) - i.to(dtype) for l, m, i in zip(loc_dims, max_loc, idx0)]
    w0 = [1.0 - w for w in w1]
    lin0 = functools.reduce(torch.add, [i * s for i, s in zip(idx0, strides)])
    return w0, w1, lin0


def _weight(w0, w1, bits, skip=None):
    """The product over dims (but ``skip``) of each dim's corner weight."""
    ws = [w1[d] if b else w0[d] for d, b in enumerate(bits) if d != skip]
    return functools.reduce(torch.mul, ws) if ws else None


class _LinearGatherWide(torch.autograd.Function):
    """The JAX package's wide-channel multilinear gather
    (``_linear_gather_wide``): 2^N per-corner gathers from a channels-first
    ``(C, V)`` volume, the +1 corner's flat index clipped to the last voxel.

    Its backward is JAX's custom VJP: each corner is gathered again from the
    saved volume (no ``(C, M)`` corner product is kept), d vol is a scatter
    add over the clipped rows, and d loc sums over channels and passes where
    ``0 <= loc <= dim - 1``, the edges included, and nowhere beyond.
    """

    @staticmethod
    def forward(ctx, vol_cf, spatial, *loc_dims):
        ctx.spatial = spatial
        ctx.save_for_backward(vol_cf, *loc_dims)
        strides = _flatten_strides(spatial)
        max_loc = [int(s) - 1 for s in spatial]
        w0, w1, lin0 = _floor_weights(loc_dims, max_loc, strides, loc_dims[0].dtype)
        last = vol_cf.shape[1] - 1
        out = None
        for bits, off in _corners(len(spatial), strides):
            term = vol_cf[:, (lin0 + off).clamp(max=last)] * _weight(w0, w1, bits)[None, :]
            out = term if out is None else out + term
        return out

    @staticmethod
    def backward(ctx, g):
        vol_cf, *loc_dims = ctx.saved_tensors
        spatial = ctx.spatial
        nd = len(spatial)
        strides = _flatten_strides(spatial)
        max_loc = [int(s) - 1 for s in spatial]
        w0, w1, lin0 = _floor_weights(loc_dims, max_loc, strides, loc_dims[0].dtype)
        acc_dtype = torch.promote_types(vol_cf.dtype, g.dtype)
        dvol = None
        if ctx.needs_input_grad[0]:
            dvol = torch.zeros(vol_cf.shape, dtype=acc_dtype, device=vol_cf.device)
        dloc = [torch.zeros_like(lin0, dtype=g.dtype) for _ in range(nd)]
        last = vol_cf.shape[1] - 1
        for bits, off in _corners(nd, strides):
            rows = (lin0 + off).clamp(0, last)
            if dvol is not None:
                dvol.index_add_(1, rows, (g * _weight(w0, w1, bits)[None, :]).to(acc_dtype))
            gv = (g * vol_cf[:, rows]).sum(dim=0)  # d loc sums over channels
            for d in range(nd):
                w_oth = _weight(w0, w1, bits, skip=d)
                term = gv if w_oth is None else gv * w_oth
                dloc[d] = dloc[d] + term if bits[d] else dloc[d] - term
        dloc = [dl * ((l >= 0) & (l <= m)).to(g.dtype)
                for dl, l, m in zip(dloc, loc_dims, max_loc)]
        return (None if dvol is None else dvol.to(vol_cf.dtype), None, *dloc)


def _linear_gather_wide(vol_cf: torch.Tensor, spatial, loc_dims) -> torch.Tensor:
    """``(C, V)`` volume at N ``(M,)`` coordinate vectors -> ``(C, M)``."""
    return _LinearGatherWide.apply(vol_cf, tuple(int(s) for s in spatial), *loc_dims)


def interpn(vol: torch.Tensor, loc: torch.Tensor, interp_method: str = "linear",
            fill_value: Optional[float] = None) -> torch.Tensor:
    """Interpolate an N-D volume at continuous ij locations.

    Args:
      vol: ``(*spatial, C)`` or ``(*spatial,)``.
      loc: ``(*out_shape, N)`` locations, ``N == len(spatial)``.
      interp_method: 'linear' (multilinear) or 'nearest'.
      fill_value: value for out-of-domain samples; None clamps to the edge.

    Returns:
      ``(*out_shape, C)`` (or ``(*out_shape,)`` if vol had no channel axis).
    """
    nd = loc.shape[-1]
    squeeze_channel = vol.dim() == nd
    if squeeze_channel:
        vol = vol[..., None]
    if vol.dim() != nd + 1:
        raise ValueError(
            f"vol rank {vol.dim()} incompatible with {nd}-D locations "
            f"(expected {nd} spatial dims + 1 channel dim)")
    spatial = vol.shape[:-1]
    nch = vol.shape[-1]
    compute_dtype = loc.dtype if loc.is_floating_point() else torch.float32
    loc = loc.to(compute_dtype)
    if not vol.is_floating_point():
        vol = vol.to(compute_dtype)

    out_shape = loc.shape[:-1]
    loc_dims = [loc[..., d].reshape(-1) for d in range(nd)]
    vol_flat = vol.reshape(-1, nch)
    strides = _flatten_strides(spatial)
    max_loc = [int(s) - 1 for s in spatial]

    if interp_method == "nearest":
        lin = functools.reduce(torch.add, [
            torch.round(l).long().clamp(0, m) * s
            for l, m, s in zip(loc_dims, max_loc, strides)])
        out = vol_flat[lin]
    elif (interp_method == "linear" and nch > 1 and vol_flat.shape[0] * 2 ** nd * nch
          * torch.finfo(compute_dtype).bits // 8 > _CORNER_TABLE_BYTES_LIMIT):
        # the JAX package's wide-channel path: channels first, the +1 corner
        # clipped to the last voxel, its own gradient rules at the edges
        out = _linear_gather_wide(vol_flat.movedim(-1, 0), spatial, loc_dims).movedim(0, -1)
    elif interp_method == "linear":
        idx0 = [torch.floor(l).long().clamp(0, m) for l, m in zip(loc_dims, max_loc)]
        # the clamped coordinate; its gradient is the JAX package's (see
        # _clamp_with_jax_grad): 1 inside, 0 strictly beyond the edges, and
        # at a coordinate exactly on 0 or dim - 1 the value for its nch
        edge_grad = 1.0 if nch == 1 else 0.5
        w1 = [_clamp_with_jax_grad(l, m, edge_grad) - i.to(compute_dtype)
              for l, m, i in zip(loc_dims, max_loc, idx0)]
        w0 = [1.0 - w for w in w1]
        lin0 = functools.reduce(torch.add, [i * s for i, s in zip(idx0, strides)])
        # the +1 corner of a coordinate on the top edge carries weight
        # exactly 0; it is read, as in the JAX package's corner table, at
        # the next voxel in flat order (wrapping at the end), which only its
        # coordinate gradient sees: append the wrapped rows once
        wrap = torch.arange(sum(strides), device=vol_flat.device) % vol_flat.shape[0]
        vol_flat = torch.cat([vol_flat, vol_flat[wrap]])
        out = None
        for c in range(2 ** nd):
            bits = [(c >> d) & 1 for d in range(nd)]
            lin = lin0 + sum(b * s for b, s in zip(bits, strides))
            w = functools.reduce(torch.mul, [w1[d] if b else w0[d]
                                             for d, b in enumerate(bits)])
            term = vol_flat[lin] * w[:, None]
            out = term if out is None else out + term
    else:
        raise ValueError(
            f"interp_method must be 'linear' or 'nearest', got {interp_method}")

    if fill_value is not None:
        valid = functools.reduce(torch.logical_and, [
            (l >= 0) & (l <= m) for l, m in zip(loc_dims, max_loc)])
        # the fill made on the device (a copy from the host would wait for it)
        out = torch.where(valid[:, None], out, out.new_full((), fill_value))

    out = out.reshape(*out_shape, nch)
    return out[..., 0] if squeeze_channel else out


def point_interpn(vol: torch.Tensor, points: torch.Tensor,
                  interp_method: str = "linear") -> torch.Tensor:
    """``vol`` ``(*S, C)`` interpolated at a point cloud ``(M, N)``."""
    return interpn(vol, points, interp_method=interp_method)


def interpn_label_onehot(image: torch.Tensor, lab_idx: torch.Tensor, loc: torch.Tensor,
                         nb_labels: int):
    """A scalar image and the one-hot encoding of an integer label map,
    interpolated (linear, clamped to the edge) together at continuous ij
    locations: the values of ``interpn`` of the two concatenated, without
    the one-hot ever being built.

    Each cell corner holds one label, so the one-hot's blend is each
    corner's weight added into the channel its label names: one scatter
    add per corner into an ``(M, L)`` buffer, in the JAX package's corner
    order (so each element sums its corners in JAX's order; the corners
    of other labels add nothing there). A label index outside
    ``[0, nb_labels)`` (-1: a label missing from the output list) adds
    nothing, as JAX's compare never matches it.

    Args:
      image: ``(*S,)`` float image.
      lab_idx: ``(*S,)`` integer label indices.
      loc: ``(*S', N)`` locations.
      nb_labels: L, the one-hot width.

    Returns:
      ``(image_out (*S',), one_hot (*S', L))``.
    """
    nd = loc.shape[-1]
    spatial = tuple(image.shape)
    if tuple(lab_idx.shape) != spatial:
        raise ValueError(f"label map {tuple(lab_idx.shape)} and image {spatial} differ")
    compute_dtype = loc.dtype if loc.is_floating_point() else torch.float32
    loc = loc.to(compute_dtype)
    out_shape = loc.shape[:-1]
    loc_dims = [loc[..., d].reshape(-1) for d in range(nd)]
    strides = _flatten_strides(spatial)
    max_loc = [s - 1 for s in spatial]
    w0, w1, lin0 = _floor_weights(loc_dims, max_loc, strides, compute_dtype)
    last = image.numel() - 1
    img_flat = image.to(compute_dtype).reshape(-1)
    lab_flat = lab_idx.reshape(-1).long()
    n = lin0.numel()
    column = torch.arange(n, device=loc.device) * nb_labels
    img_out = None
    one_hot = torch.zeros(n * nb_labels, dtype=compute_dtype, device=loc.device)
    for bits, off in _corners(nd, strides):
        # upper-edge cells: the +1 corner's row clamps and carries weight 0
        rows = (lin0 + off).clamp(0, last)
        w = _weight(w0, w1, bits)
        term = w * img_flat[rows]
        img_out = term if img_out is None else img_out + term
        lab = lab_flat[rows]
        valid = (lab >= 0) & (lab < nb_labels)
        one_hot.index_add_(0, column + lab.clamp(0, nb_labels - 1),
                           torch.where(valid, w, torch.zeros_like(w)))
    return img_out.reshape(out_shape), one_hot.reshape(*out_shape, nb_labels)


def _resize_matrix(n_in: int, n_out: int, factor: float, interp_method: str) -> np.ndarray:
    """(n_out, n_in) interpolation matrix sampling at arange(n_out)/factor,
    edge-clamped: the separable building block of ``resize``."""
    coords = np.arange(n_out, dtype=np.float64) / factor
    coords = np.clip(coords, 0, n_in - 1)
    W = np.zeros((n_out, n_in), dtype=np.float32)
    if interp_method == "nearest":
        idx = np.clip(np.round(coords).astype(int), 0, n_in - 1)
        W[np.arange(n_out), idx] = 1.0
    else:
        lo = np.clip(np.floor(coords).astype(int), 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        w_hi = (coords - lo).astype(np.float32)
        rows = np.arange(n_out)
        # accumulate (lo may equal hi at the top edge)
        np.add.at(W, (rows, lo), 1.0 - w_hi)
        np.add.at(W, (rows, hi), w_hi)
    return W


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(n_in: int, n_out: int, factor: float, interp_method: str,
                      device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_resize_matrix`` as a tensor on ``device``, cached: the serving path
    asks for the same few matrices on every call."""
    with torch.inference_mode(False):
        W = _resize_matrix(n_in, n_out, factor, interp_method)
        return torch.from_numpy(W).to(device, dtype)


def resize(vol: torch.Tensor, zoom_factor, interp_method: str = "linear",
           new_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Resize a single (non-batched) ``(*S, C)`` volume by a zoom factor.

    The output size is ``ceil(dim * factor)`` per spatial dim, sampled at
    ``arange(new_dim) / factor`` in input coordinates (edge-clamped), as one
    small dense matrix product per axis. The last axis is channels.
    """
    spatial = vol.shape[:-1]
    nd = len(spatial)
    if not isinstance(zoom_factor, (list, tuple)):
        zoom_factor = [float(zoom_factor)] * nd
    if new_shape is None:
        new_shape = [int(math.ceil(s * f)) for s, f in zip(spatial, zoom_factor)]
    if tuple(new_shape) == tuple(spatial) and all(f == 1 for f in zoom_factor):
        return vol

    out = vol
    for axis in range(nd):
        n_in, n_out = out.shape[axis], int(new_shape[axis])
        if n_in == n_out and zoom_factor[axis] == 1:
            continue
        dt = torch.promote_types(torch.float32, out.dtype)
        W = _resize_matrix_on(n_in, n_out, float(zoom_factor[axis]), interp_method,
                              out.device, dt)
        out = torch.movedim(torch.tensordot(W, out.to(dt), dims=([1], [axis])), 0, axis)
    return out
