"""Affine-matrix algebra for 2-D and 3-D registration.

Counterpart of the matrix helpers of ``voxelmorph_tpu/ops/affine.py``, with
its conventions: ``(N, N+1)`` or ``(N+1, N+1)`` matrices acting on ij
coordinates, any leading batch axes, differentiable throughout.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["is_affine_shape", "validate_affine_shape", "make_square_affine",
           "affine_add_identity", "affine_remove_identity", "invert_affine",
           "rescale_affine", "affine_to_dense_shift", "angles_to_rotation_matrix",
           "params_to_affine_matrix", "rotation_matrix_to_angles", "affine_matrix_to_params",
           "fit_affine"]


def is_affine_shape(shape) -> bool:
    """True if a (batch-free) shape is ``(M, N+1)`` with N in (2, 3) and M in
    (N, N+1); raises for a matrix shape of another N or M. A trailing dim of
    1 is never an affine (it is a 1-D dense field)."""
    if len(shape) == 2 and shape[-1] != 1:
        validate_affine_shape(shape)
        return True
    return False


def validate_affine_shape(shape) -> None:
    ndim = shape[-1] - 1
    rows = shape[-2]
    if ndim not in (2, 3):
        raise ValueError(f"Affine matrix must be 2D or 3D, got {ndim}D")
    if rows not in (ndim, ndim + 1):
        raise ValueError(f"{ndim}D affine matrix must have {ndim} or {ndim + 1} rows, got {rows}.")


def make_square_affine(mat: torch.Tensor) -> torch.Tensor:
    """``(..., N, N+1)`` -> ``(..., N+1, N+1)`` by appending the (0, ..., 0, 1) row."""
    validate_affine_shape(mat.shape)
    if mat.shape[-2] == mat.shape[-1]:
        return mat
    row = mat.new_zeros((*mat.shape[:-2], 1, mat.shape[-1]))
    row[..., 0, -1] = 1.0
    return torch.cat([mat, row], dim=-2)


def _eye_rows(mat: torch.Tensor) -> torch.Tensor:
    rows, ndp1 = mat.shape[-2:]
    return torch.eye(ndp1, dtype=mat.dtype, device=mat.device)[:rows]


def affine_add_identity(mat: torch.Tensor) -> torch.Tensor:
    return mat + _eye_rows(mat)


def affine_remove_identity(mat: torch.Tensor) -> torch.Tensor:
    return mat - _eye_rows(mat)


def invert_affine(mat: torch.Tensor) -> torch.Tensor:
    rows = mat.shape[-2]
    return torch.linalg.inv(make_square_affine(mat))[..., :rows, :]


def rescale_affine(mat: torch.Tensor, factor) -> torch.Tensor:
    """Scale the translation column by ``factor`` (a zoom of the target grid)."""
    return torch.cat([mat[..., :-1], mat[..., -1:] * factor], dim=-1)


def affine_to_dense_shift(matrix: torch.Tensor, shape: Sequence[int], shift_center: bool = True,
                          warp_right: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An affine matrix as a dense displacement field.

    Builds the ij grid of ``shape`` (centred on the image centre with
    ``shift_center``), adds ``warp_right`` (a dense warp composed on the
    right) if given, applies the matrix and subtracts the grid.

    Args:
      matrix: ``(..., M, N+1)`` affine, M in (N, N+1); any batch dims.
      shape: the N spatial dims of the output space.
      shift_center: centre the grid before the matrix product.
      warp_right: optional dense warp ``(..., *shape, N)``.

    Returns:
      The displacement, ``(..., *shape, N)``.
    """
    shape = tuple(int(s) for s in shape)
    ndims = len(shape)
    if not matrix.is_floating_point():
        matrix = matrix.to(torch.float32)
    if matrix.shape[-1] != ndims + 1:
        raise ValueError(
            f"Affine ({matrix.shape[-1] - 1}D) does not match target shape ({ndims}D).")
    validate_affine_shape(matrix.shape)

    axes = [torch.arange(s, dtype=matrix.dtype, device=matrix.device) for s in shape]
    if shift_center:
        axes = [ax - 0.5 * (s - 1) for ax, s in zip(axes, shape)]
    mesh = torch.stack([m.reshape(-1) for m in torch.meshgrid(*axes, indexing="ij")])  # (N, V)

    out = mesh
    if warp_right is not None:
        warp_right = warp_right.to(matrix.dtype)
        flat = warp_right.reshape(*warp_right.shape[:-1 - ndims], -1, ndims)
        out = out + flat.transpose(-1, -2)  # (..., N, V)

    out = matrix[..., :ndims, :-1] @ out + matrix[..., :ndims, -1:]
    out = (out - mesh).transpose(-1, -2)  # (..., V, N)
    return out.reshape(*matrix.shape[:-2], *shape, ndims)


def _as_float(x) -> torch.Tensor:
    """A tensor of ``x`` (a list or tuple stacked on a new last axis), in
    float32 unless it is already floating."""
    if isinstance(x, (list, tuple)):
        x = torch.stack([torch.as_tensor(a, dtype=torch.float32) for a in x], dim=-1)
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _matrix(rows) -> torch.Tensor:
    """Stack rows (lists of (...) tensors) into (..., R, C)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def angles_to_rotation_matrix(ang, deg: bool = True, ndims: int = 3) -> torch.Tensor:
    """Euler angles ``(..., M)`` (M <= 1 in 2-D, <= 3 in 3-D; missing ones
    zero) as a rotation matrix, intrinsic right-handed, ``R = X @ Y @ Z``.
    A scalar gives one matrix."""
    if ndims not in (2, 3):
        raise ValueError(f"Affine matrix must be 2D or 3D, but got ndims of {ndims}.")
    ang = _as_float(ang)
    scalar_input = ang.dim() == 0
    if scalar_input:
        ang = ang.reshape(1)
    num_ang = 1 if ndims == 2 else 3
    if ang.shape[-1] > num_ang:
        raise ValueError(f"Number of angles exceeds value {num_ang} expected for dimensionality.")
    pad = num_ang - ang.shape[-1]
    if pad > 0:
        ang = torch.cat([ang, ang.new_zeros((*ang.shape[:-1], pad))], dim=-1)
    if deg:
        ang = ang * (math.pi / 180.0)
    c, s = torch.cos(ang), torch.sin(ang)
    if ndims == 2:
        out = _matrix([[c[..., 0], -s[..., 0]], [s[..., 0], c[..., 0]]])
    else:
        one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])
        rx = _matrix([[one, zero, zero], [zero, c[..., 0], -s[..., 0]],
                      [zero, s[..., 0], c[..., 0]]])
        ry = _matrix([[c[..., 1], zero, s[..., 1]], [zero, one, zero],
                      [-s[..., 1], zero, c[..., 1]]])
        rz = _matrix([[c[..., 2], -s[..., 2], zero], [s[..., 2], c[..., 2], zero],
                      [zero, zero, one]])
        out = rx @ ry @ rz
    return out[0] if scalar_input else out


def params_to_affine_matrix(par, deg: bool = True, shift_scale: bool = False,
                            last_row: bool = False, ndims: int = 3) -> torch.Tensor:
    """(shift, rot, scale, shear) params ``(..., M)`` (M <= N (N + 1);
    missing ones the identity's: scale 1 unless ``shift_scale``, which
    gives scales as offsets from 1) as an affine matrix ``T @ R @ S @ E``,
    ``(..., N, N+1)`` or with ``last_row`` ``(..., N+1, N+1)``."""
    if ndims not in (2, 3):
        raise ValueError(f"Affine matrix must be 2D or 3D, but got ndims of {ndims}.")
    par = _as_float(par)
    scalar_input = par.dim() == 0
    if scalar_input:
        par = par.reshape(1)
    num_par = 6 if ndims == 2 else 12
    if par.shape[-1] > num_par:
        raise ValueError(f"Number of params exceeds value {num_par} expected for dimensionality.")
    n_shift, n_rot, n_scale, n_shear = (2, 1, 2, 1) if ndims == 2 else (3, 3, 3, 3)
    bounds = [n_shift, n_shift + n_rot, n_shift + n_rot + n_scale, num_par]
    defaults = torch.cat([par.new_zeros(bounds[1]),
                          par.new_full((n_scale,), 0.0 if shift_scale else 1.0),
                          par.new_zeros(n_shear)])
    m = par.shape[-1]
    if m < num_par:
        par = torch.cat([par, defaults[m:].expand(*par.shape[:-1], num_par - m)], dim=-1)
    shift = par[..., :bounds[0]]
    rot = par[..., bounds[0]:bounds[1]]
    scale = par[..., bounds[1]:bounds[2]]
    shear = par[..., bounds[2]:]
    one, zero = torch.ones_like(shear[..., 0]), torch.zeros_like(shear[..., 0])
    if ndims == 2:
        mat_shear = _matrix([[one, shear[..., 0]], [zero, one]])
    else:
        mat_shear = _matrix([[one, shear[..., 0], shear[..., 1]], [zero, one, shear[..., 2]],
                             [zero, zero, one]])
    diag = scale + 1.0 if shift_scale else scale
    mat_scale = torch.diag_embed(diag)
    mat_rot = angles_to_rotation_matrix(rot, deg=deg, ndims=ndims)
    out = mat_rot @ (mat_scale @ mat_shear)
    out = torch.cat([out, shift[..., None]], dim=-1)
    if last_row:
        row = out.new_zeros((*out.shape[:-2], 1, ndims + 1))
        row[..., 0, -1] = 1.0
        out = torch.cat([out, row], dim=-2)
    return out[0] if scalar_input else out


def rotation_matrix_to_angles(mat, deg: bool = True) -> torch.Tensor:
    """A rotation matrix ``(..., N, N)`` as its Euler angles, the inverse of
    ``angles_to_rotation_matrix``; at the gimbal lock (+-90 degrees about y)
    the first angle is 0."""
    mat = torch.as_tensor(mat).to(torch.float32)
    num_dim = mat.shape[-1]
    if num_dim not in (2, 3):
        raise ValueError("only 2D and 3D supported")

    def clip(x):
        return torch.clamp(x, -1.0, 1.0)

    if num_dim == 2:
        ang = torch.atan2(clip(mat[..., 1, 0]), clip(mat[..., 0, 0]))[..., None]
    else:
        ang2 = torch.asin(clip(mat[..., 0, 2]))
        ang1_a = torch.zeros_like(ang2)
        ang3_a = torch.atan2(clip(mat[..., 1, 0]), clip(mat[..., 1, 1]))
        c2 = torch.cos(ang2)

        def safe_div(a, b):
            return torch.where(b == 0, torch.zeros_like(a), a / torch.where(b == 0, 1.0, b))

        ang1_b = torch.atan2(clip(safe_div(-mat[..., 1, 2], c2)), clip(safe_div(mat[..., 2, 2], c2)))
        ang3_b = torch.atan2(clip(safe_div(-mat[..., 0, 1], c2)), clip(safe_div(mat[..., 0, 0], c2)))
        is_lock = torch.abs(torch.abs(ang2) - 0.5 * math.pi) < 1e-6
        ang = torch.stack([torch.where(is_lock, ang1_a, ang1_b), ang2,
                           torch.where(is_lock, ang3_a, ang3_b)], dim=-1)
    if deg:
        ang = ang * (180.0 / math.pi)
    return ang


def affine_matrix_to_params(mat, deg: bool = True) -> torch.Tensor:
    """An affine matrix ``(..., N or N+1, N+1)`` as (shift, rot, scale,
    shear) params, the inverse of ``params_to_affine_matrix``, through a
    Cholesky factor; a negative determinant negates the first scale."""
    mat = torch.as_tensor(mat).to(torch.float32)
    num_dim = mat.shape[-1] - 1
    if num_dim not in (2, 3) or mat.shape[-2] - num_dim not in (0, 1):
        raise ValueError(f"invalid affine shape {tuple(mat.shape)}")
    shift = mat[..., :num_dim, -1]
    lin = mat[..., :num_dim, :num_dim]
    lower = torch.linalg.cholesky(lin.transpose(-1, -2) @ lin)
    scale = torch.diagonal(lower, dim1=-2, dim2=-1)
    scale0 = scale[..., 0] * torch.sign(torch.linalg.det(lin))
    scale = torch.cat([scale0[..., None], scale[..., 1:]], dim=-1)
    upper = torch.linalg.inv(torch.diag_embed(scale)) @ lower.transpose(-1, -2)
    upper_flat = upper.reshape(*scale0.shape, num_dim * num_dim)
    shear = upper_flat[..., [1] if num_dim == 2 else [1, 2, 5]]
    zeros = mat.new_zeros((*scale0.shape, (num_dim - 1) * 3))
    strip_mat = params_to_affine_matrix(torch.cat([zeros, scale, shear], dim=-1),
                                        ndims=num_dim)[..., :-1]
    rot = rotation_matrix_to_angles(lin @ torch.linalg.inv(strip_mat), deg=deg)
    return torch.cat([shift, rot, scale, shear], dim=-1)


def fit_affine(x_source: torch.Tensor, x_target: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (weighted) least-squares affine ``(..., N, N+1)`` between point
    sets ``(..., M, N)``: ``x_source ~ mat[..., :-1] @ x_target^T +
    mat[..., -1:]`` (source coordinates in the target's space)."""
    ones = x_target.new_ones((*x_target.shape[:-1], 1))
    x = torch.cat([x_target, ones], dim=-1)
    x_t = x.transpose(-1, -2)
    if weights is not None:
        if weights.dim() == x.dim():
            weights = weights[..., 0]
        x_t = x_t * weights[..., None, :]
    beta = torch.linalg.inv(x_t @ x) @ x_t @ x_source
    return beta.transpose(-1, -2)
