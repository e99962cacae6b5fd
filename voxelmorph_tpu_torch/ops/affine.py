"""Affine-matrix algebra for 2-D and 3-D registration.

Counterpart of the matrix helpers of ``voxelmorph_tpu/ops/affine.py``, with
its conventions: ``(N, N+1)`` or ``(N+1, N+1)`` matrices acting on ij
coordinates, any leading batch axes, differentiable throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["is_affine_shape", "validate_affine_shape", "make_square_affine",
           "affine_add_identity", "affine_remove_identity", "invert_affine",
           "rescale_affine", "affine_to_dense_shift"]


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
