"""Random spatial-augmentation draws (SynthMorph-style).

Counterpart of ``voxelmorph_tpu/ops/augment.py``. Each drawing function is
split in two: the draw, from an explicit ``torch.Generator`` (the JAX
package threads ``jax.random`` keys instead), and a deterministic map from
the draws to the result (``*_from_*``), which takes any draws of the same
distribution, for example the JAX package's own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["draw_flip_matrix", "flip_matrix_from_bits", "draw_swap_matrix",
           "swap_matrix_from_permutation", "draw_affine_params", "affine_param_draws",
           "affine_params_from_draws"]

_AFFINE_GROUPS = ("shift", "rot", "scale", "shear")


def _last_row(mat: torch.Tensor) -> torch.Tensor:
    row = mat.new_zeros((1, mat.shape[-1]))
    row[0, -1] = 1.0
    return torch.cat([mat, row], dim=0)


def flip_matrix_from_bits(rand_bit: torch.Tensor, grid_shape: Sequence[int],
                          shift_center: bool = True, last_row: bool = True) -> torch.Tensor:
    """The axis-flip matrix ``(M, N+1)`` (M = N, + 1 with ``last_row``) that
    flips each axis whose ``rand_bit`` is 1: about the centre, or with
    ``shift_center=False`` about index 0, re-centred by a translation of
    ``dim - 1``."""
    dtype = rand_bit.dtype
    sizes = torch.as_tensor(list(grid_shape), dtype=dtype, device=rand_bit.device)
    diag = torch.diag(torch.pow(torch.tensor(-1.0, dtype=dtype, device=rand_bit.device),
                                rand_bit))
    shift = (torch.zeros_like(sizes) if shift_center else (sizes - 1) * rand_bit)[:, None]
    out = torch.cat([diag, shift], dim=1)
    return _last_row(out) if last_row else out


def draw_flip_matrix(generator: Optional[torch.Generator], grid_shape: Sequence[int],
                     shift_center: bool = True, last_row: bool = True,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """A random axis-flip matrix: each axis flipped with probability 1/2
    (the sign of a standard normal draw, as in JAX)."""
    draw = torch.randn(len(grid_shape), generator=generator, device=device)
    return flip_matrix_from_bits((draw > 0).to(dtype), grid_shape, shift_center, last_row)


def swap_matrix_from_permutation(perm: torch.Tensor, ndims: int, last_row: bool = True,
                                 dtype=torch.float32) -> torch.Tensor:
    """The rows of ``eye(ndims, ndims + 1)`` in the order ``perm``."""
    mat = torch.eye(ndims, ndims + 1, dtype=dtype, device=perm.device)[perm]
    return _last_row(mat) if last_row else mat


def draw_swap_matrix(generator: Optional[torch.Generator], ndims: int, last_row: bool = True,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """A random axis-permutation matrix ``(M, N+1)``."""
    perm = torch.randperm(ndims, generator=generator, device=device)
    return swap_matrix_from_permutation(perm, ndims, last_row, dtype)


def _splits(ndims: int) -> dict:
    if ndims not in (2, 3):
        raise ValueError("only 2D and 3D supported")
    n = 1 if ndims == 2 else 3
    return dict(shift=ndims, rot=n, scale=ndims, shear=n)


def affine_param_draws(generator: Optional[torch.Generator], ndims: int = 3,
                       batch_shape: Optional[Sequence[int]] = None, normal_shift: bool = False,
                       normal_rot: bool = False, normal_scale: bool = False,
                       normal_shear: bool = False, dtype=torch.float32, device=None) -> dict:
    """The unit draws of ``draw_affine_params`` by group (shift, rot, scale,
    shear), each ``(*batch_shape, m)``: uniform in [-1, 1), or with the
    group's ``normal_*`` flag a standard normal (truncated at +-2 for the
    scales)."""
    normal = dict(shift=normal_shift, rot=normal_rot, scale=normal_scale, shear=normal_shear)
    batch = tuple(batch_shape) if batch_shape is not None else ()
    draws = {}
    for k, m in _splits(ndims).items():
        shape = (*batch, m)
        if normal[k] and k == "scale":
            draw = torch.nn.init.trunc_normal_(torch.empty(shape, dtype=dtype, device=device),
                                               0.0, 1.0, -2.0, 2.0, generator=generator)
        elif normal[k]:
            draw = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        else:
            draw = torch.rand(shape, generator=generator, dtype=dtype, device=device) * 2 - 1
        draws[k] = draw
    return draws


def affine_params_from_draws(draws: dict, shift=None, rot=None, scale=None, shear=None,
                             shift_scale: bool = False, ndims: int = 3,
                             concat: bool = True):
    """Affine (shift, rot, scale, shear) params from unit draws: each
    group's draws times its range (a scalar, or one value per parameter;
    None is 0), 1 added to the scales with ``shift_scale``; concatenated
    ``(..., K)`` or the 4-tuple."""
    inputs = dict(shift=shift, rot=rot, scale=scale, shear=shear)
    par = {}
    for k, m in _splits(ndims).items():
        lim = np.ravel(0 if inputs[k] is None else inputs[k]).astype(np.float32)
        if lim.size == 1:
            lim = np.repeat(lim, m)
        if lim.size != m:
            raise ValueError(f"unexpected number of parameters {lim.size} ({k})")
        draw = draws[k]
        par[k] = draw * torch.as_tensor(lim, dtype=draw.dtype, device=draw.device)
    if shift_scale:
        par["scale"] = par["scale"] + 1
    out = tuple(par[k] for k in _AFFINE_GROUPS)
    return torch.cat(out, dim=-1) if concat else out


def draw_affine_params(generator: Optional[torch.Generator], shift=None, rot=None, scale=None,
                       shear=None, normal_shift: bool = False, normal_rot: bool = False,
                       normal_scale: bool = False, normal_shear: bool = False,
                       shift_scale: bool = False, ndims: int = 3,
                       batch_shape: Optional[Sequence[int]] = None, concat: bool = True,
                       dtype=torch.float32, device=None):
    """Random (shift, rot, scale, shear) affine params: uniform in [-x, x]
    per parameter, or normal with SD x under the group's ``normal_*`` flag
    (scales truncated at 2 SD); ``shift_scale`` adds 1 to the scales."""
    draws = affine_param_draws(generator, ndims, batch_shape, normal_shift, normal_rot,
                               normal_scale, normal_shear, dtype, device)
    return affine_params_from_draws(draws, shift, rot, scale, shear, shift_scale, ndims, concat)
