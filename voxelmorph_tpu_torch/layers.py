"""Batched transform layers: the counterpart of ``voxelmorph_tpu/layers.py``.

Each is an ``nn.Module`` with no parameters that holds its configuration
and maps a batch to a batch, with the JAX package's names, arguments and
shapes: images ``(B, *S, C)``, dense warps ``(B, *S, N)``, affines
``(B, M, N+1)`` with M in (N, N+1). Where the JAX package maps a function
over the batch with ``jax.vmap``, these stack its results per sample.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .ops import affine as affine_ops
from .ops import augment as augment_ops
from .ops import warp as warp_ops
from .ops.interp import resize as _resize

__all__ = ["SpatialTransformer", "VecInt", "VecIntegration", "RescaleTransform",
           "ComposeTransform", "AddIdentity", "InvertAffine", "ParamsToAffineMatrix",
           "AffineToDenseShift", "DrawAffineParams", "Resize"]


class SpatialTransformer(nn.Module):
    """Warp a batch of images by dense or affine transforms, called on
    ``(vol, trf)``: ``interp_method`` 'linear' or 'nearest',
    ``single_transform`` (transform 0 for every image), ``fill_value`` (None
    clamps to the edge), ``shift_center`` and ``shape`` for affines. Dense
    transforms on the images' grid take the batched tiered warp."""

    def __init__(self, interp_method: str = "linear", single_transform: bool = False,
                 fill_value: Optional[float] = None, shift_center: bool = True,
                 shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.interp_method = interp_method
        self.single_transform = single_transform
        self.fill_value = fill_value
        self.shift_center = shift_center
        self.shape = shape

    def _single(self, v, t):
        return warp_ops.transform(v, t, interp_method=self.interp_method,
                                  fill_value=self.fill_value, shift_center=self.shift_center,
                                  shape=self.shape, window_halo=None)

    def forward(self, inputs):
        vol, trf = inputs
        if self.single_transform:
            return torch.stack([self._single(v, trf[0]) for v in vol])
        if (not affine_ops.is_affine_shape(trf.shape[1:]) and self.shape is None
                and trf.dim() == vol.dim() and trf.shape[1:-1] == vol.shape[1:-1]):
            return warp_ops.transform_batched(vol, trf, interp_method=self.interp_method,
                                              fill_value=self.fill_value)
        return torch.stack([self._single(v, t) for v, t in zip(vol, trf)])


class VecInt(nn.Module):
    """Integrate a batch of velocity fields ``(B, *S, N)``: ``method`` 'ss'
    (the batched scaling and squaring), 'quadrature' or 'ode' (RK4 to
    ``out_time_pt``), in ``int_steps`` steps, each rematerialised in the
    backward with ``remat``."""

    def __init__(self, method: str = "ss", int_steps: int = 7, remat: bool = True,
                 out_time_pt: float = 1.0):
        super().__init__()
        self.method = method
        self.int_steps = int_steps
        self.remat = remat
        self.out_time_pt = out_time_pt

    def forward(self, vec):
        if vec.shape[-1] != vec.dim() - 2:
            raise ValueError(
                f"transform ndims {vec.shape[-1]} does not match expected {vec.dim() - 2}")
        if self.method in ("ss", "scaling_and_squaring"):
            return warp_ops.integrate_vec_batched(vec, nb_steps=self.int_steps, remat=self.remat)
        return torch.stack([warp_ops.integrate_vec(
            v, method=self.method, nb_steps=self.int_steps, remat=self.remat,
            out_time_pt=self.out_time_pt) for v in vec])


VecIntegration = VecInt


class RescaleTransform(nn.Module):
    """Rescale a batch of dense or affine transforms by ``zoom_factor``."""

    def __init__(self, zoom_factor, interp_method: str = "linear"):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.interp_method = interp_method

    def forward(self, trf):
        if affine_ops.is_affine_shape(trf.shape[1:]):
            return affine_ops.rescale_affine(trf, self.zoom_factor)
        return torch.stack([warp_ops.rescale_dense_transform(
            t, self.zoom_factor, interp_method=self.interp_method) for t in trf])


class ComposeTransform(nn.Module):
    """Compose a list of batched affine or dense transforms, in application
    order (``ops.warp.compose`` per sample)."""

    def __init__(self, interp_method: str = "linear", shift_center: bool = True,
                 shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.interp_method = interp_method
        self.shift_center = shift_center
        self.shape = shape

    def forward(self, transforms):
        if len(transforms) == 1:
            return transforms[0]
        return torch.stack([warp_ops.compose(
            list(ts), interp_method=self.interp_method, shift_center=self.shift_center,
            shape=self.shape) for ts in zip(*transforms)])


class AddIdentity(nn.Module):
    """Add the identity to a 'shift' affine given as matrices or as flat
    params ``(B, N (N + 1))``."""

    def forward(self, trf):
        if trf.dim() == 2:
            nb_params = trf.shape[-1]
            if nb_params not in (6, 12):
                raise ValueError(
                    f"flat affine must be of length 6 (2D) or 12 (3D), got {nb_params}")
            nd = 2 if nb_params == 6 else 3
            trf = trf.reshape(-1, nd, nd + 1)
        affine_ops.validate_affine_shape(trf.shape)
        return affine_ops.affine_add_identity(trf)


class InvertAffine(nn.Module):
    """Invert a batch of affine matrices."""

    def forward(self, matrix):
        return affine_ops.invert_affine(matrix)


class ParamsToAffineMatrix(nn.Module):
    """Affine params to matrices (``ops.affine.params_to_affine_matrix``)."""

    def __init__(self, ndims: int = 3, deg: bool = True, shift_scale: bool = False,
                 last_row: bool = False):
        super().__init__()
        self.ndims = ndims
        self.deg = deg
        self.shift_scale = shift_scale
        self.last_row = last_row

    def forward(self, params):
        return affine_ops.params_to_affine_matrix(params, deg=self.deg,
                                                  shift_scale=self.shift_scale,
                                                  last_row=self.last_row, ndims=self.ndims)


class AffineToDenseShift(nn.Module):
    """Affine matrices to dense shifts on a grid of ``shape``."""

    def __init__(self, shape: Sequence[int], shift_center: bool = True):
        super().__init__()
        self.shape = tuple(shape)
        self.shift_center = shift_center

    def forward(self, mat):
        affine_ops.validate_affine_shape(mat.shape)
        return affine_ops.affine_to_dense_shift(mat, self.shape, shift_center=self.shift_center)


class DrawAffineParams(nn.Module):
    """Random affine params for each batch element, called on a
    ``torch.Generator`` (JAX: a PRNG key) and the batch size."""

    def __init__(self, shift=None, rot=None, scale=None, shear=None, normal_shift=False,
                 normal_rot=False, normal_scale=False, normal_shear=False, shift_scale=False,
                 ndims=3, concat=True, dtype=torch.float32):
        super().__init__()
        self.kwargs = dict(shift=shift, rot=rot, scale=scale, shear=shear,
                           normal_shift=normal_shift, normal_rot=normal_rot,
                           normal_scale=normal_scale, normal_shear=normal_shear,
                           shift_scale=shift_scale, ndims=ndims, concat=concat, dtype=dtype)

    def forward(self, generator: Optional[torch.Generator], batch_size: int = 1, device=None):
        return augment_ops.draw_affine_params(generator, batch_shape=(batch_size,),
                                              device=device, **self.kwargs)


class Resize(nn.Module):
    """Resize a batch of images ``(B, *S, C)`` by ``zoom_factor``."""

    def __init__(self, zoom_factor, interp_method: str = "linear"):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.interp_method = interp_method

    def forward(self, vol):
        return torch.stack([_resize(v, self.zoom_factor, interp_method=self.interp_method)
                            for v in vol])
