"""Image-synthesis ops: separable Gaussian blur, multi-scale noise fields,
barycenters and the matrix square root.

Counterpart of ``voxelmorph_tpu/ops/image.py``. ``draw_multiscale_noise``
is split into its draws, from an explicit ``torch.Generator``, and the
deterministic map from them (``multiscale_noise_from_draws``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from .interp import resize

__all__ = ["gaussian_blur", "draw_multiscale_noise", "multiscale_noise_draws",
           "multiscale_noise_from_draws", "barycenter", "sqrtm"]


def gaussian_blur(x: torch.Tensor, sigma, max_sigma: Optional[float] = None) -> torch.Tensor:
    """Separable Gaussian blur over the spatial axes of ``x`` ``(*S, C)``,
    edge-padded. The kernel's radius is ``ceil(3 max_sigma)`` (``max_sigma``
    defaults to ``sigma``, which may be a tensor when it is given); sigma 0
    is the identity."""
    if max_sigma is None:
        if isinstance(sigma, torch.Tensor):
            raise ValueError("max_sigma is required when sigma is a tensor")
        max_sigma = float(sigma)
    radius = max(int(math.ceil(3 * max_sigma)), 1)
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    sig = torch.clamp(torch.as_tensor(sigma, dtype=torch.float32, device=x.device), min=1e-5)
    kernel = torch.exp(-0.5 * (offsets / sig) ** 2)
    kernel = kernel / torch.sum(kernel)
    out = x
    for axis in range(x.dim() - 1):
        moved = torch.movedim(out, axis, -1)
        n = moved.shape[-1]
        idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
        padded = moved.index_select(-1, idx)
        acc = torch.zeros_like(moved)
        for i in range(2 * radius + 1):
            acc = acc + kernel[i] * padded[..., i:i + n]
        out = torch.movedim(acc, -1, axis)
    return out


def _small_shape(shape, scale) -> Tuple[int, ...]:
    return tuple(max(int(math.ceil(s / scale)), 2) for s in shape)


def multiscale_noise_draws(generator: Optional[torch.Generator], shape: Sequence[int], scales,
                           max_std: float, nb_channels: int = 1, isotropic_std: bool = True,
                           device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The draws of ``draw_multiscale_noise``, one (std, noise) pair per
    scale: std uniform in [0, max_std) (one, or one per channel), noise a
    standard normal on the grid downsampled by the scale."""
    scales = scales if isinstance(scales, (list, tuple)) else [scales]
    shape = tuple(int(s) for s in shape)
    draws = []
    for scale in scales:
        std_shape = (1,) * (len(shape) + 1) if isotropic_std else (*([1] * len(shape)),
                                                                  nb_channels)
        std = torch.rand(std_shape, generator=generator, device=device) * max_std
        noise = torch.randn((*_small_shape(shape, scale), nb_channels), generator=generator,
                            device=device)
        draws.append((std, noise))
    return draws


def multiscale_noise_from_draws(draws, shape: Sequence[int]) -> torch.Tensor:
    """The smooth field ``(*shape, C)`` of (std, noise) draws: each noise
    times its std, resized (linear) to ``shape`` and summed."""
    shape = tuple(int(s) for s in shape)
    total = None
    for std, noise in draws:
        noise = noise * std
        small = tuple(noise.shape[:-1])
        if small != shape:
            noise = resize(noise, [s / t for s, t in zip(shape, small)], new_shape=shape)
        total = noise if total is None else total + noise
    return total


def draw_multiscale_noise(generator: Optional[torch.Generator], shape: Sequence[int], scales,
                          max_std: float, nb_channels: int = 1, isotropic_std: bool = True,
                          device=None) -> torch.Tensor:
    """A smooth random field ``(*shape, nb_channels)``: per scale, normal
    noise of a std drawn in [0, max_std) on a grid downsampled by the scale,
    upsampled (linear) to ``shape``, summed over the scales."""
    return multiscale_noise_from_draws(
        multiscale_noise_draws(generator, shape, scales, max_std, nb_channels, isotropic_std,
                               device), shape)


def barycenter(feat: torch.Tensor, normalize: bool = True,
               shift_center: bool = True) -> torch.Tensor:
    """The centre of mass of each channel of non-negative maps
    ``(B, *S, K)``, ``(B, K, N)`` in ij order: relative to the grid centre
    with ``shift_center``, divided by each axis's size with ``normalize``."""
    spatial = feat.shape[1:-1]
    nd = len(spatial)
    b, k = feat.shape[0], feat.shape[-1]
    denom = torch.sum(feat.reshape(b, -1, k), dim=1) + 1e-8
    coords = []
    for d, s in enumerate(spatial):
        ax = torch.arange(s, dtype=torch.float32, device=feat.device)
        if shift_center:
            ax = ax - 0.5 * (s - 1)
        if normalize:
            ax = ax / s
        bshape = [1] * (nd + 2)
        bshape[d + 1] = s
        num = torch.sum((feat * ax.reshape(bshape)).reshape(b, -1, k), dim=1)
        coords.append(num / denom)
    return torch.stack(coords, dim=-1)


def sqrtm(mat: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """The principal square root of ``(..., M, M)`` matrices by ``iters``
    Denman-Beavers iterations (matrices with no eigenvalue on the closed
    negative real axis)."""
    y = mat
    z = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device).expand(mat.shape)
    for _ in range(iters):
        y, z = 0.5 * (y + torch.linalg.inv(z)), 0.5 * (z + torch.linalg.inv(y))
    return y
