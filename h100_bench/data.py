"""The inputs of every cell, made on the device from the run's seed: a stack
of brain-sized volumes of one synthetic subject, each deformed by its own
smooth displacement, its undeformed atlas, and Voronoi label maps of the
volumes' head masks. These are the benchmark's inputs: the program and the
reference are handed the same tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _smooth(g: torch.Generator, coarse: Sequence[int], shape: Sequence[int], channels: int,
            batch: int, device) -> torch.Tensor:
    """Normal noise on a coarse grid, trilinear to ``shape``: ``(batch, C, *shape)``."""
    noise = torch.randn((batch, channels, *coarse), generator=g, device=device)
    return F.interpolate(noise, size=tuple(shape), mode="trilinear", align_corners=True)


def volume_stack(n: int, shape: Sequence[int], seed: int, device,
                 max_disp: float = 3.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(stack (n, *shape, 1), atlas (1, *shape, 1))``, float32 in [0, 1]: the
    atlas is low-frequency noise (a 10x12x14 grid upsampled), and each
    volume of the stack is the atlas resampled at a smooth displacement (a
    5x6x7 grid of normal noise times ``max_disp`` voxels, upsampled)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = tuple(int(s) for s in shape)
    atlas = _smooth(g, (10, 12, 14), shape, 1, 1, device)
    atlas = (atlas - atlas.min()) / (atlas.max() - atlas.min())
    # grid_sample's normalised coordinates, x (last axis) first
    base = torch.stack(torch.meshgrid(*[torch.linspace(-1, 1, s, device=device)
                                        for s in shape], indexing="ij"), dim=-1).flip(-1)
    scale = torch.tensor([2.0 / max(s - 1, 1) for s in shape[::-1]], device=device)
    stack = torch.empty((n, *shape, 1), device=device)
    for i in range(n):
        disp = _smooth(g, (5, 6, 7), shape, 3, 1, device)[0] * max_disp
        loc = base + disp.permute(1, 2, 3, 0).flip(-1) * scale
        stack[i, ..., 0] = F.grid_sample(atlas, loc[None], mode="bilinear",
                                         padding_mode="border", align_corners=True)[0, 0]
    return stack, atlas.permute(0, 2, 3, 4, 1).contiguous()


def label_maps(volumes: torch.Tensor, values: Sequence[int], seed: int,
               threshold: float = 0.3) -> torch.Tensor:
    """Integer label maps ``(n, *S)`` of ``volumes`` ``(n, *S, 1)``: each
    volume's head mask (intensity above ``threshold``) cut into
    ``len(values) - 1`` Voronoi regions about centres drawn inside it, the
    regions labelled ``values[1:]`` and the outside ``values[0]``."""
    device = volumes.device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lut = torch.as_tensor(list(values), dtype=torch.int32, device=device)
    k = len(values) - 1
    spatial = volumes.shape[1:-1]
    coords = torch.stack(torch.meshgrid(*[torch.arange(s, device=device, dtype=torch.float32)
                                          for s in spatial], indexing="ij"), -1).reshape(-1, 3)
    out = torch.empty((volumes.shape[0], *spatial), dtype=torch.int32, device=device)
    for i, vol in enumerate(volumes):
        mask = (vol[..., 0] > threshold).reshape(-1)
        centres = coords[torch.multinomial(mask.float(), k, replacement=False, generator=g)]
        nearest = torch.empty(mask.numel(), dtype=torch.long, device=device)
        for lo in range(0, mask.numel(), 1 << 21):
            block = coords[lo:lo + (1 << 21)]
            d = (block[:, None, :] - centres[None]).square().sum(-1)
            nearest[lo:lo + (1 << 21)] = d.argmin(-1)
        out[i] = torch.where(mask, lut[nearest + 1], lut[0]).reshape(spatial)
    return out
