"""N-D image utilities on torch tensors: zoom, Gaussian blur, connected
components and the Euclidean distance transform.

The port's copy of ``voxelmorph_tpu/py/ndimage.py``, with its algorithms and
its float64 operation order, computed on the device of the input tensor:
the endpoint-aligned zoom, the separable reflect-padded blur as a weighted
sum of shifted copies, the min-label propagation to its fixed point (along
whole runs of voxels, the same fixed point in fewer sweeps), and the exact
min-plus EDT per axis. Each gives, bit for bit, what the numpy version
gives on the same input: integer labels, exact sums of integer squared
distances, and the same float64 products and sums in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["zoom", "gaussian_filter", "label_components", "distance_transform_edt"]


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(device)


def zoom(array: torch.Tensor, factors, order: int = 0) -> torch.Tensor:
    """Resize by per-axis factors with nearest (order 0) or linear (order 1)
    interpolation. Each axis gets ``round(size * factor)`` samples whose
    coordinates map the first and last samples onto the input's."""
    if np.isscalar(factors):
        factors = [factors] * array.dim()
    out_shape = [int(round(s * f)) for s, f in zip(array.shape, factors)]
    out = array
    for axis, n_out in enumerate(out_shape):
        n_in = out.shape[axis]
        if n_out == n_in:
            continue
        # the sample coordinates in float64 on the host, as numpy makes them
        coords = np.zeros(1) if n_out == 1 else np.arange(n_out) * (n_in - 1) / (n_out - 1)
        if order == 0:
            idx = np.clip(np.round(coords).astype(int), 0, n_in - 1)
            out = out.index_select(axis, _index(idx, out.device))
        else:
            lo = np.clip(np.floor(coords).astype(int), 0, n_in - 1)
            hi = np.clip(lo + 1, 0, n_in - 1)
            w = torch.from_numpy(coords - lo).to(out.device).reshape(
                [-1 if a == axis else 1 for a in range(out.dim())])
            out = (out.index_select(axis, _index(lo, out.device)) * (1 - w)
                   + out.index_select(axis, _index(hi, out.device)) * w)
    return out


def _gauss_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_filter(array: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur in float64 with reflect padding (scipy's
    default mode; symmetric where an axis is shorter than the radius)."""
    out = array.to(torch.float64)
    if sigma <= 0:
        return out
    k = _gauss_kernel1d(sigma, truncate)
    r = (len(k) - 1) // 2
    for axis in range(out.dim()):
        moved = out.movedim(axis, -1)
        n = moved.shape[-1]
        pad = min(r, n - 1) if n > 1 else 0
        mode = "symmetric" if pad < r else "reflect"
        src = np.pad(np.arange(n), (r, r), mode=mode)
        padded = moved.index_select(-1, _index(src, out.device))
        acc = torch.zeros_like(moved)
        for i, w in enumerate(k):
            acc += float(w) * padded[..., i:i + n]
        out = acc.movedim(-1, axis)
    return out


def _run_min(cur: torch.Tensor, bw: torch.Tensor, axis: int, big: int) -> torch.Tensor:
    """Each foreground voxel's least label over its run: the unbroken line
    of foreground voxels along ``axis`` that holds it."""
    moved = cur.movedim(axis, -1).contiguous()
    fg = bw.movedim(axis, -1).contiguous()
    n = moved.shape[-1]
    lines = moved.numel() // n
    # a run id per line: each background voxel starts a new run (its label
    # is ``big``, so it changes no run's least label, and it keeps ``big``)
    run = torch.cumsum(~fg, dim=-1) + (n + 1) * torch.arange(
        lines, device=cur.device).reshape(fg.shape[:-1] + (1,))
    least = torch.full((lines * (n + 1),), big, dtype=cur.dtype, device=cur.device)
    least.scatter_reduce_(0, run.reshape(-1), moved.reshape(-1), "amin")
    return torch.where(fg, least[run], big).movedim(-1, axis)


def label_components(bw: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Label the face-connected components of a binary tensor: int64 labels,
    0 for the background and 1..K for the components in the order of their
    first voxel.

    Every foreground voxel starts with its flat index plus one and takes the
    least label along its runs of foreground voxels, axis after axis, until
    nothing changes; each component then holds its least index plus one
    everywhere, the fixed point of the JAX package's propagation between
    face neighbours, reached in far fewer sweeps. The labels are then
    numbered in ascending order.
    """
    if connectivity != 1:
        raise NotImplementedError("only face connectivity (1) is implemented")
    bw = bw.to(torch.bool).contiguous()
    big = torch.iinfo(torch.int64).max
    ids = torch.arange(1, bw.numel() + 1, dtype=torch.int64, device=bw.device).reshape(bw.shape)
    lab = torch.where(bw, ids, big)
    while True:
        new = lab
        for axis in range(bw.dim()):
            new = _run_min(new, bw, axis, big)
        if torch.equal(new, lab):
            break
        lab = new
    lab = torch.where(bw, lab, 0)
    # number the labels in ascending order (each label's rank in the sorted
    # unique labels, 0 the background's)
    uniq = torch.unique(lab)
    rank = torch.searchsorted(uniq, lab)
    if uniq.numel() and uniq[0].item() != 0:  # no background: labels start at 1
        rank = rank + 1
    return rank


def _edt_1d_sq(f: torch.Tensor) -> torch.Tensor:
    """Exact 1-D squared-distance transform along the last axis,
    ``out[i] = min_j (f[j] + (i - j)^2)``, as a min-plus product over chunks
    of scanlines."""
    n = f.shape[-1]
    f2 = f.reshape(-1, n)
    out = torch.empty_like(f2)
    # chunks of scanlines keep the (chunk, n, n) broadcast near 200 MB
    chunk = max(1, int(2.5e7 // (n * n) + 1))
    i = torch.arange(n, dtype=torch.float64, device=f.device)
    d2 = (i[None, :] - i[:, None]) ** 2
    for s in range(0, f2.shape[0], chunk):
        block = f2[s:s + chunk]
        out[s:s + chunk] = (block[:, None, :] + d2[None]).amin(dim=-1)
    return out.reshape(f.shape)


def distance_transform_edt(binary: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance (float64) from each non-zero voxel to the
    nearest zero voxel; zero voxels get 0 (scipy's convention)."""
    binary = binary.to(torch.bool)
    f = binary.to(torch.float64) * 1e12
    for axis in range(binary.dim()):
        f = _edt_1d_sq(f.movedim(axis, -1).contiguous()).movedim(-1, axis)
    if f.device.type == "cpu":
        # torch's vectorised float64 square root on the CPU can miss the
        # correctly rounded result by an ulp; numpy's and CUDA's round right
        return torch.from_numpy(np.sqrt(f.numpy()))
    return torch.sqrt(f)
