"""Host-side numpy utilities that registration needs.

The port's own copies of ``voxelmorph_tpu.py.utils.default_unet_features``,
``read_file_list``, ``read_pair_list``, ``load_volfile``, ``save_volfile``
(for NIfTI (.nii/.nii.gz), .npy and .npz volumes), ``pad``, ``resize``,
``dice`` and ``jacobian_determinant``, and of its segmentation and surface
helpers (``extract_largest_vol`` to ``sdt_to_surface_pts``), which take
torch tensors and compute on their device (``py.ndimage``), with the point
draws on a numpy ``Generator`` as in the JAX package.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from . import io as _io
from . import ndimage as _ndi

__all__ = ["default_unet_features", "read_file_list", "read_pair_list", "load_volfile",
           "save_volfile", "pad", "resize", "dice", "jacobian_determinant",
           "extract_largest_vol", "clean_seg", "clean_seg_batch", "filter_labels", "dist_trf",
           "signed_dist_trf", "vol_to_sdt", "vol_to_sdt_batch", "get_surface_pts_per_label",
           "edge_to_surface_pts", "sdt_to_surface_pts"]


def default_unet_features():
    return [
        [16, 32, 32, 32],              # encoder
        [32, 32, 32, 32, 32, 16, 16],  # decoder
    ]


def read_file_list(filename, prefix=None, suffix=None):
    """Read a newline-separated list of files, with optional prefix/suffix."""
    with open(filename) as f:
        return [(prefix or "") + e + (suffix or "") for e in (line.strip() for line in f) if e]


def read_pair_list(filename, delim=None, prefix=None, suffix=None):
    """Read a list of registration file pairs (one delimited pair per line)."""
    return [[(prefix or "") + name + (suffix or "") for name in line.split(delim)]
            for line in read_file_list(filename)]


def load_volfile(filename, np_var="vol", add_batch_axis=False,
                 add_feat_axis=False, pad_shape=None, resize_factor=1, ret_affine=False):
    """Load a volume from nii, nii.gz, npz, or npy.

    Returns the array, or ``(array, affine)`` when ``ret_affine`` (the affine
    is None for numpy files). ``pad_shape`` zero-pads the volume (centred) to
    that shape; ``add_feat_axis`` appends a channel axis; ``resize_factor``
    resizes the spatial axes (nearest); ``add_batch_axis`` prepends a batch
    axis, in that order.
    """
    filename = str(filename) if isinstance(filename, pathlib.PurePath) else filename
    if not os.path.isfile(filename):
        raise ValueError(f"'{filename}' is not a file.")
    if filename.endswith((".nii", ".nii.gz")):
        vol, affine = _io.read_nifti(filename)
        vol = np.squeeze(vol)
    elif filename.endswith(".npy"):
        vol, affine = np.load(filename), None
    elif filename.endswith(".npz"):
        npz = np.load(filename)
        vol = next(iter(npz.values())) if len(npz.keys()) == 1 else npz[np_var]
        affine = None
    else:
        raise ValueError(f"unknown filetype for {filename}")

    if pad_shape:
        vol = pad(vol, pad_shape)[0]
    if add_feat_axis:
        vol = vol[..., None]
    if resize_factor != 1:
        vol = resize(vol, resize_factor)
    if add_batch_axis:
        vol = vol[None]
    return (vol, affine) if ret_affine else vol


def save_volfile(array, filename, affine=None):
    """Save to nii, nii.gz, or npz. Default affine is FreeSurfer LIA centered
    on the volume."""
    filename = str(filename) if isinstance(filename, pathlib.PurePath) else filename
    if filename.endswith((".nii", ".nii.gz")):
        if affine is None and array.ndim >= 3:
            affine = np.array(
                [[-1, 0, 0, 0],
                 [0, 0, 1, 0],
                 [0, -1, 0, 0],
                 [0, 0, 0, 1]], dtype=float)
            pcrs = np.append(np.array(array.shape[:3]) / 2, 1)
            affine[:3, 3] = -np.matmul(affine, pcrs)[:3]
        _io.write_nifti(filename, array, affine)
    elif filename.endswith(".npz"):
        np.savez_compressed(filename, vol=array)
    else:
        raise ValueError(f"unknown filetype for {filename}")


def pad(array, shape):
    """Zero-pad a numpy array to ``shape``, centred. Returns (padded, the
    slices that crop it back)."""
    if array.shape == tuple(shape):
        return array, ...
    lo = [(want - have) // 2 for want, have in zip(shape, array.shape)]
    window = tuple(slice(o, o + have) for o, have in zip(lo, array.shape))
    padded = np.zeros(shape, dtype=array.dtype)
    padded[window] = array
    return padded, window


def resize(array, factor, batch_axis=False):
    """Nearest-neighbour resize of every axis but the last (the features)
    and, with ``batch_axis``, the first, by ``factor`` (``ndimage.zoom``,
    order 0). Takes and returns a numpy array or a torch tensor."""
    if factor == 1:
        return array
    spatial = array.ndim - 1 - int(batch_axis)
    factors = [1] * int(batch_axis) + [factor] * spatial + [1]
    if isinstance(array, torch.Tensor):
        return _ndi.zoom(array, factors, order=0)
    return _ndi.zoom(torch.from_numpy(np.asarray(array)), factors, order=0).numpy()


def dice(array1, array2, labels=None, include_zero=False):
    """Hard-label Dice overlap per label, 2 |A & B| / (|A| + |B|), zero-safe;
    by default over the labels of either array but 0."""
    if labels is None:
        labels = np.union1d(np.unique(array1), np.unique(array2))
    labels = np.asarray(labels)
    if not include_zero:
        labels = labels[labels != 0]
    scores = np.zeros(len(labels))
    for i, lab in enumerate(labels):
        in_a = array1 == lab
        in_b = array2 == lab
        denom = np.count_nonzero(in_a) + np.count_nonzero(in_b)
        scores[i] = 2.0 * np.count_nonzero(in_a & in_b) / max(denom, np.finfo(float).eps)
    return scores


def jacobian_determinant(disp):
    """Jacobian determinant of a displacement field ``(*vol_shape, N)``,
    N in (2, 3), in numpy: central differences of ``phi = id + disp``
    (``np.gradient``), ``J[..., i, j] = d phi_i / d x_j``, reduced by
    ``np.linalg.det`` (the convention of ``ops.warp.jacobian_determinant``)."""
    volshape = disp.shape[:-1]
    nd = len(volshape)
    if nd not in (2, 3):
        raise ValueError("flow has to be 2D or 3D")
    grid = np.stack(np.meshgrid(*map(np.arange, volshape), indexing="ij"), axis=-1)
    J = np.stack(np.gradient(grid + disp, axis=tuple(range(nd))), axis=-1)
    return np.linalg.det(J)


def extract_largest_vol(bw, connectivity=1):
    """The largest face-connected component of a binary tensor, as a bool
    tensor (the first of equal largest ones)."""
    lab = _ndi.label_components(bw, connectivity=connectivity)
    counts = torch.bincount(lab.reshape(-1))[1:]
    if counts.numel() == 0:
        raise ValueError("no foreground component found")
    return lab == int(torch.argmax(counts).item()) + 1


def clean_seg(x, std=1):
    """Clean a binary segmentation tensor: keep the largest island, fill its
    holes (the complement of the background's largest component), blur by
    ``std`` and threshold at the value that keeps the filled mask's voxel
    count: the (count + 1)-th largest blurred value. Returns float64."""
    island = extract_largest_vol(x)
    filled = ~extract_largest_vol(~island)
    smooth = _ndi.gaussian_filter(filled, std)
    size = int(filled.sum().item())
    thr = -torch.kthvalue(-smooth.reshape(-1), size + 1).values
    mask = smooth > thr
    if abs(size - int(mask.sum().item())) > 5:
        raise ValueError("cleaning segmentation failed")
    return mask.to(torch.float64)


def clean_seg_batch(X_label, std=1):
    """``clean_seg`` of each element of a batch ``(B, *S, 1)``."""
    return torch.stack([clean_seg(item[..., 0] != 0, std) for item in X_label])[..., None]


def filter_labels(atlas_vol, labels):
    """Zero every voxel of a label tensor whose label is not in ``labels``."""
    keep = torch.isin(atlas_vol, torch.as_tensor(np.asarray(labels), dtype=atlas_vol.dtype,
                                                 device=atlas_vol.device))
    return torch.where(keep, atlas_vol, 0)


def dist_trf(bwvol):
    """The distance of each voxel to the nearest voxel of the island (0 on
    it)."""
    return _ndi.distance_transform_edt(~bwvol.to(torch.bool))


def signed_dist_trf(bwvol):
    """The signed distance to the island's surface: positive outside,
    negative inside."""
    inside = bwvol.to(torch.bool)
    return torch.where(inside, -dist_trf(~inside), dist_trf(inside))


def vol_to_sdt(X_label, sdt=True, sdt_vol_resize=1):
    """The signed distance transform of a binary tensor (float64), resized
    (linear) by ``sdt_vol_resize``; its magnitude unless ``sdt``."""
    dt = signed_dist_trf(X_label)
    factors = (sdt_vol_resize if isinstance(sdt_vol_resize, (list, tuple))
               else [sdt_vol_resize] * dt.dim())
    if any(f != 1 for f in factors):
        dt = _ndi.zoom(dt, factors, order=1)
    return dt if sdt else dt.abs()


def vol_to_sdt_batch(X_label, sdt=True, sdt_vol_resize=1):
    """``vol_to_sdt`` of each element of a batch ``(B, *S, 1)``."""
    if X_label.shape[-1] != 1:
        raise ValueError("expects [batch_size, *vol_shape, 1]")
    return torch.stack([vol_to_sdt(item[..., 0], sdt=sdt, sdt_vol_resize=sdt_vol_resize)
                        for item in X_label])[..., None]


def get_surface_pts_per_label(total_nb_surface_pts, layer_edge_ratios):
    """Split a budget of surface points among labels by their edge ratios
    (numpy); the last label takes the rounding so that the counts sum to the
    budget."""
    counts = np.rint(np.asarray(layer_edge_ratios) * total_nb_surface_pts).astype(int)
    counts[-1] = total_nb_surface_pts - counts[:-1].sum()
    return counts


def edge_to_surface_pts(X_edges, nb_surface_pts=None, rng=None):
    """The coordinates of an edge mask's voxels (int64, row-major order),
    or ``nb_surface_pts`` of them drawn with replacement by ``rng``."""
    coords = torch.nonzero(X_edges)
    if nb_surface_pts is None:
        return coords
    rng = np.random.default_rng() if rng is None else rng
    picks = rng.choice(len(coords), size=nb_surface_pts)
    return coords[torch.from_numpy(picks).to(coords.device)]


def sdt_to_surface_pts(X_sdt, nb_surface_pts, surface_pts_upsample_factor=2, thr=0.50001,
                       resize_fn=None, rng=None):
    """Draw surface points from an SDT tensor: upsample it (linear), take
    the band where |sdt| < ``thr``, draw points there with ``rng`` and map
    them back onto the SDT's grid (endpoint-aligned). Returns float64."""
    if resize_fn is None:
        fine = _ndi.zoom(X_sdt, [surface_pts_upsample_factor] * X_sdt.dim(), order=1)
    else:
        fine = resize_fn(X_sdt)
        want = tuple(np.asarray(X_sdt.shape) * surface_pts_upsample_factor)
        if tuple(fine.shape) != want:
            raise ValueError(f"resizing failed: {tuple(fine.shape)}, not {want}")
    pts = edge_to_surface_pts(fine.abs() < thr, nb_surface_pts=nb_surface_pts, rng=rng)
    scale = (np.asarray(X_sdt.shape) - 1) / (np.asarray(fine.shape) - 1)
    del fine
    return pts * torch.from_numpy(scale).to(pts.device)
