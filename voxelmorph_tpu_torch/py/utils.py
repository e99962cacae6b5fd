"""Host-side numpy utilities that registration needs.

The port's own copies of ``voxelmorph_tpu.py.utils.default_unet_features``,
``read_file_list``, ``read_pair_list``, ``load_volfile``, ``save_volfile``
(for NIfTI (.nii/.nii.gz), .npy and .npz volumes), ``dice`` and
``jacobian_determinant``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from . import io as _io

__all__ = ["default_unet_features", "read_file_list", "read_pair_list", "load_volfile",
           "save_volfile", "dice", "jacobian_determinant"]


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
                 add_feat_axis=False, ret_affine=False):
    """Load a volume from nii, nii.gz, npz, or npy.

    Returns the array, or ``(array, affine)`` when ``ret_affine`` (the affine
    is None for numpy files). ``add_feat_axis`` appends a channel axis and
    ``add_batch_axis`` prepends a batch axis.
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

    if add_feat_axis:
        vol = vol[..., None]
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
