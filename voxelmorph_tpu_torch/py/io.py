"""NIfTI-1 and FreeSurfer MGH volume IO in pure numpy.

The port's own copy of ``voxelmorph_tpu.py.io``: ``read_nifti`` /
``write_nifti`` (single-file NIfTI-1 images with sform (or qform) affines,
.nii/.nii.gz) and ``read_mgh`` / ``write_mgh`` (MGH version 1, .mgh/.mgz).
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["read_nifti", "write_nifti", "read_mgh", "write_mgh"]

# NIfTI-1 datatype codes <-> numpy dtypes
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}

# MGH data type codes <-> numpy dtypes
_MGH_UCHAR, _MGH_INT, _MGH_FLOAT, _MGH_SHORT = 0, 1, 3, 4
_MGH_DTYPES = {_MGH_UCHAR: np.uint8, _MGH_INT: np.int32,
               _MGH_FLOAT: np.float32, _MGH_SHORT: np.int16}
_MGH_CODES = {np.dtype(v): k for k, v in _MGH_DTYPES.items()}


def _open_maybe_gz(filename: str, mode: str):
    if filename.endswith((".gz", ".mgz")):
        return gzip.open(filename, mode)
    return open(filename, mode)


def read_nifti(filename: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a NIfTI-1 volume. Returns (data, affine)."""
    with _open_maybe_gz(filename, "rb") as f:
        hdr = f.read(352)
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        endian = "<"
        if sizeof_hdr != 348:
            endian = ">"
            sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{filename}: not a NIfTI-1 file")
        dim = struct.unpack_from(endian + "8h", hdr, 40)
        ndim = dim[0]
        shape = dim[1:1 + ndim]
        datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
        if datatype not in _NIFTI_DTYPES:
            raise ValueError(f"{filename}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)
        vox_offset = struct.unpack_from(endian + "f", hdr, 108)[0]
        scl_slope = struct.unpack_from(endian + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(endian + "f", hdr, 116)[0]
        sform_code = struct.unpack_from(endian + "h", hdr, 254)[0]
        qform_code = struct.unpack_from(endian + "h", hdr, 252)[0]
        srow = struct.unpack_from(endian + "12f", hdr, 280)

        offset = int(vox_offset) if vox_offset else 352
        skip = offset - 352
        if skip > 0:
            f.read(skip)
        data = np.frombuffer(f.read(), dtype=dtype)

    count = int(np.prod(shape))
    data = data[:count].reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data * slope + scl_inter

    affine = None
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    if sform_code > 0:
        affine = np.eye(4)
        affine[:3] = np.asarray(srow).reshape(3, 4)
    elif qform_code > 0:
        # quaternion-encoded qform (common output of tools that never set the
        # sform): a = sqrt(1 - b^2 - c^2 - d^2), voxel sizes from pixdim,
        # qfac = pixdim[0] flips the third column's handedness.
        b, c, d = struct.unpack_from(endian + "3f", hdr, 256)
        qoffset = struct.unpack_from(endian + "3f", hdr, 268)
        a_sq = max(0.0, 1.0 - (b * b + c * c + d * d))
        a = np.sqrt(a_sq)
        R = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        zooms = np.array([pixdim[1], pixdim[2], qfac * pixdim[3]])
        affine = np.eye(4)
        affine[:3, :3] = R * zooms
        affine[:3, 3] = qoffset
    else:
        # fall back to pixdim scaling
        affine = np.diag([*pixdim[1:4], 1.0])
    return np.asarray(data), affine


def write_nifti(filename: str, array: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a NIfTI-1 single file (.nii or .nii.gz) with an sform affine."""
    array = np.asarray(array)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    if array.dtype not in _NIFTI_CODES:
        array = array.astype(np.float32)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float64)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = array.ndim
    dim = [ndim] + list(array.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[array.dtype])
    struct.pack_into("<h", hdr, 72, array.dtype.itemsize * 8)  # bitpix
    # pixdim from affine column norms
    pixdim = [1.0] + [float(np.linalg.norm(affine[:3, i])) for i in range(3)] + [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<12f", hdr, 280, *affine[:3].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    with _open_maybe_gz(filename, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(array).tobytes(order="F"))


def read_mgh(filename: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a FreeSurfer MGH/MGZ volume. Returns (data, affine)."""
    with _open_maybe_gz(filename, "rb") as f:
        hdr = f.read(284)
        version, w, h, d, nframes, mtype, _dof = struct.unpack_from(">7i", hdr, 0)
        if version != 1:
            raise ValueError(f"{filename}: unsupported MGH version {version}")
        if mtype not in _MGH_DTYPES:
            raise ValueError(f"{filename}: unsupported MGH type {mtype}")
        good_ras = struct.unpack_from(">h", hdr, 28)[0]
        affine = None
        if good_ras > 0:
            spacing = struct.unpack_from(">3f", hdr, 30)
            mdc = np.asarray(struct.unpack_from(">9f", hdr, 42)).reshape(3, 3).T
            pxyz_c = np.asarray(struct.unpack_from(">3f", hdr, 78))
            shape3 = np.asarray([w, h, d], dtype=np.float64)
            mdcs = mdc * np.asarray(spacing)
            affine = np.eye(4)
            affine[:3, :3] = mdcs
            affine[:3, 3] = pxyz_c - mdcs @ (shape3 / 2)
        dtype = np.dtype(_MGH_DTYPES[mtype]).newbyteorder(">")
        data = np.frombuffer(f.read(), dtype=dtype)

    shape = (w, h, d) if nframes <= 1 else (w, h, d, nframes)
    count = int(np.prod(shape))
    return np.asarray(data[:count].reshape(shape, order="F")), affine


def write_mgh(filename: str, array: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a FreeSurfer MGH/MGZ volume."""
    array = np.asarray(array)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    if array.dtype not in _MGH_CODES:
        array = array.astype(np.float32)
    if array.ndim == 3:
        shape3, nframes = array.shape, 1
    elif array.ndim == 4:
        shape3, nframes = array.shape[:3], array.shape[3]
    else:
        raise ValueError("MGH arrays must be 3-D or 4-D")

    hdr = bytearray(284)
    struct.pack_into(">7i", hdr, 0, 1, *shape3, nframes, _MGH_CODES[array.dtype], 0)
    if affine is not None:
        affine = np.asarray(affine, dtype=np.float64)
        struct.pack_into(">h", hdr, 28, 1)  # goodRASFlag
        spacing = [float(np.linalg.norm(affine[:3, i])) for i in range(3)]
        mdc = affine[:3, :3] / np.asarray(spacing)
        struct.pack_into(">3f", hdr, 30, *spacing)
        struct.pack_into(">9f", hdr, 42, *mdc.T.reshape(-1))
        center = affine[:3, :3] @ (np.asarray(shape3, np.float64) / 2) + affine[:3, 3]
        struct.pack_into(">3f", hdr, 78, *center)

    with _open_maybe_gz(filename, "wb") as f:
        f.write(bytes(hdr))
        f.write(array.astype(array.dtype.newbyteorder(">")).tobytes(order="F"))
