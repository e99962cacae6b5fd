"""Shared helpers of the tests that hold the PyTorch port to the JAX package.

Inputs are made with numpy from seeds and handed to both packages. Every
comparison asserts that what it compares is at least ten times its
tolerance, so that a zero, detached or sign-flipped result cannot pass.
"""

import numpy as np


def bounded_case(seed, shape, nch, halo, batch=None):
    """Volume and shifts within +-halo, with two-voxel border bands pushed
    across the volume's edges so that clamping binds: in each band the
    coordinate ``x + shift`` lands beyond the edge or exactly on it."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    vol = rng.normal(size=(*lead, *shape, nch)).astype(np.float32)
    shift = rng.uniform(-halo, halo, size=(*lead, *shape, 3)).astype(np.float32)
    for axis in range(3):
        lo = [slice(None)] * shift.ndim
        hi = [slice(None)] * shift.ndim
        lo[len(lead) + axis] = slice(0, 2)
        hi[len(lead) + axis] = slice(-2, None)
        lo[-1] = hi[-1] = axis
        shift[tuple(lo)] = -halo
        shift[tuple(hi)] = halo
    return vol, shift


def flatten(tree, prefix=""):
    """A nested dict of arrays as ``a||b||leaf`` keys (the checkpoint keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "||"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat):
    """The inverse of ``flatten``: ``a||b||leaf`` keys as a nested dict."""
    nested = {}
    for key, val in flat.items():
        *path, leaf = key.split("||")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return nested


def assert_close(actual, expected, atol, err_msg=""):
    """``actual`` within ``atol`` of ``expected``, whose largest magnitude
    must be at least ten times ``atol``."""
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    scale = np.abs(expected).max()
    assert scale >= 10 * atol, f"{err_msg}: max |expected| {scale} is under 10 x {atol}"
    np.testing.assert_allclose(actual, expected, rtol=0, atol=atol, err_msg=err_msg)


def assert_rel_close(actual, expected, rtol, err_msg=""):
    """``actual`` within ``rtol`` times the largest magnitude of ``expected``."""
    scale = np.abs(np.asarray(expected, dtype=np.float64)).max()
    assert rtol <= 0.1 and scale > 0, (err_msg, rtol, scale)
    assert_close(actual, expected, rtol * scale, err_msg)
