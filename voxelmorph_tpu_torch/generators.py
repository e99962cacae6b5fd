"""Host-side data generators for the training loop.

The port's own copy of the pair generators of ``voxelmorph_tpu/generators.py``
(``volgen``, ``scan_to_scan``, ``scan_to_atlas``), in numpy, with the same
``(inputs, outputs)`` tuple contracts. Each takes an explicit
``np.random.Generator`` (``rng``; a fresh unseeded one by default) instead of
a module-level random state.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .py.utils import load_volfile

__all__ = ["volgen", "scan_to_scan", "scan_to_atlas"]


def _expand_names(vol_names):
    """A directory, a glob pattern or a list of items, as a list."""
    if isinstance(vol_names, str):
        pattern = os.path.join(vol_names, "*") if os.path.isdir(vol_names) else vol_names
        return glob.glob(pattern)
    return list(vol_names)


def volgen(vol_names, batch_size=1, np_var="vol", add_feat_axis=True, rng=None):
    """Random volumes (drawn with replacement), stacked on the batch axis:
    yields a 1-tuple ``(vols,)`` of shape ``(batch_size, *S[, 1])``."""
    names = _expand_names(vol_names)
    rng = np.random.default_rng() if rng is None else rng
    while True:
        picks = rng.integers(len(names), size=batch_size)
        yield (np.concatenate([load_volfile(names[i], np_var=np_var, add_batch_axis=True,
                                            add_feat_axis=add_feat_axis)
                               for i in picks], axis=0),)


def _zero_flow(batch_size, spatial_shape):
    """The zero-displacement placeholder target of the regularization loss."""
    return np.zeros((batch_size, *spatial_shape, len(spatial_shape)), "float32")


def scan_to_scan(vol_names, bidir=False, batch_size=1, prob_same=0, no_warp=False,
                 rng=None, **kwargs):
    """Random scan pairs: inputs [src, trg], outputs [trg(, src)](, zero flow).
    With ``prob_same`` one side is sometimes copied to the other."""
    rng = np.random.default_rng() if rng is None else rng
    gen = volgen(vol_names, batch_size=batch_size, rng=rng, **kwargs)
    flow = None
    while True:
        moving = next(gen)[0]
        fixed = next(gen)[0]
        if prob_same > 0 and rng.random() < prob_same:
            if rng.random() > 0.5:
                moving = fixed
            else:
                fixed = moving
        outputs = [fixed, moving] if bidir else [fixed]
        if not no_warp:
            if flow is None:
                flow = _zero_flow(batch_size, moving.shape[1:-1])
            outputs = outputs + [flow]
        yield ([moving, fixed], outputs)


def scan_to_atlas(vol_names, atlas, bidir=False, batch_size=1, no_warp=False,
                  rng=None, **kwargs):
    """Random scans registered to a fixed atlas ``(1, *S, C)``: inputs
    [scan, atlas], outputs [atlas(, scan)](, zero flow)."""
    flow = _zero_flow(batch_size, atlas.shape[1:-1])
    atlas = np.repeat(atlas, batch_size, axis=0)
    gen = volgen(vol_names, batch_size=batch_size, rng=rng, **kwargs)
    while True:
        scan = next(gen)[0]
        outputs = [atlas, scan] if bidir else [atlas]
        if not no_warp:
            outputs = outputs + [flow]
        yield ([scan, atlas], outputs)
