"""Host-side data generators for the training loop.

The port's own copy of the generators of ``voxelmorph_tpu/generators.py``
(``volgen``, ``scan_to_scan``, ``scan_to_atlas``, ``semisupervised``), in
numpy, with the same ``(inputs, outputs)`` tuple contracts. Each takes an explicit
``np.random.Generator`` (``rng``; a fresh unseeded one by default) instead of
a module-level random state.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .py.utils import load_volfile

__all__ = ["volgen", "scan_to_scan", "scan_to_atlas", "semisupervised"]


def _expand_names(vol_names):
    """A directory, a glob pattern or a list of items, as a list."""
    if isinstance(vol_names, str):
        pattern = os.path.join(vol_names, "*") if os.path.isdir(vol_names) else vol_names
        return glob.glob(pattern)
    return list(vol_names)


def _stack_load(names, picks, **load_kwargs):
    """Load the picked entries of ``names`` and stack them on the batch axis."""
    return np.concatenate([load_volfile(names[i], add_batch_axis=True, **load_kwargs)
                           for i in picks], axis=0)


def volgen(vol_names, batch_size=1, segs=None, np_var="vol", add_feat_axis=True, rng=None):
    """Random volumes (drawn with replacement), stacked on the batch axis:
    yields ``(vols,)`` of shape ``(batch_size, *S[, 1])``, or ``(vols, segs)``
    where ``segs`` is True (the 'seg' variable of the same files) or a list of
    seg files, one for each volume file."""
    names = _expand_names(vol_names)
    if isinstance(segs, list) and len(segs) != len(names):
        raise ValueError("Number of image files must match number of seg files.")
    rng = np.random.default_rng() if rng is None else rng
    while True:
        picks = rng.integers(len(names), size=batch_size)
        batch = [_stack_load(names, picks, np_var=np_var, add_feat_axis=add_feat_axis)]
        if segs is True:
            batch.append(_stack_load(names, picks, np_var="seg", add_feat_axis=add_feat_axis))
        elif isinstance(segs, list):
            batch.append(_stack_load(segs, picks, np_var=np_var, add_feat_axis=add_feat_axis))
        yield tuple(batch)


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


def _one_hot_seg(seg, labels, downsize=1):
    """The one-hot float32 map of an integer seg ``(B, *S, 1)`` over
    ``labels``, ``(B, *S, L)``, strided down by ``downsize`` on every
    spatial axis."""
    onehot = (seg[..., 0, None] == np.asarray(labels)).astype("float32")
    if downsize > 1:
        nd = onehot.ndim - 2
        onehot = onehot[(slice(None),) + (slice(None, None, downsize),) * nd]
    return onehot


def semisupervised(vol_names, seg_names, labels, atlas_file=None, downsize=2, rng=None):
    """Semi-supervised training pairs with one-hot segmentations at
    1/``downsize`` resolution: inputs [src, trg, src_seg], outputs [trg,
    zero flow, trg_seg]. With ``atlas_file`` (an npz with 'vol' and 'seg')
    every target is the atlas. Identical lists of volume and seg paths mean
    npz files that carry both 'vol' and 'seg'; other files raise."""
    def is_paths(v):
        return isinstance(v, list) and all(isinstance(x, (str, os.PathLike)) for x in v)

    if is_paths(seg_names) and is_paths(vol_names) and list(seg_names) == list(vol_names):
        if not all(str(x).endswith(".npz") for x in vol_names):
            raise ValueError(
                "identical vol/seg path lists require .npz files with "
                "'vol' + 'seg' variables; pass distinct seg paths otherwise")
        seg_names = True
    gen = volgen(vol_names, segs=seg_names, np_var="vol", rng=rng)
    flow = None

    trg_vol = trg_seg = None
    if atlas_file:
        trg_vol = load_volfile(atlas_file, np_var="vol", add_batch_axis=True, add_feat_axis=True)
        trg_seg = _one_hot_seg(load_volfile(atlas_file, np_var="seg", add_batch_axis=True,
                                            add_feat_axis=True), labels, downsize)
    while True:
        src_vol, src_seg = next(gen)
        src_seg = _one_hot_seg(src_seg, labels, downsize)
        if not atlas_file:
            trg_vol, raw = next(gen)
            trg_seg = _one_hot_seg(raw, labels, downsize)
        if flow is None:
            flow = _zero_flow(1, src_vol.shape[1:-1])
        yield ([src_vol, trg_vol, src_seg], [trg_vol, flow, trg_seg])
