"""Data generators for the training loop.

The port's own copy of the generators of ``voxelmorph_tpu/generators.py``
(``volgen``, ``scan_to_scan``, ``scan_to_atlas``, ``semisupervised``,
``template_creation``, ``conditional_template_creation``,
``surf_semisupervised``, ``synthmorph``), with the same ``(inputs,
outputs)`` tuple contracts. Each takes an explicit ``np.random.Generator``
(``rng``; by default the module's own, which ``seed_rng`` seeds, as in the
JAX package) and draws from it in the JAX package's order. The first four yield numpy arrays;
``surf_semisupervised`` computes its distance transforms and point clouds
with torch on its ``device`` (``py.ndimage``) and yields tensors there.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .py import utils as py_utils
from .py.utils import load_volfile

__all__ = ["seed_rng", "volgen", "scan_to_scan", "scan_to_atlas", "semisupervised",
           "template_creation", "conditional_template_creation", "surf_semisupervised",
           "synthmorph"]

# the stream of every generator given no rng, the JAX module's ``_rng``
_rng = np.random.default_rng()


def seed_rng(seed):
    """Seed the module's generator (for reproducible data streams); every
    generator given no ``rng`` draws from it, those already running too."""
    global _rng
    _rng = np.random.default_rng(seed)


class _ModuleRng:
    """The module's generator as ``seed_rng`` last set it, looked up at
    each draw."""

    def __getattr__(self, name):
        return getattr(_rng, name)


_MODULE_RNG = _ModuleRng()


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


def volgen(vol_names, batch_size=1, segs=None, np_var="vol", pad_shape=None, resize_factor=1,
           add_feat_axis=True, rng=None):
    """Random volumes (drawn with replacement), stacked on the batch axis:
    yields ``(vols,)`` of shape ``(batch_size, *S[, 1])``, or ``(vols, segs)``
    where ``segs`` is True (the 'seg' variable of the same files) or a list of
    seg files, one for each volume file. ``pad_shape`` and ``resize_factor``
    pad and resize each loaded volume as ``load_volfile`` does."""
    names = _expand_names(vol_names)
    if isinstance(segs, list) and len(segs) != len(names):
        raise ValueError("Number of image files must match number of seg files.")
    rng = _MODULE_RNG if rng is None else rng
    opts = dict(np_var=np_var, pad_shape=pad_shape, resize_factor=resize_factor,
                add_feat_axis=add_feat_axis)
    while True:
        picks = rng.integers(len(names), size=batch_size)
        batch = [_stack_load(names, picks, **opts)]
        if segs is True:
            batch.append(_stack_load(names, picks, **{**opts, "np_var": "seg"}))
        elif isinstance(segs, list):
            batch.append(_stack_load(segs, picks, **opts))
        yield tuple(batch)


def _zero_flow(batch_size, spatial_shape):
    """The zero-displacement placeholder target of the regularization loss."""
    return np.zeros((batch_size, *spatial_shape, len(spatial_shape)), "float32")


def scan_to_scan(vol_names, bidir=False, batch_size=1, prob_same=0, no_warp=False,
                 rng=None, **kwargs):
    """Random scan pairs: inputs [src, trg], outputs [trg(, src)](, zero flow).
    With ``prob_same`` one side is sometimes copied to the other."""
    rng = _MODULE_RNG if rng is None else rng
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
                  segs=None, rng=None, **kwargs):
    """Random scans registered to a fixed atlas ``(1, *S, C)``: inputs
    [scan, atlas], outputs [atlas(, scan)](, zero flow). With ``segs`` (as
    ``volgen`` takes it) the first output is the scan's segmentation
    instead of the atlas."""
    flow = _zero_flow(batch_size, atlas.shape[1:-1])
    atlas = np.repeat(atlas, batch_size, axis=0)
    gen = volgen(vol_names, batch_size=batch_size, segs=segs, rng=rng, **kwargs)
    while True:
        loaded = next(gen)
        scan = loaded[0]
        first = loaded[1] if segs else atlas
        outputs = [first, scan] if bidir else [first]
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


def template_creation(vol_names, bidir=False, batch_size=1, rng=None, **kwargs):
    """Unconditional template creation: inputs [scans], outputs [scans] and
    two zero flows (three with ``bidir``), each of batch 1 as in the JAX
    package."""
    gen = volgen(vol_names, batch_size=batch_size, rng=rng, **kwargs)
    flow = None
    while True:
        scan = next(gen)[0]
        if flow is None:
            flow = _zero_flow(1, scan.shape[1:-1])
        yield ([scan], [scan] + [flow] * (3 if bidir else 2))


def conditional_template_creation(vol_names, atlas, attributes, batch_size=1, np_var="vol",
                                  pad_shape=None, add_feat_axis=True, rng=None):
    """Conditional template creation: inputs [phenotypes, atlas, scans],
    outputs [scans] and three zero flows. ``attributes`` maps each name of
    ``vol_names`` to its phenotype vector (``py.utils.load_pheno_csv``);
    ``atlas`` ``(1, *S, C)`` is repeated over the batch."""
    rng = _MODULE_RNG if rng is None else rng
    flow = _zero_flow(batch_size, atlas.shape[1:-1])
    atlas = np.repeat(atlas, batch_size, axis=0)
    names = list(vol_names)
    opts = dict(np_var=np_var, add_feat_axis=add_feat_axis, pad_shape=pad_shape)
    while True:
        picks = rng.integers(len(names), size=batch_size)
        pheno = np.stack([attributes[names[i]] for i in picks], axis=0)
        scans = _stack_load(names, picks, **opts)
        yield ([pheno, atlas, scans], [scans, flow, flow, flow])


class _SurfaceSampler:
    """The per-label signed distance transforms and surface point draws of
    ``surf_semisupervised``, on the atlas's device.

    It cleans each atlas label's mask, computes its SDT and its share of the
    point budget (its boundary's voxel count over all labels'); per step it
    cleans a subject's labels, computes their SDTs and draws point clouds
    from either side with ``rng``.
    """

    def __init__(self, atlas_seg, labels, total_pts, smooth_std, upsample, resize, rng):
        self.labels = labels
        self.total_pts = total_pts
        self.smooth_std = smooth_std
        self.upsample = upsample
        self.resize = resize
        self.rng = rng
        self.threshold = 1.0 / upsample + 1e-5
        self.atlas_sdts = []
        boundary_sizes = []
        for label in labels:
            mask = py_utils.clean_seg(atlas_seg == int(label), smooth_std)
            sdt = py_utils.vol_to_sdt(mask, sdt=True, sdt_vol_resize=resize)
            self.atlas_sdts.append(sdt)
            boundary_sizes.append(int(torch.count_nonzero(sdt.abs() < 1.01).item()))
        self.edge_ratios = np.asarray(boundary_sizes, float) / sum(boundary_sizes)

    def budget(self, label_idxs):
        """Surface-point counts of the chosen labels, summing to total_pts."""
        return py_utils.get_surface_pts_per_label(
            self.total_pts, self.edge_ratios[np.asarray(label_idxs)])

    def point_cloud(self, sdts, counts):
        """A ``(total_pts, ndims + 1)`` float32 cloud: each label's points,
        then the label's slot in the stacked SDTs (the channel that
        ``value_at_location`` samples at the warped points)."""
        nd = sdts[0].dim()
        cloud = torch.zeros((self.total_pts, nd + 1), dtype=torch.float32,
                            device=sdts[0].device)
        stops = np.concatenate([[0], np.cumsum(counts)]).astype(int)
        for slot, sdt in enumerate(sdts):
            rows = slice(stops[slot], stops[slot + 1])
            cloud[rows, :-1] = py_utils.sdt_to_surface_pts(
                sdt, counts[slot], surface_pts_upsample_factor=self.upsample,
                thr=self.threshold, rng=self.rng).to(torch.float32)
            cloud[rows, -1] = slot
        return cloud

    def subject_sdts(self, seg, label_idxs):
        """The cleaned SDTs of a subject's labels ``label_idxs`` (``seg`` of
        shape ``S``)."""
        return [py_utils.vol_to_sdt(py_utils.clean_seg(seg == int(self.labels[li]),
                                                       self.smooth_std),
                                    sdt=True, sdt_vol_resize=self.resize)
                for li in label_idxs]


def surf_semisupervised(vol_names, atlas_vol, atlas_seg, nb_surface_pts, labels=None,
                        batch_size=1, surf_bidir=True, surface_pts_upsample_factor=2,
                        smooth_seg_std=1, nb_labels_sample=None, sdt_vol_resize=1,
                        align_segs=False, add_feat_axis=True, device="cuda", rng=None):
    """Scan-to-atlas training with surface point clouds.

    Per step, a random scan (``vol_names``, npz files with 'vol' and 'seg')
    against the atlas (``atlas_vol`` and ``atlas_seg``, arrays of shape
    ``S``), with the SDTs of ``nb_labels_sample`` labels (all of them by
    default; else drawn without replacement) of the scan, and point clouds
    of ``nb_surface_pts`` surface points of the atlas's labels (drawn once
    when every label is used) and, with ``surf_bidir``, of the scan's.
    Yields float32 tensors on ``device``: inputs [moving, fixed, subject
    SDTs, atlas SDTs, subject cloud, atlas cloud] and outputs [fixed,
    moving, zero flow, zero values, zero values]; without ``surf_bidir``
    inputs [moving, fixed, subject SDTs, atlas cloud] and outputs [fixed,
    moving, zero flow, zero values]. The masks, SDTs and clouds are computed
    on ``device``; ``rng`` draws the scans, the labels and the points in the
    JAX package's order.
    """
    if nb_surface_pts <= 0:
        raise ValueError("number of surface points must be positive")
    if batch_size != 1:
        raise ValueError("only batch size 1 supported for now")
    rng = _MODULE_RNG if rng is None else rng
    atlas_seg = torch.as_tensor(np.asarray(atlas_seg), device=device)
    if labels is not None:
        atlas_seg = py_utils.filter_labels(atlas_seg, labels)
    else:
        labels = np.sort(np.unique(atlas_seg.cpu().numpy()))[1:]
    nb_sample = nb_labels_sample or len(labels)
    use_all = nb_sample == len(labels)

    sampler = _SurfaceSampler(atlas_seg, labels, nb_surface_pts, smooth_seg_std,
                              surface_pts_upsample_factor, sdt_vol_resize, rng)

    def to_dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    vol_shape = tuple(atlas_seg.shape)
    sdt_shape = tuple(int(s * sdt_vol_resize) for s in vol_shape)
    atlas_img_b = to_dev(atlas_vol)[None, ..., None]
    atlas_seg_b = atlas_seg[None, ..., None]
    flow = to_dev(_zero_flow(batch_size, vol_shape))
    zero_pt_values = torch.zeros((batch_size, nb_surface_pts, 1), device=device)

    # with the full label set, the atlas's point cloud is drawn once
    fixed_atlas_cloud = None
    if use_all:
        fixed_atlas_cloud = sampler.point_cloud(sampler.atlas_sdts,
                                                sampler.budget(range(len(labels))))

    gen = volgen(vol_names, segs=True, batch_size=batch_size, add_feat_axis=add_feat_axis,
                 rng=rng)
    while True:
        img, seg = next(gen)
        img = to_dev(img)
        seg = py_utils.filter_labels(torch.as_tensor(seg, device=device), labels)
        if use_all:
            label_idxs = list(range(len(labels)))
            counts = sampler.budget(label_idxs)
            atlas_cloud = fixed_atlas_cloud
        else:
            label_idxs = np.sort(rng.choice(len(labels), size=nb_sample, replace=False))
            counts = sampler.budget(label_idxs)
            atlas_cloud = sampler.point_cloud([sampler.atlas_sdts[li] for li in label_idxs],
                                              counts)

        subj_sdts = sampler.subject_sdts(seg[0, ..., 0], label_idxs)
        subj_sdt_stack = torch.stack(subj_sdts, dim=-1)[None].to(torch.float32)
        if tuple(subj_sdt_stack.shape) != (batch_size, *sdt_shape, nb_sample):
            raise ValueError(f"subject SDTs of shape {tuple(subj_sdt_stack.shape)}")

        if align_segs:
            if len(labels) != 1:
                raise ValueError("align_segs supports a single label only")
            moving = (seg == int(labels[0])).to(torch.float32)
            fixed = (atlas_seg_b == int(labels[0])).to(torch.float32)
        else:
            moving, fixed = img, atlas_img_b

        atlas_cloud_b = atlas_cloud[None].expand(batch_size, -1, -1)
        if surf_bidir:
            atlas_sdt_stack = torch.stack([sampler.atlas_sdts[li] for li in label_idxs],
                                          dim=-1)[None].to(torch.float32)
            subj_cloud_b = sampler.point_cloud(subj_sdts, counts)[None]
            inputs = [moving, fixed, subj_sdt_stack, atlas_sdt_stack, subj_cloud_b,
                      atlas_cloud_b]
            outputs = [fixed, moving, flow, zero_pt_values, zero_pt_values]
        else:
            inputs = [moving, fixed, subj_sdt_stack, atlas_cloud_b]
            outputs = [fixed, moving, flow, zero_pt_values]
        del subj_sdts
        yield inputs, outputs


def synthmorph(label_maps, batch_size=1, same_subj=False, flip=True, rng=None):
    """SynthMorph's label-map pairs: yields ``[src, trg]``, each
    ``(batch_size, *S, 1)`` integer maps picked with replacement (with
    ``same_subj`` the targets are the sources), the pair flipped along a
    random set of axes with ``flip``, and two zero flows as the void
    outputs (the losses compare the synthesized tensors). Draws from
    ``rng``, else the module's generator, in the JAX package's order."""
    rng = _MODULE_RNG if rng is None else rng
    spatial = label_maps[0].shape
    nd = len(spatial)
    void = np.zeros((batch_size, *spatial, nd), "float32")
    while True:
        picks = rng.integers(len(label_maps), size=2 * batch_size)
        if same_subj:
            picks[batch_size:] = picks[:batch_size]
        pair = np.stack([label_maps[i] for i in picks])[..., None]
        if flip:
            nb_axes = rng.integers(nd + 1)
            axes = rng.choice(nd, size=nb_axes, replace=False, shuffle=False)
            pair = np.flip(pair, axis=tuple(axes + 1))
        yield [pair[:batch_size], pair[batch_size:]], [void] * 2
