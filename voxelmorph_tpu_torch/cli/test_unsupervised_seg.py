"""Atlas-based Bayesian segmentation of one image, with chunked posteriors.

The PyTorch counterpart of ``scripts/test_unsupervised_seg.py``, with its
flags:

    python -m voxelmorph_tpu_torch.cli.test_unsupervised_seg image.nii.gz \\
        seg.nii.gz --model model.npz --atlas prob_atlas.npz --mapping map.npy

A ``ProbAtlasSegmentation`` checkpoint predicts each tissue class's
log-likelihood and the warp; the posterior of every label of the full atlas
(``--atlas-full``, default ``--atlas``) is the warped atlas label times the
likelihood of its class (``--mapping``, one class a label), computed
``--max-feats`` labels at a time, and the segmentation is its argmax. The
atlas warp of a chunk takes the tiered warp's kernels for up to 4 labels
and the wide gather for more. It runs on the GPU unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('image', help='volume to segment')
    parser.add_argument('seg', help='where to write the predicted segmentation')
    parser.add_argument('--model', required=True, help='model file')
    parser.add_argument('--atlas', required=True, help='probabilistic atlas volume (npz)')
    parser.add_argument('--atlas-full', help='full atlas npz file (defaults to --atlas)')
    parser.add_argument('--mapping', required=True, help='atlas mapping filename (npz/npy)')
    parser.add_argument('--gpu', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--max-feats', type=int, default=21,
                        help='max label channels warped at once')
    parser.add_argument('--warped-atlas', help='where to write the warped atlas volume')
    parser.add_argument('--posteriors', help='where to write the label posterior volume')
    parser.add_argument('--warp', help='where to write the dense displacement field')
    parser.add_argument('--stats', help='where to write the estimated Gaussian stats (npz)')
    return parser.parse_args(argv)


def main(argv=None):
    """Segment and write the outputs; returns the segmentation."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.modelio import load_model
    from ..ops import warp as warp_ops
    from ..py.utils import load_volfile, save_volfile

    device = resolve_device(args.device)

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    atlas = load_volfile(args.atlas, np_var='vol', add_batch_axis=True)
    atlas_full = load_volfile(args.atlas_full or args.atlas, np_var='vol', add_batch_axis=True)
    mapping = load_volfile(args.mapping).astype(int).reshape(-1)
    image, affine = load_volfile(args.image, add_batch_axis=True, add_feat_axis=True,
                                 ret_affine=True)

    model = load_model(args.model, device=device)
    with torch.no_grad():
        out = model(on_device(image), on_device(atlas))
        ull_pred = out['uloglhood'][0]
        flow = out['flow'][0]
        full = on_device(atlas_full[0])
        index = torch.as_tensor(mapping, device=device)
        posteriors, warped_atlas = [], []
        total_labels = full.shape[-1]
        for i in range(0, total_labels, args.max_feats):
            slc = slice(i, min(i + args.max_feats, total_labels))
            warped = warp_ops.transform(full[..., slc], flow, interp_method='linear')
            posteriors.append(torch.exp(ull_pred[..., index[slc]]) * warped)
            warped_atlas.append(warped)
        posteriors = torch.cat(posteriors, -1)
        segmentation = posteriors.argmax(-1).to(torch.int32).cpu().numpy()

    save_volfile(segmentation, args.seg, affine)
    if args.warped_atlas:
        save_volfile(torch.cat(warped_atlas, -1).cpu().numpy(), args.warped_atlas, affine)
    if args.posteriors:
        normalized = posteriors / (1e-12 + torch.sum(posteriors, -1, keepdim=True))
        save_volfile(normalized.cpu().numpy(), args.posteriors, affine)
    if args.warp:
        save_volfile(flow.cpu().numpy(), args.warp, affine)
    if args.stats:
        np.savez_compressed(args.stats, means=out['stat_mu'][0].cpu().numpy(),
                            log_variances=out['stat_logssq'][0].cpu().numpy())
    return segmentation


if __name__ == '__main__':
    main()
