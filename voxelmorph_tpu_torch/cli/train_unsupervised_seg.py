"""Train atlas-based Bayesian segmentation (``ProbAtlasSegmentation``).

The PyTorch counterpart of ``scripts/train_unsupervised_seg.py``, with its
flags:

    python -m voxelmorph_tpu_torch.cli.train_unsupervised_seg \\
        --img-list list.txt --atlas prob_atlas.npz --model-dir models

The data loss is the negative mean of the log-marginal 'loss volume' over
the image's nonzero voxels (a weight computed from the input scan), plus
Grad-l2 on the warp. The statistics are estimated after the atlas warp
unless ``--stat-pre-warp``. It runs on the GPU unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--img-list', required=True, help='text file with one training volume path per line')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--atlas', required=True, help='probabilistic atlas npz (vol)')
    parser.add_argument('--mapping', help='npz mapping full labels to tissue classes')
    parser.add_argument('--model-dir', default='models', help='directory for checkpoints and logs')
    parser.add_argument('--gpu', default='0', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--epochs', type=int, default=1500)
    parser.add_argument('--steps-per-epoch', type=int, default=100)
    parser.add_argument('--load-weights', help="checkpoint to start from; 'latest' resumes from model-dir")
    parser.add_argument('--initial-epoch', type=int, default=0)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='U-Net compute dtype (params, losses and flow integration stay float32)')
    parser.add_argument('--enc', type=int, nargs='+')
    parser.add_argument('--dec', type=int, nargs='+')
    parser.add_argument('--no-warp-atlas', action='store_true')
    parser.add_argument('--stat-pre-warp', action='store_true')
    parser.add_argument('--init-stat', help='npz with init_mu / init_sigma')
    parser.add_argument('--grad-loss-weight', type=float, default=10.0)
    return parser.parse_args(argv)


def neg_masked_mean_weight(inputs, out):
    """The weight of the data term: ``mean(w * l)`` is minus the mean of
    ``l`` over the scan's nonzero voxels (the scan is ``inputs[0]``)."""
    import torch

    m = (inputs[0] > 0).to(torch.float32)
    return -m / torch.clamp(torch.mean(m), min=1e-8)


def unsupervised_seg_terms(grad_loss_weight=10.0, warp_atlas=True):
    """The loss terms against the generator's targets [atlas, zero flow]."""
    import torch

    from .. import losses
    from ..training import LossTerm

    return [
        LossTerm('loss_vol', lambda _, yp: torch.mean(yp, dim=-1, keepdim=True),
                 weight=neg_masked_mean_weight, target_index=0, name='nll'),
        LossTerm('flow', losses.Grad('l2', loss_mult=2).loss,
                 weight=grad_loss_weight if warp_atlas else 0.0, target_index=1, name='grad'),
    ]


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import generators, resolve_device
    from ..models.atlas import ProbAtlasSegmentation
    from ..py.utils import load_volfile, read_file_list
    from ..training import Trainer, init_or_resume, resolve_dtype

    device = resolve_device(args.device)
    # the probabilistic atlas, (1, *S, nb_labels)
    atlas = load_volfile(args.atlas, np_var='vol', add_batch_axis=True)
    if atlas.ndim == 4 and atlas.shape[-1] == 1:
        atlas = atlas[..., np.newaxis]
    nb_labels = atlas.shape[-1]
    inshape = atlas.shape[1:-1]
    init_mu = np.load(args.init_stat)['init_mu'] if args.init_stat else None
    init_sigma = np.load(args.init_stat)['init_sigma'] if args.init_stat else None

    train_files = read_file_list(args.img_list, prefix=args.img_prefix, suffix=args.img_suffix)
    if not train_files:
        raise ValueError('Could not find any training data.')
    # inputs [scan, atlas]: the model's (image, atlas)
    generator = generators.scan_to_atlas(train_files, atlas, batch_size=args.batch_size)
    next(generator)  # the JAX script draws one batch before training, for its shapes

    enc_nf = args.enc if args.enc else [16, 32, 32, 32]
    dec_nf = args.dec if args.dec else [32, 32, 32, 32, 32, 16, 16]
    warp_atlas = not args.no_warp_atlas
    model = ProbAtlasSegmentation(
        inshape=tuple(inshape), nb_unet_features=[enc_nf, dec_nf], nb_labels=nb_labels,
        stat_post_warp=not args.stat_pre_warp, warp_atlas=warp_atlas,
        init_mu=None if init_mu is None else init_mu.tolist(),
        init_sigma=None if init_sigma is None else init_sigma.tolist(),
        dtype=resolve_dtype(args.dtype), generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, unsupervised_seg_terms(args.grad_loss_weight, warp_atlas),
                      lr=args.lr, device=device)
    initial_epoch = init_or_resume(trainer, args.load_weights, args.model_dir,
                                   args.initial_epoch)
    trainer.fit(generator, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                initial_epoch=initial_epoch, model_dir=args.model_dir, save_freq_epochs=20)
    return trainer


if __name__ == '__main__':
    main()
