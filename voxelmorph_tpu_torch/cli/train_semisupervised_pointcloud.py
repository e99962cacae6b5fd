"""Train a semi-supervised VxmDense on surface point clouds: image similarity
both ways, Grad-l2 (or KL with ``--use-probs``) and the signed distances of
warped surface points.

The PyTorch counterpart of ``scripts/train_semisupervised_pointcloud.py``,
with its flags:

    python -m voxelmorph_tpu_torch.cli.train_semisupervised_pointcloud \\
        --img-list list.txt --atlas atlas.npz --surf-bidir

Every scan (npz with 'vol' and 'seg') registers to the atlas (npz with 'vol'
and 'seg'); ``generators.surf_semisupervised`` computes the labels' signed
distance transforms and surface points on the training device. The loss
terms: each image term at weight 0.5, the regulariser at ``--lambda``, and
the mean squared signed distance at the warped atlas points (and, with
``--surf-bidir``, at the warped subject points) at ``0.25 / dt_sigma**2``.
It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--img-list', required=True, help='text file with one training volume path per line')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--atlas', required=True, help='atlas filename (npz with vol+seg)')
    parser.add_argument('--model-dir', default='models', help='directory for checkpoints and logs')
    parser.add_argument('--multichannel', action='store_true')
    parser.add_argument('--smooth-seg', type=float, default=0.1,
                        help='segmentation smoothness sigma')
    parser.add_argument('--labels', type=int, nargs='+', default=None,
                        help='labels to use')
    parser.add_argument('--gpu', default='0', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--epochs', type=int, default=1500)
    parser.add_argument('--steps-per-epoch', type=int, default=100)
    parser.add_argument('--load-weights', help="checkpoint to start from; 'latest' resumes from model-dir")
    parser.add_argument('--initial-epoch', type=int, default=0)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--enc', type=int, nargs='+')
    parser.add_argument('--dec', type=int, nargs='+')
    parser.add_argument('--int-steps', type=int, default=7)
    parser.add_argument('--int-downsize', type=int, default=2)
    parser.add_argument('--use-probs', action='store_true')
    parser.add_argument('--surf-points', type=int, default=5000)
    parser.add_argument('--surf-bidir', action='store_true')
    parser.add_argument('--sdt-resize', type=float, default=1.0)
    parser.add_argument('--num-labels', type=int, help='number of labels to sample')
    parser.add_argument('--align-segs', action='store_true')
    parser.add_argument('--image-loss', default='mse', help='mse or ncc')
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='U-Net compute dtype (params, losses and flow integration stay float32)')
    parser.add_argument('--lambda', type=float, dest='lambda_weight', default=0.01)
    parser.add_argument('--dt-sigma', type=float, default=1.0)
    parser.add_argument('--kl-lambda', type=float, default=10)
    parser.add_argument('--legacy-image-sigma', dest='image_sigma', type=float, default=1.0)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import generators, losses, resolve_device
    from ..models.vxm import VxmDenseSemiSupervisedPointCloud
    from ..py.utils import load_volfile, read_file_list
    from ..training import LossTerm, Trainer, init_or_resume, resolve_dtype

    device = resolve_device(args.device)
    train_files = read_file_list(args.img_list, prefix=args.img_prefix, suffix=args.img_suffix)
    if not train_files:
        raise ValueError('Could not find any training data.')

    atlas_vol = load_volfile(args.atlas, np_var='vol')
    atlas_seg = load_volfile(args.atlas, np_var='seg')
    labels = args.labels
    if labels is None:
        labels = np.sort(np.unique(atlas_seg))[1:]
    num_labels = args.num_labels or len(labels)

    generator = generators.surf_semisupervised(
        train_files, atlas_vol, atlas_seg, nb_surface_pts=args.surf_points, labels=labels,
        batch_size=args.batch_size, surf_bidir=args.surf_bidir, smooth_seg_std=args.smooth_seg,
        nb_labels_sample=num_labels, sdt_vol_resize=args.sdt_resize,
        align_segs=args.align_segs, add_feat_axis=not args.multichannel, device=device)

    inshape = atlas_seg.shape
    enc_nf = args.enc if args.enc else [16, 32, 32, 32]
    dec_nf = args.dec if args.dec else [32, 32, 32, 32, 32, 16, 16]
    model = VxmDenseSemiSupervisedPointCloud(
        inshape=tuple(inshape),
        nb_unet_features=[enc_nf, dec_nf],
        nb_surface_points=args.surf_points,
        nb_labels_sample=num_labels,
        sdt_vol_resize=args.sdt_resize,
        surf_bidir=args.surf_bidir,
        use_probs=args.use_probs,
        int_steps=args.int_steps,
        int_resolution=args.int_downsize,
        dtype=resolve_dtype(args.dtype),
        generator=torch.Generator().manual_seed(0),
    )

    if args.image_loss == 'ncc':
        image_loss_func = losses.NCC().loss
    elif args.image_loss == 'mse':
        image_loss_func = losses.MSE(args.image_sigma).loss
    else:
        raise ValueError(f'Image loss should be "mse" or "ncc", but found "{args.image_loss}"')

    # generator targets (surf_bidir): [atlas, scan, zero flow, zero values, zero values]
    terms = [
        LossTerm('y_source', image_loss_func, weight=0.5, target_index=0),
        LossTerm('y_target', image_loss_func, weight=0.5, target_index=1),
    ]
    if args.use_probs:
        terms.append(LossTerm('reg', losses.KL(args.kl_lambda, tuple(inshape)).loss,
                              weight=args.lambda_weight, target_index=2, name='kl'))
    else:
        terms.append(LossTerm('reg', losses.Grad('l2', loss_mult=args.int_downsize).loss,
                              weight=args.lambda_weight, target_index=2, name='grad'))
    dt_weight = 0.25 / (args.dt_sigma ** 2)
    terms.append(LossTerm('subj_dt_value', losses.MSE().loss, weight=dt_weight,
                          target_index=3, name='subj_dt'))
    if args.surf_bidir:
        terms.append(LossTerm('atl_dt_value', losses.MSE().loss, weight=dt_weight,
                              target_index=4, name='atl_dt'))

    trainer = Trainer(model, terms, lr=args.lr, device=device)
    next(generator)  # the JAX script draws one sample before it starts
    initial_epoch = init_or_resume(trainer, args.load_weights, args.model_dir,
                                   args.initial_epoch)
    # no prefetch: a draw is mostly work on the card (the SDTs), which a
    # second stream cannot overlap with a step that keeps the card busy: on
    # an NVIDIA H100 80GB HBM3 at 700 W the fit took 1.8-4.7% longer a step
    # with prefetch (PERF.md)
    trainer.fit(generator, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                initial_epoch=initial_epoch, model_dir=args.model_dir, save_freq_epochs=20,
                prefetch_size=0)


if __name__ == '__main__':
    main()
