"""Train a semi-supervised VxmDense: image similarity, Grad-l2 and a Dice
loss on one-hot segmentations warped at half resolution.

The PyTorch counterpart of ``scripts/train_semisupervised_seg.py``, with its
flags:

    python -m voxelmorph_tpu_torch.cli.train_semisupervised_seg \\
        --img-list list.txt --img-suffix "" --seg-prefix "" --labels labels.npy

Images and segmentations come from the same list, with their own prefixes
and suffixes; the same path for both requires npz files that carry 'vol' and
'seg'. ``--atlas`` (an npz with 'vol' and 'seg') registers every scan to it.
``--cache-device`` (scan-to-scan, npz files with 'vol' and 'seg') holds the
volumes and integer segmentations on the device and one-hot encodes the
picked ones there (``training.device_cached_semisupervised_generator``). It
runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--img-list', required=True, help='text file with one training volume path per line')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--seg-suffix', help='string appended to every seg path in the list')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--seg-prefix', help='string prepended to every seg path in the list')
    parser.add_argument('--labels', required=True, help='label list (npy) for dice loss')
    parser.add_argument('--model-dir', default='models', help='directory for checkpoints and logs')
    parser.add_argument('--atlas', help='optional atlas for scan-to-atlas training')
    parser.add_argument('--gpu', default='0', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--epochs', type=int, default=1500)
    parser.add_argument('--steps-per-epoch', type=int, default=100)
    parser.add_argument('--load-weights', help="checkpoint to start from; 'latest' resumes from model-dir")
    parser.add_argument('--initial-epoch', type=int, default=0)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--enc', type=int, nargs='+')
    parser.add_argument('--dec', type=int, nargs='+')
    parser.add_argument('--int-steps', type=int, default=7)
    parser.add_argument('--int-downsize', type=int, default=2)
    parser.add_argument('--image-loss', default='mse', help='mse or ncc')
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='U-Net compute dtype (params, losses and flow integration stay float32)')
    parser.add_argument('--grad-loss-weight', type=float, default=0.01)
    parser.add_argument('--dice-loss-weight', type=float, default=0.01)
    parser.add_argument('--cache-device', action='store_true',
                        help='hold the training set on the device and one-hot encode the '
                             'picked segmentations there')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import generators, losses, resolve_device
    from ..models.vxm import VxmDenseSemiSupervisedSeg
    from ..py.utils import read_file_list
    from ..training import (LossTerm, Trainer, device_cached_semisupervised_generator,
                            init_or_resume, resolve_dtype)

    device = resolve_device(args.device)
    train_imgs = read_file_list(args.img_list, prefix=args.img_prefix, suffix=args.img_suffix)
    if not train_imgs:
        raise ValueError('Could not find any training data.')
    if args.img_prefix == args.seg_prefix and args.img_suffix == args.seg_suffix \
            and not train_imgs[0].endswith('.npz'):
        # the same path for image and seg only means something for npz files
        # that carry both 'vol' and 'seg'
        sys.exit('Error: Must provide a differing file suffix and/or prefix '
                 'for images and segs (unless files are npz with vol+seg).')
    train_segs = read_file_list(args.img_list, prefix=args.seg_prefix, suffix=args.seg_suffix)

    train_labels = np.load(args.labels)
    if args.cache_device:
        if args.atlas or train_segs != train_imgs:
            sys.exit('Error: --cache-device currently requires scan-to-scan '
                     'training with vol+seg npz files.')
        generator = device_cached_semisupervised_generator(train_imgs, labels=train_labels,
                                                           device=device)
    else:
        generator = generators.semisupervised(train_imgs, train_segs, labels=train_labels,
                                              atlas_file=args.atlas)
    sample = next(generator)
    inshape = sample[0][0].shape[1:-1]

    enc_nf = args.enc if args.enc else [16, 32, 32, 32]
    dec_nf = args.dec if args.dec else [32, 32, 32, 32, 32, 16, 16]
    model = VxmDenseSemiSupervisedSeg(
        inshape=tuple(inshape),
        nb_unet_features=[enc_nf, dec_nf],
        nb_labels=len(train_labels),
        int_steps=args.int_steps,
        int_resolution=args.int_downsize,
        dtype=resolve_dtype(args.dtype),
        generator=torch.Generator().manual_seed(0),
    )

    if args.image_loss == 'ncc':
        image_loss_func = losses.NCC().loss
    elif args.image_loss == 'mse':
        image_loss_func = losses.MSE().loss
    else:
        raise ValueError(f'Image loss should be "mse" or "ncc", but found "{args.image_loss}"')

    # generator targets: [trg_vol, zero flow, trg_seg]
    terms = [
        LossTerm('y_source', image_loss_func, weight=1.0, target_index=0),
        LossTerm('reg', losses.Grad('l2', loss_mult=args.int_downsize).loss,
                 weight=args.grad_loss_weight, target_index=1, name='grad'),
        LossTerm('y_seg_source', losses.Dice().loss,
                 weight=args.dice_loss_weight, target_index=2, name='dice'),
    ]

    trainer = Trainer(model, terms, lr=args.lr, device=device)
    initial_epoch = init_or_resume(trainer, args.load_weights, args.model_dir,
                                   args.initial_epoch)
    if args.cache_device and initial_epoch:
        # restart the stateless stream just past the shape probe's step 0
        # (see cli/train.py), so a resume replays the uninterrupted sequence
        generator = device_cached_semisupervised_generator(
            train_imgs, labels=train_labels,
            start_step=initial_epoch * args.steps_per_epoch + 1, device=device)
    trainer.fit(generator, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                initial_epoch=initial_epoch, model_dir=args.model_dir, save_freq_epochs=10)


if __name__ == '__main__':
    main()
