"""Train a VxmDense registration model.

The PyTorch counterpart of ``scripts/train.py``, with its flags:

    python -m voxelmorph_tpu_torch.cli.train --img-list list.txt --model-dir models

scan-to-atlas when ``--atlas`` is given, else scan-to-scan; an MSE or NCC
image loss plus Grad-l2 or, with ``--use-probs``, KL; ``--bidir`` halves the
image weights. Volumes of 1, 2 or 3 dimensions train a VxmDense of their
dimensionality. ``--cache-device`` loads the training set onto the device
once and draws pairs there; with ``--steps-per-dispatch`` K, each K steps'
metrics stay on the device until one fetch of their mean
(``Trainer.fit_cached_pairs``). It runs on the GPU unless ``--device cpu`` is
given. The JAX script's multi-device options (``--spatial-shard``,
``--coordinator``, ``--num-processes``, ``--process-id``) are not ported and
raise.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()

    # data organization parameters
    parser.add_argument('--img-list', required=True, help='text file with one training volume path per line')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--atlas', help='register every scan to this atlas instead of scan-to-scan')
    parser.add_argument('--model-dir', default='models',
                        help='directory for checkpoints and logs (default: models)')
    parser.add_argument('--multichannel', action='store_true',
                        help='volumes already carry a trailing channel axis')

    # training parameters
    parser.add_argument('--gpu', default='0', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--batch-size', type=int, default=1, help='number of volume pairs per training step (default: 1)')
    parser.add_argument('--epochs', type=int, default=1500,
                        help='total epochs to train (default: 1500)')
    parser.add_argument('--steps-per-epoch', type=int, default=100,
                        help='training steps per epoch (default: 100)')
    parser.add_argument('--load-weights', help="checkpoint to start from; 'latest' resumes from model-dir")
    parser.add_argument('--initial-epoch', type=int, default=0,
                        help='epoch to start counting from, e.g. when resuming (default: 0)')
    parser.add_argument('--lr', type=float, default=1e-4, help='Adam learning rate (default: 1e-4)')
    parser.add_argument('--clip-grad', type=float,
                        help='optional global-norm gradient clip')
    parser.add_argument('--spatial-shard', action='store_true', help='not ported (raises)')
    parser.add_argument('--steps-per-dispatch', type=int, default=None,
                        help='with --cache-device: train steps per dispatch, whose metrics '
                             'are read once, as their mean (0 = whole epoch)')
    parser.add_argument('--cache-device', action='store_true',
                        help='preload the whole training set onto the device and draw pairs '
                             'there (removes per-step host transfers)')
    parser.add_argument('--coordinator', help='not ported (raises)')
    parser.add_argument('--num-processes', type=int, default=1, help='not ported (raises if > 1)')
    parser.add_argument('--process-id', type=int, default=0, help='not ported (raises if > 0)')

    # network architecture parameters
    parser.add_argument('--enc', type=int, nargs='+',
                        help='encoder feature counts for the U-Net (default: 16 32 32 32)')
    parser.add_argument('--dec', type=int, nargs='+',
                        help='decoder feature counts for the U-Net (default: 32 32 32 32 32 16 16)')
    parser.add_argument('--int-steps', type=int, default=7,
                        help='scaling-and-squaring steps for the SVF (default: 7)')
    parser.add_argument('--int-downsize', type=int, default=2,
                        help='integrate the flow at 1/N resolution to save memory (default: 2)')
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='U-Net compute dtype (params, losses and flow integration stay float32)')
    parser.add_argument('--use-probs', action='store_true', help='use the probabilistic (MICCAI-2018) flow head')
    parser.add_argument('--save-freq', type=int, default=20,
                        help='checkpoint every N epochs (default: 20)')
    parser.add_argument('--bidir', action='store_true', help='train with symmetric (forward + inverse) image losses')

    # loss hyperparameters
    parser.add_argument('--image-loss', default='mse',
                        help="similarity loss, 'mse' or 'ncc' (default: mse)")
    parser.add_argument('--lambda', type=float, dest='lambda_weight', default=0.01,
                        help='weight of gradient or KL loss (default: 0.01)')
    parser.add_argument('--kl-lambda', type=float, default=10,
                        help='precision of the flow prior in the KL term (default: 10)')
    parser.add_argument('--legacy-image-sigma', dest='image_sigma', type=float, default=1.0,
                        help='image noise parameter for miccai 2018 network '
                             '(recommended value is 0.02 when --use-probs is enabled)')
    return parser.parse_args(argv)


def _reject_unported(args):
    unported = [name for name, given in (
        ('--spatial-shard', args.spatial_shard),
        ('--coordinator', args.coordinator is not None),
        ('--num-processes', args.num_processes != 1),
        ('--process-id', args.process_id != 0)) if given]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: multi-device training is not ported to "
            "voxelmorph_tpu_torch yet")


def main(argv=None):
    args = parse_args(argv)
    _reject_unported(args)
    if args.steps_per_dispatch is not None and not args.cache_device:
        raise SystemExit('--steps-per-dispatch requires --cache-device')

    import torch

    from .. import generators, losses, resolve_device
    from ..models.vxm import VxmDense
    from ..py.utils import load_volfile, read_file_list
    from ..training import (LossTerm, Trainer, device_cached_pair_generator, init_or_resume,
                            load_volume_stack, resolve_dtype)

    device = resolve_device(args.device)
    train_files = read_file_list(args.img_list, prefix=args.img_prefix, suffix=args.img_suffix)
    if not train_files:
        raise ValueError('Could not find any training data.')

    add_feat_axis = not args.multichannel
    atlas = None
    if args.atlas:
        atlas = load_volfile(args.atlas, np_var='vol', add_batch_axis=True,
                             add_feat_axis=add_feat_axis)

    def cached_generator(start_step=0):
        return device_cached_pair_generator(
            train_files, batch_size=args.batch_size, bidir=args.bidir,
            atlas=None if atlas is None else atlas[0], add_feat_axis=add_feat_axis,
            start_step=start_step, device=device)

    if args.cache_device:
        generator = cached_generator()
    elif args.atlas:
        generator = generators.scan_to_atlas(train_files, atlas, batch_size=args.batch_size,
                                             bidir=args.bidir, add_feat_axis=add_feat_axis)
    else:
        generator = generators.scan_to_scan(train_files, batch_size=args.batch_size,
                                            bidir=args.bidir, add_feat_axis=add_feat_axis)

    sample = next(generator)
    inshape = sample[0][0].shape[1:-1]
    nfeats = sample[0][0].shape[-1]

    enc_nf = args.enc if args.enc else [16, 32, 32, 32]
    dec_nf = args.dec if args.dec else [32, 32, 32, 32, 32, 16, 16]
    model = VxmDense(
        inshape=tuple(inshape),
        nb_unet_features=[enc_nf, dec_nf],
        bidir=args.bidir,
        use_probs=args.use_probs,
        int_steps=args.int_steps,
        int_resolution=args.int_downsize,
        src_feats=nfeats,
        trg_feats=nfeats,
        dtype=resolve_dtype(args.dtype),
        generator=torch.Generator().manual_seed(0),
    )

    if args.image_loss == 'ncc':
        image_loss_func = losses.NCC().loss
    elif args.image_loss == 'mse':
        image_loss_func = losses.MSE(args.image_sigma).loss
    else:
        raise ValueError(f'Image loss should be "mse" or "ncc", but found "{args.image_loss}"')

    terms = [LossTerm('y_source', image_loss_func,
                      weight=0.5 if args.bidir else 1.0, target_index=0)]
    if args.bidir:
        terms.append(LossTerm('y_target', image_loss_func, weight=0.5, target_index=1))
    reg_target = len(terms)
    if args.use_probs:
        terms.append(LossTerm('reg', losses.KL(args.kl_lambda, tuple(inshape)).loss,
                              weight=args.lambda_weight, target_index=reg_target, name='kl'))
    else:
        terms.append(LossTerm('reg', losses.Grad('l2', loss_mult=args.int_downsize).loss,
                              weight=args.lambda_weight, target_index=reg_target, name='grad'))

    trainer = Trainer(model, terms, lr=args.lr, clip_norm=args.clip_grad, device=device)
    initial_epoch = init_or_resume(trainer, args.load_weights, args.model_dir,
                                   args.initial_epoch)
    # +1: the shape probe above drew step 0 of the cached stream, so epoch e
    # trains on steps e * S + 1 .. (e + 1) * S, on either cached path
    start_step = initial_epoch * args.steps_per_epoch + 1
    if args.steps_per_dispatch is not None:
        trainer.fit_cached_pairs(
            load_volume_stack(train_files, add_feat_axis=add_feat_axis, device=device),
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            steps_per_dispatch=args.steps_per_dispatch, batch_size=args.batch_size,
            bidir=args.bidir, atlas=None if atlas is None else atlas[0],
            start_step=start_step, initial_epoch=initial_epoch, model_dir=args.model_dir,
            save_freq_epochs=args.save_freq)
        return
    if args.cache_device and initial_epoch:
        generator = cached_generator(start_step)
    # no prefetch: the host already draws while the card runs the queued
    # step, and the copy to the card stays on this thread; on an NVIDIA H100
    # 80GB HBM3 at 700 W prefetch made this fit 2.0-5.4% slower a step
    # (PERF.md)
    trainer.fit(generator, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                initial_epoch=initial_epoch, model_dir=args.model_dir,
                save_freq_epochs=args.save_freq, prefetch_size=0)


if __name__ == '__main__':
    main()
