"""Train a HyperMorph model: amortised hyperparameter (lambda) learning.

The PyTorch counterpart of ``scripts/train_hypermorph.py``, with its flags:

    python -m voxelmorph_tpu_torch.cli.train_hypermorph --img-list list.txt \\
        --model-dir models

Each sample draws a random lambda (the endpoints 0 and 1 oversampled at
``--oversample-rate``); the image loss (MSE scaled by 1 / sigma^2 per
sample, or NCC) is weighted by 1 - lambda and Grad-l2 on the preintegrated
flow by lambda, per sample, on a ``HyperVxmDense`` with ``svf_resolution``
2. The lambda draws are stateless per step (numpy's
``default_rng((2027, step))``, the JAX script's stream), so a resumed run
replays the uninterrupted sequence and the draws equal the JAX script's.
scan-to-atlas when ``--atlas`` is given, else scan-to-scan;
``--cache-device`` loads the training set onto the device and draws pairs
there, and with ``--steps-per-dispatch`` K each K steps' metrics stay on
the device until one fetch of their mean (``Trainer.fit_cached_pairs``
with the lambda stream as its ``extra_stream``). ``--test-reg MOVING FIXED
OUT`` writes the moving image registered at 20 lambdas in [0, 1], stacked
on the last axis. It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--img-list', required=True, help='text file with one training volume path per line')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--atlas', help='path to the atlas volume')
    parser.add_argument('--model-dir', default='models', help='directory for checkpoints and logs')
    parser.add_argument('--multichannel', action='store_true')
    parser.add_argument('--test-reg', nargs=3,
                        help='example registration pair and output prefix for lambda sweep')
    parser.add_argument('--gpu', default='0', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--epochs', type=int, default=6000)
    parser.add_argument('--steps-per-epoch', type=int, default=100)
    parser.add_argument('--load-weights', help="checkpoint to start from; 'latest' resumes from model-dir")
    parser.add_argument('--initial-epoch', type=int, default=0)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='U-Net compute dtype (the hypernetwork, losses and flow '
                             'integration stay float32)')
    parser.add_argument('--enc', type=int, nargs='+')
    parser.add_argument('--dec', type=int, nargs='+')
    parser.add_argument('--int-steps', type=int, default=7)
    parser.add_argument('--int-downsize', type=int, default=2)
    parser.add_argument('--image-loss', default='mse', help='mse or ncc')
    parser.add_argument('--image-sigma', type=float, default=0.05)
    parser.add_argument('--oversample-rate', type=float, default=0.2,
                        help='hyperparameter end-point over-sample rate')
    parser.add_argument('--save-freq', type=int, default=100,
                        help='checkpoint every this many epochs')
    parser.add_argument('--cache-device', action='store_true',
                        help='preload the whole training set onto the device and draw pairs '
                             'there; the host sends only the picks and the lambda draws')
    parser.add_argument('--steps-per-dispatch', type=int, default=None,
                        help='with --cache-device: train steps per dispatch, whose metrics '
                             'are read once, as their mean (0 = whole epoch)')
    return parser.parse_args(argv)


def hyp_stream(batch_size: int, oversample_rate: float, start_step: int = 0):
    """The lambda draws, one 1-tuple ``((B, 1) float32,)`` a step: each step
    from ``default_rng((2027, step))`` alone, an endpoint (0 or 1) with
    probability ``oversample_rate``, else uniform in [0, 1)."""
    def draw(rng):
        if rng.random() < oversample_rate:
            return float(rng.choice([0, 1]))
        return float(rng.random())

    step = start_step
    while True:
        rng = np.random.default_rng((2027, step))
        yield (np.expand_dims([draw(rng) for _ in range(batch_size)], -1).astype('float32'),)
        step += 1


def hypermorph_terms(image_loss: str = 'mse', image_sigma: float = 0.05,
                     int_downsize: int = 2):
    """The script's loss terms, weighted per sample by the lambda input (the
    model's last input): the image term by 1 - lambda, Grad-l2 (``loss_mult``
    ``int_downsize``) on 'reg' by lambda."""
    import torch

    from .. import losses
    from ..training import LossTerm

    if image_loss == 'ncc':
        image_loss_func = losses.NCC().loss
    elif image_loss == 'mse':
        scaling = 1.0 / (image_sigma ** 2)

        def image_loss_func(y_true, y_pred):
            return scaling * torch.mean(
                torch.square(y_true - y_pred).reshape(y_pred.shape[0], -1), dim=-1)
    else:
        raise ValueError(f'Image loss should be "mse" or "ncc", but found "{image_loss}"')

    def hyp_of(inputs):
        return inputs[-1].squeeze(-1)

    return [LossTerm('y_source', image_loss_func, weight=lambda inputs, out: 1.0 - hyp_of(inputs),
                     target_index=0),
            LossTerm('reg', losses.Grad('l2', loss_mult=int_downsize).loss,
                     weight=lambda inputs, out: hyp_of(inputs), target_index=1, name='grad')]


def main(argv=None):
    """Train; return the Trainer."""
    args = parse_args(argv)
    if args.steps_per_dispatch is not None and not args.cache_device:
        raise SystemExit('--steps-per-dispatch requires --cache-device')

    import torch

    from .. import generators, resolve_device
    from ..models.hyper import HyperVxmDense
    from ..py.utils import load_volfile, read_file_list, save_volfile
    from ..training import (Trainer, device_cached_pair_generator, init_or_resume,
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

    def make_base_generator(start_step=0):
        if args.cache_device:
            return device_cached_pair_generator(
                train_files, batch_size=args.batch_size,
                atlas=None if atlas is None else atlas[0], add_feat_axis=add_feat_axis,
                start_step=start_step, device=device)
        if atlas is not None:
            return generators.scan_to_atlas(train_files, atlas, batch_size=args.batch_size,
                                            add_feat_axis=add_feat_axis)
        return generators.scan_to_scan(train_files, batch_size=args.batch_size,
                                       add_feat_axis=add_feat_axis)

    def hyp_generator(start_step=0):
        base_generator = make_base_generator(start_step)
        hyps = hyp_stream(args.batch_size, args.oversample_rate, start_step)
        while True:
            (hyp,) = next(hyps)
            inputs, outputs = next(base_generator)
            yield (*inputs, hyp), outputs

    generator = hyp_generator()
    sample = next(generator)
    inshape = sample[0][0].shape[1:-1]
    nfeats = sample[0][0].shape[-1]

    enc_nf = args.enc if args.enc else [16, 32, 32, 32]
    dec_nf = args.dec if args.dec else [32, 32, 32, 32, 32, 16, 16]
    model = HyperVxmDense(
        inshape=tuple(inshape),
        nb_unet_features=[enc_nf, dec_nf],
        int_steps=args.int_steps,
        int_resolution=args.int_downsize,
        svf_resolution=2,
        src_feats=nfeats,
        trg_feats=nfeats,
        dtype=resolve_dtype(args.dtype),
        generator=torch.Generator().manual_seed(0),
    )
    terms = hypermorph_terms(args.image_loss, args.image_sigma, args.int_downsize)
    trainer = Trainer(model, terms, lr=args.lr, device=device)
    initial_epoch = init_or_resume(trainer, args.load_weights, args.model_dir,
                                   args.initial_epoch)
    # +1: the shape probe above drew step 0 of the picks and the lambdas
    start_step = initial_epoch * args.steps_per_epoch + 1
    if args.steps_per_dispatch is not None:
        trainer.fit_cached_pairs(
            load_volume_stack(train_files, add_feat_axis=add_feat_axis, device=device),
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            steps_per_dispatch=args.steps_per_dispatch, batch_size=args.batch_size,
            atlas=None if atlas is None else atlas[0], start_step=start_step,
            extra_stream=hyp_stream(args.batch_size, args.oversample_rate, start_step),
            initial_epoch=initial_epoch, model_dir=args.model_dir,
            save_freq_epochs=args.save_freq)
    else:
        if initial_epoch:
            generator = hyp_generator(start_step)
        # inline, as cli/train fits (PERF.md: prefetch lost on both fits measured)
        trainer.fit(generator, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                    initial_epoch=initial_epoch, model_dir=args.model_dir,
                    save_freq_epochs=args.save_freq, prefetch_size=0)

    # the moving image registered at 20 lambdas in [0, 1]
    if args.test_reg:
        def load(path):
            return torch.as_tensor(load_volfile(path, add_batch_axis=True,
                                                add_feat_axis=add_feat_axis),
                                   dtype=torch.float32, device=device)

        moving, fixed = load(args.test_reg[0]), load(args.test_reg[1])
        model.eval()
        moved = []
        with torch.inference_mode():
            for hyp in np.linspace(0, 1, 20):
                h = torch.full((1, 1), float(hyp), device=device)
                moved.append(model(moving, fixed, h)['y_source'].cpu().numpy().squeeze())
        moved = np.stack(moved, axis=-1)
        if moved.ndim == 3:
            moved = np.expand_dims(moved, axis=-2)
        save_volfile(moved, args.test_reg[2])
    return trainer


if __name__ == '__main__':
    main()
