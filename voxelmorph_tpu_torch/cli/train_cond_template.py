"""Build a conditional (phenotype-driven) deformable template.

The PyTorch counterpart of ``scripts/train_cond_template.py``, with its
flags:

    python -m voxelmorph_tpu_torch.cli.train_cond_template --img-list list.txt \\
        --pheno-csv pheno.csv --model-dir models

A ``ConditionalTemplateCreation`` model (``conv_nb_features=4``,
``extra_conv_layers=3``) learns the atlas of each phenotype: the image loss,
MSE on the running mean of the inverse flows, Grad-l2 and MSE on the flow.
Without ``--atlas`` the base atlas is zero. It runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--img-list', required=True, help='text file with one training volume path per line')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--pheno-csv', required=True,
                        help='csv file defining training data attributes')
    parser.add_argument('--atlas', help='path to the atlas volume')
    parser.add_argument('--model-dir', default='models', help='directory for checkpoints and logs')
    parser.add_argument('--multichannel', action='store_true')
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
    parser.add_argument('--image-loss', default='ncc', help='mse or ncc')
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                        help='U-Net compute dtype (params, losses and flow integration stay float32)')
    parser.add_argument('--image-loss-weight', type=float, default=1.0)
    parser.add_argument('--mean-loss-weight', type=float, default=1.0)
    parser.add_argument('--grad-loss-weight', type=float, default=1.0)
    parser.add_argument('--deform-loss-weight', type=float, default=0.01)
    return parser.parse_args(argv)


def cond_template_terms(image_loss, image_loss_weight=1.0, mean_loss_weight=1.0,
                        grad_loss_weight=1.0, deform_loss_weight=0.01):
    """The loss terms against the generator's targets [scans, zeros, zeros,
    zeros]: y_source, mean_stream, Grad-l2 and MSE of pos_flow."""
    from .. import losses
    from ..training import LossTerm

    if image_loss == 'ncc':
        image_loss_func = losses.NCC().loss
    elif image_loss == 'mse':
        image_loss_func = losses.MSE().loss
    else:
        raise ValueError(f'Image loss should be "mse" or "ncc", but found "{image_loss}"')
    return [
        LossTerm('y_source', image_loss_func, weight=image_loss_weight, target_index=0),
        LossTerm('mean_stream', losses.MSE().loss, weight=mean_loss_weight, target_index=1,
                 name='mean_stream'),
        LossTerm('pos_flow', losses.Grad('l2', loss_mult=2).loss, weight=grad_loss_weight,
                 target_index=2, name='grad'),
        LossTerm('pos_flow', losses.MSE().loss, weight=deform_loss_weight, target_index=3,
                 name='deform'),
    ]


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import generators, resolve_device
    from ..models.atlas import ConditionalTemplateCreation
    from ..py.utils import load_pheno_csv, load_volfile, read_file_list
    from ..training import Trainer, init_or_resume, resolve_dtype

    device = resolve_device(args.device)
    train_files = read_file_list(args.img_list, prefix=args.img_prefix, suffix=args.img_suffix)
    if not train_files:
        raise ValueError('Could not find any training data.')
    add_feat_axis = not args.multichannel
    pheno, train_files = load_pheno_csv(args.pheno_csv, train_files)
    pheno_shape = next(iter(pheno.values())).shape
    if args.atlas:
        atlas = load_volfile(args.atlas, np_var='vol', add_batch_axis=True,
                             add_feat_axis=add_feat_axis)
    else:
        # a zero atlas of the training volumes' shape
        atlas = np.zeros_like(load_volfile(train_files[0], add_batch_axis=True,
                                           add_feat_axis=add_feat_axis))
    generator = generators.conditional_template_creation(
        train_files, atlas, pheno, batch_size=args.batch_size, add_feat_axis=add_feat_axis)
    next(generator)  # the JAX script draws one batch before training, for its shapes

    enc_nf = args.enc if args.enc else [16, 32, 32, 32]
    dec_nf = args.dec if args.dec else [32, 32, 32, 32, 32, 16, 16]
    model = ConditionalTemplateCreation(
        inshape=tuple(atlas.shape[1:-1]), pheno_input_shape=tuple(pheno_shape),
        nb_unet_features=[enc_nf, dec_nf], conv_nb_features=4, extra_conv_layers=3,
        src_feats=atlas.shape[-1], dtype=resolve_dtype(args.dtype),
        generator=torch.Generator().manual_seed(0))
    terms = cond_template_terms(args.image_loss, args.image_loss_weight, args.mean_loss_weight,
                                args.grad_loss_weight, args.deform_loss_weight)
    trainer = Trainer(model, terms, lr=args.lr, device=device)
    initial_epoch = init_or_resume(trainer, args.load_weights, args.model_dir,
                                   args.initial_epoch)
    trainer.fit(generator, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                initial_epoch=initial_epoch, model_dir=args.model_dir, save_freq_epochs=20)
    return trainer


if __name__ == '__main__':
    main()
