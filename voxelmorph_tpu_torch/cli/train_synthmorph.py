"""Train a SynthMorph model on images synthesized from label maps.

The PyTorch counterpart of ``scripts/train_synthmorph.py``, with its flags
and defaults:

    python -m voxelmorph_tpu_torch.cli.train_synthmorph --label-dir labels/ \\
        --model-dir models

The host streams integer label maps; the images are synthesized on the
device inside the train step (``models.synthmorph.SynthMorphDense``), with
draws from the Trainer's generator. The loss is Dice + 1 on the warped
one-hot against the target's, Grad-l2 on pos_flow weighted by
``--reg-param``, and optionally windowed NCC between the warped source and
the target image (``--image-loss-weight``) and an MSE against the exact
synthesis flow (``--sup-flow-weight``, same-subject pairs only).
``--cache-device`` keeps the label maps on the device and draws pairs there
from the stateless stream of ``training.device_cached_label_indices``; with
``--steps-per-dispatch`` K other than 1 each K steps' picks reach the device
in one copy and their metrics are read once (``Trainer.fit_cached_labels``).
Either path starts its pick stream one step on (the per-step path draws
step 0 to learn the shapes), so checkpoints of either path, and of either
package, resume on the same picks. It runs on the GPU unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--label-dir', nargs='+', required=True,
                   help='directory/glob of integer label maps to synthesize from')
    p.add_argument('--model-dir', default='models', help='directory for checkpoints and logs')
    p.add_argument('--sub-dir', help='optional subfolder for model saves')

    p.add_argument('--same-subj', action='store_true',
                   help='synthesize both images of a pair from one label map')
    p.add_argument('--blur-std', type=float, default=1,
                   help='upper bound on the random smoothing sigma')
    p.add_argument('--gamma', type=float, default=0.25,
                   help='standard deviation of the random contrast (gamma) jitter')
    p.add_argument('--vel-std', type=float, default=0.5,
                   help='standard deviation of the random velocity fields')
    p.add_argument('--vel-res', type=float, nargs='+', default=[16],
                   help='spatial scale(s) of the random velocity fields')
    p.add_argument('--bias-std', type=float, default=0.3,
                   help='standard deviation of the random bias fields')
    p.add_argument('--bias-res', type=float, nargs='+', default=[40],
                   help='spatial scale(s) of the random bias fields')
    p.add_argument('--out-shape', type=int, nargs='+',
                   help='pad synthesized volumes to this spatial shape')
    p.add_argument('--out-labels', default='fs_labels.npy', help='labels to optimize')

    p.add_argument('--gpu', type=str, default='0', help='ignored (use --device)')
    p.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    p.add_argument('--epochs', type=int, default=1500, help='total epochs to train')
    p.add_argument('--steps-per-epoch', type=int, default=100, help='steps per epoch')
    p.add_argument('--batch-size', type=int, default=1,
                   help='number of samples per training step')
    p.add_argument('--init-weights',
                   help="checkpoint to start from; 'latest' resumes from model-dir")
    p.add_argument('--save-freq', type=int, default=20,
                   help='checkpoint-writing period, in epochs')
    p.add_argument('--reg-param', type=float, default=1.,
                   help='weight of the flow-gradient smoothness term')
    p.add_argument('--sup-flow-weight', type=float, default=0.,
                   help='weight of a supervised MSE term between pos_flow and the exact '
                        'synthesis flow (same-subject pairs only: use with --same-subj)')
    p.add_argument('--image-loss-weight', type=float, default=0.,
                   help='weight of a windowed-NCC term between the warped source image and '
                        'the target image (0: the reference loss set, Dice + Grad)')
    p.add_argument('--shared-contrast', type=float, default=0.,
                   help='probability that both images of a pair share one per-label GMM '
                        'intensity draw')
    p.add_argument('--lr', type=float, default=1e-4, help='Adam learning rate')
    p.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'],
                   help='U-Net compute dtype')
    p.add_argument('--clip-grad', type=float,
                   help='optional global-norm gradient clip')
    p.add_argument('--init-epoch', type=int, default=0,
                   help='epoch to start counting from, e.g. when resuming')
    p.add_argument('--cache-device', action='store_true',
                   help='keep the label maps on the device and draw pairs there by index')
    p.add_argument('--steps-per-dispatch', type=int, default=1,
                   help='with --cache-device: train steps per dispatch, whose picks are '
                        'copied and whose metrics are read once (0 = one epoch)')

    p.add_argument('--int-steps', type=int, default=5,
                   help='scaling-and-squaring steps for the SVF')
    p.add_argument('--enc', type=int, nargs='+', default=[64] * 4,
                   help='encoder feature counts for the registration U-Net')
    p.add_argument('--dec', type=int, nargs='+', default=[64] * 6, help='U-Net decoder filters')
    args = p.parse_args(argv)
    if not 0.0 <= args.shared_contrast <= 1.0:
        p.error(f'--shared-contrast must be in [0, 1], got {args.shared_contrast}')
    return args


def synthmorph_terms(reg_param: float = 1.0, image_loss_weight: float = 0.0,
                     sup_flow_weight: float = 0.0):
    """The script's loss terms: Dice + 1 of pred_map against map_2, Grad-l2
    of pos_flow (``loss_mult`` ``reg_param``), and where their weights are
    positive windowed NCC of y_source against image_2 and the mean squared
    difference of pos_flow and gt_flow."""
    import torch

    from .. import losses
    from ..training import LossTerm

    dice = losses.Dice()
    terms = [LossTerm('pred_map', lambda t, p: dice.loss(t, p) + 1.0,
                      target_output_key='map_2', name='dice'),
             LossTerm('pos_flow', losses.Grad('l2', loss_mult=reg_param).loss,
                      target_output_key='pos_flow', name='grad')]
    if image_loss_weight > 0:
        terms.append(LossTerm('y_source', losses.NCC().loss, weight=image_loss_weight,
                              target_output_key='image_2', name='ncc'))
    if sup_flow_weight > 0:
        def flow_mse(t, p):
            return torch.mean(torch.square(p - t), dim=tuple(range(1, p.dim())))

        terms.append(LossTerm('pos_flow', flow_mse, weight=sup_flow_weight,
                              target_output_key='gt_flow', name='supflow'))
    return terms


def main(argv=None):
    """Train; return the Trainer."""
    arg = parse_args(argv)

    import torch

    from .. import generators, resolve_device
    from ..models.synthmorph import LabelsToImageConfig, SynthMorphDense
    from ..py.utils import load_labels
    from ..training import (Trainer, device_cached_label_generator, init_or_resume,
                            resolve_dtype)

    device = resolve_device(arg.device)
    if arg.sub_dir:
        arg.model_dir = os.path.join(arg.model_dir, arg.sub_dir)
    os.makedirs(arg.model_dir, exist_ok=True)

    labels_in, label_maps = load_labels(arg.label_dir)
    in_shape = label_maps[0].shape
    if arg.out_labels.endswith('.npy') and os.path.isfile(arg.out_labels):
        labels_out = sorted(x for x in np.load(arg.out_labels) if x in labels_in)
    else:
        labels_out = labels_in

    cfg = LabelsToImageConfig(
        in_shape=in_shape, out_shape=arg.out_shape, in_label_list=labels_in,
        out_label_list=labels_out, warp_std=arg.vel_std, warp_res=arg.vel_res,
        blur_std=arg.blur_std, bias_std=arg.bias_std, bias_res=arg.bias_res,
        gamma_std=arg.gamma)
    model = SynthMorphDense(
        cfg=cfg, nb_unet_features=(arg.enc, arg.dec), int_steps=arg.int_steps,
        int_resolution=2, svf_resolution=2, dtype=resolve_dtype(arg.dtype),
        sup_flow=arg.sup_flow_weight > 0, shared_contrast=arg.shared_contrast,
        generator=torch.Generator().manual_seed(0))
    if arg.sup_flow_weight > 0 and not arg.same_subj:
        raise SystemExit('--sup-flow-weight requires --same-subj: the ground-truth flow only '
                         'exists when both images of a pair derive from one label map')
    terms = synthmorph_terms(arg.reg_param, arg.image_loss_weight, arg.sup_flow_weight)
    trainer = Trainer(model, terms, lr=arg.lr, clip_norm=arg.clip_grad, device=device)

    def save_kwargs(initial_epoch):
        return dict(initial_epoch=initial_epoch, model_dir=arg.model_dir,
                    save_freq_epochs=arg.save_freq, save_filename='{epoch:05d}.npz')

    if arg.cache_device and arg.steps_per_dispatch != 1:
        initial_epoch = init_or_resume(trainer, arg.init_weights, arg.model_dir, arg.init_epoch)
        trainer.fit_cached_labels(
            label_maps, epochs=arg.epochs, steps_per_epoch=arg.steps_per_epoch,
            steps_per_dispatch=arg.steps_per_dispatch, batch_size=arg.batch_size,
            same_subj=arg.same_subj,
            start_step=initial_epoch * arg.steps_per_epoch + 1, **save_kwargs(initial_epoch))
        return trainer

    def stream(start_step=0):
        if arg.cache_device:
            return device_cached_label_generator(label_maps, batch_size=arg.batch_size,
                                                 same_subj=arg.same_subj,
                                                 start_step=start_step, device=device)
        return generators.synthmorph(label_maps, batch_size=arg.batch_size,
                                     same_subj=arg.same_subj, flip=True)

    gen = stream()
    next(gen)  # the shapes probe of the JAX script: step 0 of the stream
    initial_epoch = init_or_resume(trainer, arg.init_weights, arg.model_dir, arg.init_epoch)
    if arg.cache_device and initial_epoch:
        # the resumed position of the uninterrupted run (+1: the probe)
        gen = stream(initial_epoch * arg.steps_per_epoch + 1)

    def synth_inputs():
        while True:
            (src, trg), _ = next(gen)
            # the losses compare model outputs: the targets are unused
            yield (src, trg), (np.zeros(1, np.float32),)

    # inline, as the other train CLIs fit
    trainer.fit(synth_inputs(), epochs=arg.epochs, steps_per_epoch=arg.steps_per_epoch,
                prefetch_size=0, **save_kwargs(initial_epoch))
    return trainer


if __name__ == '__main__':
    main()
