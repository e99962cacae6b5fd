"""Instance-specific registration: optimise one flow field for one pair.

The PyTorch counterpart of ``scripts/train_instance.py``, with its flags:

    python -m voxelmorph_tpu_torch.cli.train_instance --moving m.nii.gz \\
        --fixed f.nii.gz --moved moved.nii.gz --warp warp.nii.gz --steps 200

An ``InstanceDense`` flow is trained for ``--steps`` Adam steps (image loss
plus Grad-l2 on the preintegrated flow), warm-started with ``--model`` from
a trained VxmDense checkpoint's preintegrated flow for the pair; the moved
image and the warp are written at the end. It runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--moving', required=True, help='source (moving) volume to be warped')
    parser.add_argument('--fixed', required=True, help='target (fixed) volume to register to')
    parser.add_argument('--moved', required=True, help='where to write the warped (registered) volume')
    parser.add_argument('--model', help='warm-start the flow from a trained model checkpoint')
    parser.add_argument('--warp', help='where to write the dense displacement field')
    parser.add_argument('--multichannel', action='store_true')
    parser.add_argument('-g', '--gpu', help='ignored (use --device)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    parser.add_argument('--steps', type=int, default=200, help='num training steps')
    parser.add_argument('--lr', type=float, default=0.001)
    parser.add_argument('--int-steps', type=int, default=7)
    parser.add_argument('--int-downsize', type=int, default=2)
    parser.add_argument('--multiplier', type=float, default=1000)
    parser.add_argument('--image-loss', default='mse', help='mse or ncc')
    parser.add_argument('--lambda', type=float, dest='lambda_weight', default=0.01)
    return parser.parse_args(argv)


def main(argv=None):
    """Train and write the outputs; returns the loss of each step, read
    from the device once, at the end."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import losses, resolve_device
    from ..models.modelio import load_model
    from ..models.vxm import InstanceDense
    from ..py.utils import load_volfile, save_volfile
    from ..training import LossTerm, Trainer

    device = resolve_device(args.device)
    add_feat_axis = not args.multichannel
    moving = load_volfile(args.moving, add_batch_axis=True, add_feat_axis=add_feat_axis)
    fixed, fixed_affine = load_volfile(args.fixed, add_batch_axis=True,
                                       add_feat_axis=add_feat_axis, ret_affine=True)
    inshape = moving.shape[1:-1]
    model = InstanceDense(inshape=tuple(inshape), feats=moving.shape[-1], mult=args.multiplier,
                          int_steps=args.int_steps, int_resolution=args.int_downsize,
                          generator=torch.Generator().manual_seed(0))

    if args.image_loss == 'ncc':
        image_loss_func = losses.NCC().loss
    elif args.image_loss == 'mse':
        image_loss_func = losses.MSE().loss
    else:
        raise ValueError(f'Image loss should be "mse" or "ncc", but found "{args.image_loss}"')
    terms = [
        LossTerm('y_source', image_loss_func, weight=1.0, target_index=0),
        LossTerm('reg', losses.Grad('l2', loss_mult=args.int_downsize).loss,
                 weight=args.lambda_weight, target_index=1, name='grad'),
    ]
    trainer = Trainer(model, terms, lr=args.lr, device=device)
    trainer.init()
    moving_t = torch.as_tensor(moving, dtype=torch.float32, device=device)
    fixed_t = torch.as_tensor(fixed, dtype=torch.float32, device=device)

    # warm start from a trained model's preintegrated flow for the pair
    if args.model is not None:
        with torch.no_grad():
            out = load_model(args.model, device=device)(moving_t, fixed_t)
        model.set_flow(out['preint_flow'].float())

    zeros = torch.zeros((1, *inshape, len(inshape)), device=device)
    step_losses = []
    for step in range(args.steps):
        step_losses.append(trainer.train_step((moving_t,), (fixed_t, zeros))['loss'])
        if (step + 1) % 50 == 0:
            print(f"step {step + 1}/{args.steps} loss {float(step_losses[-1]):.6f}")

    with torch.no_grad():
        out = model.eval()(moving_t)
    if args.warp:
        save_volfile(out['pos_flow'].cpu().numpy().squeeze(), args.warp, fixed_affine)
    save_volfile(out['y_source'].cpu().numpy().squeeze(), args.moved, fixed_affine)
    return torch.stack(step_losses).tolist() if step_losses else []


if __name__ == '__main__':
    main()
