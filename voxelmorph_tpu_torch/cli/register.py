"""Register a moving to a fixed image with a trained VxmDense, HyperMorph or
SynthMorph joint (affine and deformable) model.

The PyTorch counterpart of ``scripts/register.py``, with its flags:

    python -m voxelmorph_tpu_torch.cli.register --moving m.nii.gz \\
        --fixed f.nii.gz --model model.npz --moved moved.nii.gz --warp warp.nii.gz

``--fast-warp`` warps the moving image by bounded warps of the integration
root (``registration.enable_fast_warp``); the warp is unchanged (a
HyperMorph or joint model takes the exact warp, as in the JAX package).
``--hyper`` is a HyperMorph model's hyperparameter, or a HyperVxmJoint's
``hyp`` (``registration.register_pair``), whose warp acts on zero-based
indices. It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--moving', required=True, help='source (moving) volume to be warped')
    parser.add_argument('--fixed', required=True, help='target (fixed) volume to register to')
    parser.add_argument('--moved', required=True, help='where to write the warped volume')
    parser.add_argument('--model', required=True, help='model file for nonlinear registration')
    parser.add_argument('--warp', help='where to write the dense displacement field')
    parser.add_argument('--multichannel', action='store_true',
                        help='volumes already carry a trailing channel axis')
    parser.add_argument('--hyper', type=float, default=0.5,
                        help='hyperparameter fed to HyperMorph models (HyperVxmDense/'
                             'HyperVxmJoint; ignored by others)')
    parser.add_argument('--fast-warp', action='store_true',
                        help='warp the moving image via the phase-warp fast path (bounded '
                             'warps by the integration root instead of one full-res gather; '
                             'the warp field is unchanged)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from .. import resolve_device
    from ..models.modelio import load_model
    from ..py.utils import load_volfile, save_volfile
    from ..registration import enable_fast_warp, register_pair, resolve_registration_model

    device = resolve_device(args.device)
    add_feat_axis = not args.multichannel
    moving = load_volfile(args.moving, add_batch_axis=True, add_feat_axis=add_feat_axis)
    fixed, fixed_affine = load_volfile(args.fixed, add_batch_axis=True,
                                       add_feat_axis=add_feat_axis, ret_affine=True)
    model = resolve_registration_model(load_model(args.model, device=device))
    if args.fast_warp:
        model = enable_fast_warp(model)
    moved, warp = register_pair(model, moving, fixed, hyper=args.hyper)
    if args.warp:
        save_volfile(np.asarray(warp).squeeze(), args.warp, fixed_affine)
    save_volfile(np.asarray(moved).squeeze(), args.moved, fixed_affine)


if __name__ == '__main__':
    main()
