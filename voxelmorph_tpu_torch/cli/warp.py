"""Apply a saved transform to an image.

The PyTorch counterpart of ``scripts/warp.py``, with its flags:

    python -m voxelmorph_tpu_torch.cli.warp --moving m.nii.gz --warp warp.nii.gz \\
        --moved moved.nii.gz [--interp nearest]

The transform is a dense displacement field ``(*S, N)`` or an affine matrix
``(N, N+1)`` / ``(N+1, N+1)`` (for example an ``.npy`` file), applied about
the image centre. The output carries the warp file's NIfTI affine. It runs on
the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--moving', required=True, help='source (moving) volume')
    parser.add_argument('--warp', required=True, help='dense displacement field or affine matrix to apply')
    parser.add_argument('--moved', required=True, help='where to write the warped volume')
    parser.add_argument('--interp', default='linear',
                        help="resampling mode, 'linear' or 'nearest' (default: linear)")
    parser.add_argument('--gpu', help='ignored (use --device)')
    parser.add_argument('--multichannel', action='store_true',
                        help='volumes already carry a trailing channel axis')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..ops.warp import transform
    from ..py.utils import load_volfile, save_volfile

    device = resolve_device(args.device)
    moving = load_volfile(args.moving, add_batch_axis=True, add_feat_axis=not args.multichannel)
    deform, deform_affine = load_volfile(args.warp, add_batch_axis=True, ret_affine=True)
    moving = torch.as_tensor(np.array(moving, np.float32), device=device)
    deform = torch.as_tensor(np.array(deform, np.float32), device=device)
    with torch.inference_mode():
        moved = torch.stack([transform(m, d, interp_method=args.interp)
                             for m, d in zip(moving, deform)])
    save_volfile(moved.cpu().numpy().squeeze(), args.moved, deform_affine)


if __name__ == '__main__':
    main()
