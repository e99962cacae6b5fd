"""Dice evaluation over registered image pairs.

The PyTorch counterpart of ``scripts/test.py``, with its flags:

    python -m voxelmorph_tpu_torch.cli.test --model model.npz --pairs pairs.txt \
        --img-suffix "" --seg-prefix ""

For each pair it predicts the warp (timed), carries the moving segmentation
along with nearest interpolation in the same call, and prints the hard-label
Dice against the fixed segmentation; the first call (which builds the
kernels) is left out of the average time. ``--fast-warp`` times the
phase-warp path; the Dice, computed on the segmentation carried by pos_flow,
is the same. ``--hyper`` is a HyperMorph model's hyperparameter, or a
SynthMorph joint model's ``hyp`` (``registration.build_eval_register_fn``).
It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--gpu', help='ignored (use --device)')
    parser.add_argument('--model', required=True, help='trained registration checkpoint (.npz)')
    parser.add_argument('--pairs', required=True, help='text file listing moving/fixed pairs, one pair per line')
    parser.add_argument('--img-suffix', help='string appended to every image path in the list')
    parser.add_argument('--seg-suffix', help='string appended to every seg path in the list')
    parser.add_argument('--img-prefix', help='string prepended to every image path in the list')
    parser.add_argument('--seg-prefix', help='string prepended to every seg path in the list')
    parser.add_argument('--labels', help='optional label list to compute dice for (npy format)')
    parser.add_argument('--hyper', type=float, default=0.5,
                        help='hyperparameter for HyperMorph models (HyperVxmDense/'
                             'HyperVxmJoint; ignored by others)')
    parser.add_argument('--multichannel', action='store_true',
                        help='volumes already carry a trailing channel axis')
    parser.add_argument('--fast-warp', action='store_true',
                        help='time the phase-warp inference path (bounded warps by the '
                             'integration root; Dice is computed on the seg transport by '
                             'pos_flow and is unaffected)')
    parser.add_argument('--device', default='cuda', help='torch device (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """Print each pair's Dice and the averages; return the mean Dice of each
    pair."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.modelio import load_model
    from ..py.utils import dice, load_volfile, read_pair_list
    from ..registration import (build_eval_register_fn, enable_fast_warp,
                                resolve_registration_model)

    device = resolve_device(args.device)
    if (args.img_prefix, args.img_suffix) == (args.seg_prefix, args.seg_suffix):
        sys.exit('Error: image and seg paths need a differing prefix or suffix.')
    img_pairs = read_pair_list(args.pairs, prefix=args.img_prefix, suffix=args.img_suffix)
    seg_pairs = read_pair_list(args.pairs, prefix=args.seg_prefix, suffix=args.seg_suffix)

    labels = np.load(args.labels) if args.labels else None
    feat_axis = not args.multichannel

    def load(path, var):
        vol = load_volfile(path, np_var=var, add_batch_axis=True, add_feat_axis=feat_axis)
        return torch.as_tensor(np.asarray(vol, np.float32), device=device)

    model = resolve_registration_model(load_model(args.model, device=device))
    if args.fast_warp:
        model = enable_fast_warp(model)
    register = build_eval_register_fn(model, hyper=args.hyper)

    timings, scores = [], []
    for i, ((mov_img, fix_img), (mov_seg, fix_seg)) in enumerate(zip(img_pairs, seg_pairs)):
        mv, fx, ms = load(mov_img, 'vol'), load(fix_img, 'vol'), load(mov_seg, 'seg')
        true_seg = load_volfile(fix_seg, np_var='seg')

        start = time.time()
        _, _, warped_seg = register(mv, fx, ms)
        warped_seg = warped_seg.cpu().numpy().squeeze()  # waits for the device
        elapsed = time.time() - start
        if i:  # the first call builds the kernels; leave it out
            timings.append(elapsed)

        overlap = dice(warped_seg, true_seg, labels=labels)
        scores.append(np.mean(overlap))
        print('Pair %d    Reg Time: %.4f    Dice: %.4f +/- %.4f' % (
            i + 1, elapsed, np.mean(overlap), np.std(overlap)))

    print()
    print('Avg Reg Time: %.4f +/- %.4f  (skipping first prediction)' % (
        np.mean(timings), np.std(timings)))
    print('Avg Dice: %.4f +/- %.4f' % (np.mean(scores), np.std(scores)))
    return scores


if __name__ == '__main__':
    main()
