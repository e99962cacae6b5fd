"""Dice-vs-lambda sweep of a trained HyperMorph model.

The PyTorch counterpart of ``scripts/sweep_hypermorph.py``, with its flags
and its JSON report:

    python -m voxelmorph_tpu_torch.cli.sweep_hypermorph --model hyper.npz \\
        --pairs pairs.txt --labels labels.npz --out sweep.json

The pairs are npz files with 'vol' and 'seg'. The identity Dice (the pairs
unregistered) is the floor; then for each lambda every pair is registered
with the model re-targeted to the pairs' shape, the moving segmentation is
carried by the warp (nearest), and the report gives the mean Dice and the
mean percentage of voxels whose Jacobian determinant is not positive
(folded). ``--labels`` is an ``.npy`` array or an ``.npz`` with 'labels'.
It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, help="HyperVxmDense checkpoint")
    p.add_argument("--pairs", default="data_gen/test_pairs.txt")
    p.add_argument("--labels", required=True,
                   help="labels to score: an .npy array or an .npz with 'labels'")
    p.add_argument("--lambdas", type=float, nargs="+",
                   default=[0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0])
    p.add_argument("--out", default="hypermorph_sweep.json")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None):
    """Write and print the report; return it."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..models.modelio import load_model
    from ..py.utils import dice, jacobian_determinant, read_pair_list
    from ..registration import build_register_seg_fn, resolve_registration_model

    device = resolve_device(args.device)
    labels = np.load(args.labels)
    if not isinstance(labels, np.ndarray):
        labels = labels["labels"]
    pairs = read_pair_list(args.pairs)
    # re-target the (fully convolutional) net to the pairs' resolution
    eval_shape = np.load(pairs[0][0])["vol"].shape
    model = resolve_registration_model(load_model(args.model, device=device),
                                       inshape=eval_shape)

    def volume(array):
        return torch.as_tensor(np.asarray(array, np.float32), device=device)[None, ..., None]

    # identity (unregistered) Dice floor, lambda-independent
    id_dices = []
    for mov_path, fix_path in pairs:
        mov, fix = np.load(mov_path), np.load(fix_path)
        id_dices.append(float(np.mean(dice(mov["seg"], fix["seg"], labels=labels))))
    identity_mean = round(float(np.mean(id_dices)), 4)
    print(f"identity floor: dice {identity_mean:.4f}")

    rows = []
    for lam in args.lambdas:
        register = build_register_seg_fn(model, hyper=lam)
        dices, folds = [], []
        for mov_path, fix_path in pairs:
            mov, fix = np.load(mov_path), np.load(fix_path)
            _, warp, warped_seg = register(volume(mov["vol"]), volume(fix["vol"]),
                                           volume(mov["seg"]))
            warped_seg = warped_seg.cpu().numpy().squeeze()
            d = dice(warped_seg, fix["seg"], labels=labels)
            jac = jacobian_determinant(warp.cpu().numpy().squeeze())
            dices.append(float(np.mean(d)))
            folds.append(100.0 * float(np.mean(jac <= 0)))
        rows.append({"lambda": lam,
                     "dice_mean": round(float(np.mean(dices)), 4),
                     "pct_folded_mean": round(float(np.mean(folds)), 4)})
        print(f"lambda {lam:4.2f}: dice {rows[-1]['dice_mean']:.4f}  "
              f"folded {rows[-1]['pct_folded_mean']:.3f}%")

    shape_str = "x".join(str(s) for s in eval_shape)
    report = {"model": os.path.abspath(args.model),
              "n_pairs": len(pairs), "n_labels": int(len(labels)),
              "protocol": f"identity-floor Dice sweep over lambda; volume "
                          f"resolution {shape_str}; pairs from {args.pairs}",
              "identity_dice_mean": identity_mean,
              "sweep": rows}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
