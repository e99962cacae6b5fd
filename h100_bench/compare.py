"""How ``correct`` is decided for a training cell: the program's first three
steps against the reference's on the same inputs, draws and weights.

The numbers, each a worst case; a cell's file (``workloads/<cell>.json``)
names those it compares and their limits:
- ``loss_gap_first``: the relative gap of the first step's loss.
  ``loss_gap``, the worst of the three steps', is reported beside it: the
  later steps amplify Adam's round-off (an element whose gradient is near
  zero can step the other way), so it swings from seed to seed;
- ``grad_gap``: the first gradient as Adam received it, read back from
  Adam's first moment after one step (``exp_avg / (1 - b1)``), by the worst
  leaf: the gap between its norm and the reference's, over the larger of
  the reference leaf's norm and the median leaf's;
- ``delta_gap``: the change of each leaf over the three steps, by the same
  measure, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone);
  ``delta_gap_median`` is the median leaf's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import common as ref

ADAM_B1 = 0.9
ROUND_OFF_LEAF = 1e-3


def jax_name(name: str) -> str:
    """A torch parameter name as the checkpoint's flat name:
    ``unet.enc_conv_0_0.conv.weight`` -> ``unet||enc_conv_0_0||conv||kernel``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "||".join(parts)


def params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by flat name, copied (norms do not depend on
    the layout, so kernels stay in torch's)."""
    return {jax_name(n): p.detach().float().clone() for n, p in model.named_parameters()}


def first_gradient(model, optimizer) -> Dict[str, torch.Tensor]:
    """The gradient of the first step, from Adam's first moment after it."""
    return {jax_name(n): optimizer.state[p]["exp_avg"].detach().float() / (1 - ADAM_B1)
            for n, p in model.named_parameters()}


def kept_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    median = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= ROUND_OFF_LEAF * median]


def training_gaps(losses: List[float], grads: Dict[str, torch.Tensor],
                  start: Dict[str, torch.Tensor], end: Dict[str, torch.Tensor],
                  reference: Dict, ref_start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of a training cell (see the module's text), the worst
    leaf of each and every step's loss gap beside them."""
    step_gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, reference["losses"])]
    grad = ref.leaf_gaps(grads, reference["first_grads"])
    keep = kept_leaves(reference["first_grads"])
    prog_delta = {k: end[k].to(start[k].device) - start[k] for k in start}
    ref_delta = {k: reference["params"][k].float() - ref_start[k].float() for k in ref_start}
    delta = ref.leaf_gaps(prog_delta, ref_delta, keep)
    worst_grad, worst_delta = max(grad, key=grad.get), max(delta, key=delta.get)
    return {"loss_gap": max(step_gaps), "loss_gap_first": step_gaps[0],
            "grad_gap": grad[worst_grad], "delta_gap": delta[worst_delta],
            "delta_gap_median": ref.median_leaf_gap(prog_delta, ref_delta, keep),
            "leaves_left_out": len(ref_start) - len(keep), "step_loss_gaps": step_gaps,
            "worst_grad_leaf": worst_grad, "worst_delta_leaf": worst_delta,
            "delta_top": sorted(((v, k, end[k].numel()) for k, v in delta.items()),
                                reverse=True)[:4]}


def relative_rms(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The RMS of the difference over the RMS of the reference."""
    d = (program.double() - reference.double()).square().mean().sqrt()
    return float(d / reference.double().square().mean().sqrt().clamp(min=1e-30))
