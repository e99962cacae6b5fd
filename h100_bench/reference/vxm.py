"""The plain reference of VxmDense (probabilistic diffeomorphic VoxelMorph):
its registration forward and its unsupervised training steps (NCC + KL,
Adam), in float32 with no kernel, from a checkpoint's weights.

``forward`` follows the published model: concat(moving, fixed) -> U-Net ->
flow-mean and log-sigma heads -> (training: a sample with the given noise)
-> the svf resized to the integration grid -> scaling and squaring -> back
to full resolution -> the warp of the moving image.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import common as c


def _int_shape(model: Dict) -> List[int]:
    return [int(round(s / model["int_resolution"])) for s in model["inshape"]]


def forward(w: Dict[str, torch.Tensor], model: Dict, source: torch.Tensor,
            target: torch.Tensor, eps: Optional[torch.Tensor] = None,
            lowp: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Outputs of a VxmDense with ``svf_resolution`` 1 for channels-last
    ``source`` and ``target`` ``(B, *S, 1)``: ``flow_params`` (with
    ``use_probs``), ``pos_flow`` and ``y_source``. ``eps`` ``(B, *S, 3)``,
    given in training, is the sampling noise of the probabilistic flow; the
    mean is used without it."""
    enc, dec = model["nb_unet_features"]
    x = torch.cat([source, target], dim=-1).movedim(-1, 1)
    feats = c.unet(x, w, enc, dec, lowp=lowp)
    flow = c.conv3(feats, w["flow||kernel"], w["flow||bias"]).movedim(1, -1)
    out = {}
    if model.get("use_probs"):
        log_sigma = c.conv3(feats, w["log_sigma||kernel"], w["log_sigma||bias"]).movedim(1, -1)
        out["flow_params"] = torch.cat([flow, log_sigma], dim=-1)
        if eps is not None:
            flow = flow + torch.exp(log_sigma / 2.0) * eps
    inshape = list(model["inshape"])
    pos = flow
    if model["int_steps"] > 0:
        if model["int_resolution"] > 1:
            pos = c.rescale_flow(pos, _int_shape(model))
        pos = c.integrate(pos, model["int_steps"])
        if model["int_resolution"] > 1:
            pos = c.rescale_flow(pos, inshape)
    out["pos_flow"] = pos
    out["y_source"] = c.warp(c.quantize(source, lowp), pos)
    return out


def loss(out: Dict[str, torch.Tensor], target: torch.Tensor, recipe: Dict) -> torch.Tensor:
    """NCC of the moved image against the target plus the weighted KL term,
    averaged over the batch."""
    total = torch.mean(c.ncc(target, out["y_source"]))
    return total + torch.mean(recipe["kl_weight"] * c.kl(out["flow_params"],
                                                          recipe["kl_prior_lambda"]))


def train_steps(w: Dict[str, torch.Tensor], model: Dict, recipe: Dict, data: torch.Tensor,
                picks: Sequence, generator: torch.Generator,
                lowp: Optional[str] = None, fault: Optional[str] = None) -> Dict:
    """Adam steps of the unsupervised recipe from the weights ``w`` (updated
    in place), one a pick: each pick is ``(B + B,)`` indices into the volume
    stack ``data`` ``(N, *S, 1)`` (sources, then targets), the noise of each
    step one ``(B, *S, 3)`` standard normal draw from ``generator``. The
    batch is taken a row at a time, each row's gradient a 1/B share of the
    step's (the loss is a mean over rows). Returns each step's loss, the
    first step's gradient and the weights after the last step.

    ``fault`` plants a fault of a data-parallel step in the reference, for
    reading how far it lies from a sound step: ``"half_batch"`` averages the
    first half of the rows alone, ``"no_exchange"`` takes the first row's
    gradient alone (a rank that never sums with the others)."""
    params = {k: v.requires_grad_(True) for k, v in w.items()}
    adam = c.Adam(params, recipe["lr"])
    losses, first = [], None
    for pk in picks:
        pk = torch.as_tensor(pk, dtype=torch.long, device=data.device)
        b = pk.numel() // 2
        eps = torch.randn((b, *data.shape[1:-1], 3), generator=generator, device=data.device)
        rows = range(b)
        if fault == "half_batch":
            rows = range(max(b // 2, 1))
        elif fault == "no_exchange":
            rows = range(1)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        step_loss = 0.0
        for r in rows:
            src = data[pk[r]][None]
            trg = data[pk[b + r]][None]
            out = forward(params, model, src, trg, eps[r:r + 1], lowp)
            value = loss(out, trg, recipe) / len(rows)
            gs = torch.autograd.grad(value, list(params.values()))
            for k, g in zip(params, gs):
                grads[k] += g
            step_loss += float(value.detach())
            del out, value, gs
        losses.append(step_loss)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(grads)
    return {"losses": losses, "first_grads": first,
            "params": {k: p.detach() for k, p in params.items()}}


@torch.no_grad()
def register(w: Dict[str, torch.Tensor], model: Dict, moving: torch.Tensor,
             fixed: torch.Tensor, lowp: Optional[str] = None):
    """(moved, warp) of the registration forward (the flow mean), a row at a
    time."""
    outs = [forward(w, model, moving[r:r + 1], fixed[r:r + 1], lowp=lowp)
            for r in range(moving.shape[0])]
    return (torch.cat([o["y_source"] for o in outs]), torch.cat([o["pos_flow"] for o in outs]))
