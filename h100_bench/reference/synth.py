"""The plain reference of SynthMorph training (Hoffmann et al., 2022): the
synthesis of an image and a soft one-hot from a label map, the VxmDense
that registers two synthesized images, and its training steps (Dice of the
warped one-hot plus Grad-l2 of the flow, Adam), in float32 with no kernel.

The synthesis draws its randomness from a ``torch.Generator`` in a fixed
order, one sample after another (``draws``): per-label means and standard
deviations, the black-background coin, the voxel noise, the velocity
field's scale and noise, the blur sigma, the bias field's scale and noise,
and the gamma exponent. A generator seeded alike and asked in this order
gives the same numbers on either side.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import common as c


def _small(shape: Sequence[int], scale: float) -> tuple:
    return tuple(max(int(math.ceil(s / scale)), 2) for s in shape)


def _noise_draws(g, shape, scales, max_std, channels, device):
    out = []
    for scale in scales:
        std = torch.rand((1,) * (len(shape) + 1), generator=g, device=device) * max_std
        noise = torch.randn((*_small(shape, scale), channels), generator=g, device=device)
        out.append((std, noise))
    return out


def draws(g: torch.Generator, synth: Dict, batch: int, device) -> List[Dict]:
    """The synthesis draws of ``batch`` samples, in the order stated above."""
    shape = synth["in_shape"]
    n = len(synth["in_label_list"])

    def uniform(size, lo, hi):
        return torch.rand(size, generator=g, device=device) * (hi - lo) + lo

    out = []
    for _ in range(batch):
        d = {"means": uniform((n,), *synth["mean_range"]),
             "stds": uniform((n,), *synth["std_range"])}
        if synth["zero_background"] > 0 and synth["in_label_list"][0] == 0:
            d["zero"] = uniform((), 0.0, 1.0) < synth["zero_background"]
        d["noise"] = torch.randn(tuple(shape), generator=g, device=device)
        d["svf"] = _noise_draws(g, shape, synth["warp_res"], synth["warp_std"], len(shape),
                                device)
        d["blur_sigma"] = uniform((), 0.0, synth["blur_std"])
        if synth["bias_std"] > 0:
            d["bias"] = _noise_draws(g, shape, synth["bias_res"], synth["bias_std"], 1, device)
        d["gamma"] = torch.randn((), generator=g, device=device) * synth["gamma_std"]
        out.append(d)
    return out


def _field(parts, shape) -> torch.Tensor:
    total = 0.0
    for std, noise in parts:
        total = total + c.resize(noise * std, shape)
    return total


def _blur(x: torch.Tensor, sigma: torch.Tensor, max_sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``(*S,)`` with edge padding; the kernel's
    radius is ceil(3 max_sigma), its sigma at least 1e-5."""
    r = max(int(math.ceil(3 * max_sigma)), 1)
    k = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (k / sigma.clamp(min=1e-5)) ** 2)
    k = k / k.sum()
    for axis in range(x.dim()):
        n = x.shape[axis]
        idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
        padded = x.index_select(axis, idx)
        x = sum(k[i] * padded.narrow(axis, i, n) for i in range(2 * r + 1))
    return x


@torch.no_grad()
def synthesize(labels: torch.Tensor, d: Dict, synth: Dict):
    """(image ``(*S, 1)`` in [0, 1], soft one-hot ``(*S, L)``) of one label
    map ``(*S,)`` (label values) from its draws."""
    shape = list(synth["in_shape"])
    in_list = np.asarray(synth["in_label_list"])
    out_list = np.asarray(synth["out_label_list"])
    lut = torch.zeros(int(in_list.max()) + 1, dtype=torch.long, device=labels.device)
    lut[torch.as_tensor(in_list, device=labels.device)] = torch.arange(
        len(in_list), device=labels.device)
    out_lut = torch.full_like(lut, -1)
    out_lut[torch.as_tensor(out_list, device=labels.device)] = torch.arange(
        len(out_list), device=labels.device)
    lab = labels.long()
    means, stds = d["means"].clone(), d["stds"].clone()
    if "zero" in d:
        means[0] = torch.where(d["zero"], 0.0, means[0])
        stds[0] = torch.where(d["zero"], 0.0, stds[0])
    idx = lut[lab]
    image = means[idx] + stds[idx] * d["noise"]
    out_idx = out_lut[lab]
    one_hot = (out_idx[..., None] == torch.arange(len(out_list), device=lab.device)).float()
    svf = _field(d["svf"], shape)
    phi = c.integrate(svf[None], synth["warp_int_steps"])[0]
    loc = c.grid(shape, labels.device) + phi
    moved = c.interp(torch.cat([image[..., None], one_hot], dim=-1), loc)
    image, one_hot = moved[..., 0], moved[..., 1:]
    image = _blur(image, d["blur_sigma"], synth["blur_std"])
    if "bias" in d:
        image = image * torch.exp(_field(d["bias"], shape)[..., 0])
    lo, hi = image.min(), image.max()
    image = (image - lo) / (hi - lo).clamp(min=1e-6)
    image = torch.pow(image.clamp(1e-6, 1.0), torch.exp(d["gamma"]))
    return image[..., None], one_hot


def forward(w: Dict[str, torch.Tensor], model: Dict, image_1: torch.Tensor,
            image_2: torch.Tensor, map_1: torch.Tensor,
            lowp: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The registration of two synthesized images ``(B, *S, 1)``: U-Net at
    ``svf_resolution``, flow head, scaling and squaring at
    ``int_resolution``, the flow back at full resolution, and ``pred_map``,
    the one-hot of the first image warped by it (the recipe has no image
    loss, so the moved image is left out)."""
    enc, dec = model["nb_unet_features"]
    svf_res = model["svf_resolution"]
    x = torch.cat([image_1, image_2], dim=-1).movedim(-1, 1)
    feats = c.unet(x, w, enc, dec, svf_res, prefix="vxm||unet||", lowp=lowp)
    flow = c.conv3(feats, w["vxm||flow||kernel"], w["vxm||flow||bias"]).movedim(1, -1)
    inshape = list(model["inshape"])
    int_shape = [int(round(s / model["int_resolution"])) for s in inshape]
    if list(flow.shape[1:-1]) != int_shape:
        flow = c.rescale_flow(flow, int_shape)
    pos = c.integrate(flow, model["int_steps"])
    pos = c.rescale_flow(pos, inshape)
    return {"pos_flow": pos, "pred_map": c.warp(map_1, pos)}


def loss(out: Dict[str, torch.Tensor], map_2: torch.Tensor, recipe: Dict) -> torch.Tensor:
    """Dice + 1 of the warped one-hot against the second's, plus Grad-l2 of
    the flow (times ``reg_param``), averaged over the batch."""
    return (c.dice(map_2, out["pred_map"]) + 1.0
            + torch.mean(c.grad_l2(out["pos_flow"], recipe["reg_param"])))


def flip_pair(pair: torch.Tensor, flags: Sequence[bool]) -> torch.Tensor:
    for axis, f in enumerate(flags):
        if f:
            pair = pair.flip(axis + 1)
    return pair


def train_steps(w: Dict[str, torch.Tensor], model: Dict, recipe: Dict, synth: Dict,
                maps: torch.Tensor, steps: Sequence, generator: torch.Generator,
                lowp: Optional[str] = None) -> Dict:
    """Adam steps of the SynthMorph recipe from the weights ``w`` (updated in
    place), one a ``(picks, flags)`` of ``steps``: picks ``(2B,)`` index the
    label-map stack ``maps`` ``(N, *S)`` (sources, then targets), flags
    flip the pair along the flagged axes; the synthesis draws come from
    ``generator``, the sources' B samples, then the targets'. Returns each
    step's loss, the first step's gradient and the weights after the last."""
    params = {k: v.requires_grad_(True) for k, v in w.items()}
    adam = c.Adam(params, recipe["lr"])
    losses, first = [], None
    for picks, flags in steps:
        pk = torch.as_tensor(np.asarray(picks), dtype=torch.long, device=maps.device)
        b = pk.numel() // 2
        pair = flip_pair(maps.index_select(0, pk), flags)
        src_draws = draws(generator, synth, b, maps.device)
        trg_draws = draws(generator, synth, b, maps.device)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        step_loss = 0.0
        for r in range(b):
            ima_1, map_1 = synthesize(pair[r], src_draws[r], synth)
            ima_2, map_2 = synthesize(pair[b + r], trg_draws[r], synth)
            out = forward(params, model, ima_1[None], ima_2[None], map_1[None], lowp)
            value = loss(out, map_2[None], recipe) / b
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
