"""Plain PyTorch building blocks of the reference: the VoxelMorph U-Net, the
trilinear warp with edge clamping, the separable resize, scaling and
squaring, the losses and Adam, written from the published description and
the JAX package's formulations (which the port follows), with no kernel and
no memory-saving device: every tensor of the graph is kept.

Tensors are channels-last, ``(B, *S, C)``, as the program's inputs and
outputs are; the U-Net runs channels-first inside. Nothing here imports the
program or JAX. ``lowp`` names a lower precision for the control (see
``quantize``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


# --- precision of the control -------------------------------------------------

def quantize(x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """``x`` rounded to the control's lower precision and back to its dtype:
    ``"fp8"`` is float8 e4m3 with a per-tensor scale (the largest magnitude
    maps to e4m3's largest finite value, as fp8 training scales a tensor);
    None and ``"tf32"`` leave x as it is (TF32 is a switch of the library's
    convolutions and products, set by ``precision``)."""
    if lowp != "fp8":
        return x
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class precision:
    """Context: float32 convolutions and products in full float32, or in
    TF32 for the ``"tf32"`` control; restores the switches on exit."""

    def __init__(self, lowp: Optional[str]):
        self.tf32 = lowp == "tf32"

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


# --- weights -------------------------------------------------------------------

def weights_from_npz(path: str, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The parameters of a VoxelMorph ``.npz`` checkpoint, by their flat
    name (``unet||enc_conv_0_0||conv||kernel``), kernels in the JAX layout
    ``(3, 3, 3, ci, co)``; the ``__config__`` and ``__extra__`` entries are
    not parameters."""
    with np.load(path, allow_pickle=False) as d:
        return {k: torch.as_tensor(np.asarray(d[k], np.float32), device=device).to(dtype)
                for k in d.files if not k.startswith("__")}


def conv3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          lowp: Optional[str] = None) -> torch.Tensor:
    """3x3x3 SAME cross-correlation of ``(B, ci, D, H, W)`` with a JAX-layout
    kernel ``(3, 3, 3, ci, co)``, plus the bias."""
    w = kernel.permute(4, 3, 0, 1, 2)
    return F.conv3d(quantize(x, lowp), quantize(w, lowp), bias, padding=1)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """flax's ``where(x >= 0, x, slope x)``: its derivative at 0 is 1."""
    return torch.where(x >= 0, x, slope * x)


class _MaxPool(torch.autograd.Function):
    """Max over non-overlapping windows; the backward shares a window's
    gradient equally among its tied maxima (the JAX package's rule)."""

    @staticmethod
    def forward(ctx, x, k):
        out = F.max_pool3d(x, k, k)
        ctx.k = k
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        k = ctx.k
        up = out.repeat_interleave(k, 2).repeat_interleave(k, 3).repeat_interleave(k, 4)
        crop = tuple(slice(0, n) for n in up.shape[2:])
        xs = x[(slice(None), slice(None)) + crop]
        hit = (xs == up).to(g.dtype)
        ties = F.avg_pool3d(hit, k, k) * k ** 3
        share = (g / ties).repeat_interleave(k, 2).repeat_interleave(k, 3) \
            .repeat_interleave(k, 4)
        dx = torch.zeros_like(x)
        dx[(slice(None), slice(None)) + crop] = hit * share
        return dx, None


def max_pool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    return _MaxPool.apply(x, k)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest upsampling by 2 of ``(B, C, D, H, W)``."""
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)


def unet(x: torch.Tensor, w: Dict[str, torch.Tensor], enc: Sequence[int], dec: Sequence[int],
         svf_resolution: int = 1, prefix: str = "unet||",
         lowp: Optional[str] = None) -> torch.Tensor:
    """The VoxelMorph U-Net on ``(B, C, *S)``: one conv + LeakyReLU(0.2) a
    level, max pools of 2 down; up, each decoder conv's output upsampled and
    concatenated with the skip (the last log2(svf_resolution) upsamplings
    skipped), then the final convs."""
    nb = len(enc)
    skips_up = int(math.floor(math.log(svf_resolution) / math.log(2)))

    def block(name, t):
        return leaky_relu(conv3(t, w[f"{prefix}{name}||conv||kernel"],
                                w[f"{prefix}{name}||conv||bias"], lowp))

    skips = []
    for level in range(nb):
        x = block(f"enc_conv_{level}_0", x)
        skips.append(x)
        x = max_pool(x)
    for level in range(nb):
        x = block(f"dec_conv_{nb - 1 - level}_0", x)
        if level < nb - skips_up:
            x = torch.cat([upsample2(x), skips.pop()], dim=1)
    for num in range(len(dec) - nb):
        x = block(f"dec_final_conv_{num}", x)
    return x


# --- warps -----------------------------------------------------------------------

def grid(shape: Sequence[int], device) -> torch.Tensor:
    """The ij voxel grid ``(*shape, N)``, float32."""
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def interp(vol: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of ``vol`` ``(*S, C)`` at ij locations ``loc``
    ``(*S', 3)``, each coordinate clamped to ``[0, n - 1]`` (a sample past
    the edge takes the edge's value; its coordinate gets no gradient)."""
    spatial = vol.shape[:-1]
    c = vol.shape[-1]
    flat = vol.reshape(-1, c)
    lo, hi, wts = [], [], []
    for d, n in enumerate(spatial):
        x = loc[..., d].clamp(0, n - 1)
        i0 = torch.floor(x.detach()).long().clamp(max=n - 1)
        lo.append(i0)
        hi.append((i0 + 1).clamp(max=n - 1))
        wts.append(x - i0.to(x.dtype))
    strides = [spatial[1] * spatial[2], spatial[2], 1]
    out = 0.0
    for corner in range(8):
        bits = [(corner >> (2 - d)) & 1 for d in range(3)]
        idx = sum((hi[d] if b else lo[d]) * strides[d] for d, b in enumerate(bits))
        wt = 1.0
        for d, b in enumerate(bits):
            wt = wt * (wts[d] if b else 1.0 - wts[d])
        out = out + flat[idx] * wt[..., None]
    return out


def warp(vols: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Each volume ``(B, *S, C)`` at ``x + shift(x)``."""
    g = grid(shifts.shape[1:-1], shifts.device)
    return torch.stack([interp(v, g + s) for v, s in zip(vols, shifts)])


def integrate(vec: torch.Tensor, steps: int) -> torch.Tensor:
    """Scaling and squaring of ``(B, *S, 3)``: v / 2^steps, then ``steps``
    times v + v o (id + v)."""
    vec = vec / 2.0 ** steps
    for _ in range(steps):
        vec = vec + warp(vec, vec)
    return vec


def resize_axis(x: torch.Tensor, axis: int, n_out: int, factor: float) -> torch.Tensor:
    """Linear resampling of ``x`` along ``axis`` at ``arange(n_out) / factor``
    (input coordinates), clamped to the input's last voxel."""
    n_in = x.shape[axis]
    c = (torch.arange(n_out, dtype=torch.float64) / factor).clamp(0, n_in - 1)
    i0 = torch.floor(c).long()
    i1 = (i0 + 1).clamp(max=n_in - 1)
    w1 = (c - i0).to(torch.float32).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w1 = w1.reshape(shape)
    a = x.index_select(axis, i0.to(x.device))
    b = x.index_select(axis, i1.to(x.device))
    return a * (1 - w1) + b * w1


def resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``(*S, C)`` resized to ``shape`` by a zoom of ``shape / S`` an axis."""
    for axis, n_out in enumerate(shape):
        n_in = x.shape[axis]
        if n_in != n_out:
            x = resize_axis(x, axis, n_out, n_out / n_in)
    return x


def rescale_flow(flow: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """A batch of displacement fields ``(B, *S, N)`` resized to ``shape``
    and scaled by the zoom (scaled before an upsampling, after a
    downsampling)."""
    factor = shape[0] / flow.shape[1]
    if factor < 1:
        return torch.stack([resize(f, shape) for f in flow]) * factor
    return torch.stack([resize(f * factor, shape) for f in flow])


# --- losses ------------------------------------------------------------------------

def _window_sum(x: torch.Tensor, win: int, axes: Sequence[int]) -> torch.Tensor:
    """A box sum of width ``win`` along each of ``axes`` with zero padding
    (SAME), as a difference of a cumulative sum (the JAX formulation)."""
    lo = (win - 1) // 2
    hi = win - 1 - lo
    for axis in axes:
        n = x.shape[axis]
        pad_lo = list(x.shape)
        pad_lo[axis] = lo + 1
        pad_hi = list(x.shape)
        pad_hi[axis] = hi
        c = torch.cumsum(torch.cat([x.new_zeros(pad_lo), x, x.new_zeros(pad_hi)], dim=axis),
                         dim=axis)
        x = c.narrow(axis, win, n) - c.narrow(axis, 0, n)
    return x


def ncc(y_true: torch.Tensor, y_pred: torch.Tensor, win: int = 9,
        eps: float = 1e-5) -> torch.Tensor:
    """Negative local normalized cross-correlation, one value a sample."""
    nd = y_true.dim() - 2
    s = _window_sum(torch.stack([y_true, y_pred, y_true * y_true, y_pred * y_pred,
                                 y_true * y_pred]).sum(-1), win, range(2, 2 + nd))
    i_sum, j_sum, i2, j2, ij = s.unbind(0)
    size = win ** nd * y_true.shape[-1]
    u_i, u_j = i_sum / size, j_sum / size
    cross = (ij - u_j * i_sum - u_i * j_sum + u_i * u_j * size).clamp(min=eps)
    i_var = (i2 - 2 * u_i * i_sum + u_i * u_i * size).clamp(min=eps)
    j_var = (j2 - 2 * u_j * j_sum + u_j * u_j * size).clamp(min=eps)
    cc = (cross / i_var) * (cross / j_var)
    return -cc.reshape(cc.shape[0], -1).mean(-1)


def kl(flow_params: torch.Tensor, prior_lambda: float) -> torch.Tensor:
    """KL of a probabilistic flow ``(B, *S, 2N)`` (means, log variances) from
    the Laplacian smoothness prior of precision ``prior_lambda``."""
    nd = flow_params.dim() - 2
    mean, log_sigma = flow_params[..., :nd], flow_params[..., nd:]
    spatial = flow_params.shape[1:-1]
    deg = torch.zeros(spatial, device=flow_params.device)
    for d, n in enumerate(spatial):
        c = torch.full((n,), 2.0, device=flow_params.device)
        c[0] = c[-1] = 1.0
        view = [1] * nd
        view[d] = n
        deg = deg + c.reshape(view)
    sigma_term = torch.mean(prior_lambda * deg[None, ..., None] * torch.exp(log_sigma)
                            - log_sigma)
    prec = 0.0
    for axis in range(1, nd + 1):
        n = mean.shape[axis]
        df = mean.narrow(axis, 1, n - 1) - mean.narrow(axis, 0, n - 1)
        prec = prec + torch.mean(df * df)
    prec_term = prior_lambda * 0.5 * prec / nd
    return 0.5 * nd * (sigma_term + prec_term)


def dice(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Negative soft Dice over ``(B, *S, L)``: 2 sum(t p) / sum(t + p) a
    sample and label (0 where both are empty), averaged."""
    axes = tuple(range(1, y_pred.dim() - 1))
    top = 2 * torch.sum(y_true * y_pred, dim=axes)
    bottom = torch.sum(y_true + y_pred, dim=axes)
    empty = bottom == 0
    return -torch.mean(torch.where(empty, 0.0, top / torch.where(empty, 1.0, bottom)))


def grad_l2(flow: torch.Tensor, loss_mult: float = 1.0) -> torch.Tensor:
    """Mean squared forward difference of ``(B, *S, N)`` a sample, averaged
    over the axes, times ``loss_mult``."""
    nd = flow.dim() - 2
    terms = []
    for axis in range(1, nd + 1):
        n = flow.shape[axis]
        d = flow.narrow(axis, 1, n - 1) - flow.narrow(axis, 0, n - 1)
        terms.append((d * d).reshape(d.shape[0], -1).mean(-1))
    return sum(terms) / nd * loss_mult


# --- Adam --------------------------------------------------------------------------

class Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) on a dict of
    tensors, in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params = params
        self.lr = lr
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + eps))


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, as a
    share of the larger of the reference leaf's norm and the median leaf's:
    ``| |p_k| - |r_k| | / max(|r_k|, median_j |r_j|)``, over ``keep`` (every
    leaf by default)."""
    keys = list(reference) if keep is None else keep
    ref = {k: float(reference[k].double().norm()) for k in reference}
    median = float(np.median([ref[k] for k in reference]))
    return {k: abs(float(program[k].double().norm()) - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def median_leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                    keep: List[str]) -> float:
    """The gap between the median leaf norm of the program's and the
    reference's, over the reference's: ``|med_k |p_k| - med_k |r_k|| /
    med_k |r_k|`` over ``keep``."""
    p = float(np.median([float(program[k].double().norm()) for k in keep]))
    r = float(np.median([float(reference[k].double().norm()) for k in keep]))
    return abs(p - r) / max(r, 1e-30)
