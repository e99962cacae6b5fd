"""Configurable N-D U-Net, as in ``voxelmorph_tpu/models/unet.py``.

Encoder of conv(k3) + LeakyReLU(0.2) blocks with max-pool downsampling,
decoder with nearest upsampling and skip concatenation, then the surplus
full-resolution "final convs"; ``nb_upsample_skips`` emits the output at
reduced resolution. Module names follow the JAX package's parameter paths
(``enc_conv_0_0``, ``dec_conv_3_0``, ``dec_final_conv_0``, each with a
``conv``), so a JAX checkpoint maps onto the state dict key for key.

Inside the network tensors are channels-first ``(B, C, *S)``, the layout of
``torch.nn.functional.conv3d``. Parameters are float32; ``dtype`` is the
compute type (bfloat16 for the committed full-width checkpoint). The convs
run on cuDNN, as the JAX package runs them on XLA's ``nn.Conv`` by default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..py.utils import default_unet_features

__all__ = ["Unet", "ConvBlock", "build_feature_lists", "he_normal_", "max_pool"]


def build_feature_lists(nb_features=None, nb_levels=None, feat_mult=1,
                        nb_conv_per_level=1) -> Tuple[list, list]:
    """Resolve the (encoder, decoder) feature lists from the flexible spec."""
    if nb_features is None:
        nb_features = default_unet_features()
    if isinstance(nb_features, int):
        if nb_levels is None:
            raise ValueError("must provide unet nb_levels if nb_features is an integer")
        feats = np.round(nb_features * feat_mult ** np.arange(nb_levels)).astype(int)
        enc = np.repeat(feats[:-1], nb_conv_per_level).tolist()
        dec = np.repeat(np.flip(feats), nb_conv_per_level).tolist()
        return enc, dec
    if nb_levels is not None:
        raise ValueError("cannot use nb_levels if nb_features is not an integer")
    enc, dec = nb_features
    return list(enc), list(dec)


def he_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``he_normal`` for a conv weight ``(co, ci, *k)``, in place: a
    normal of std sqrt(2 / fan_in), truncated at two std and rescaled so the
    truncated draw keeps that std (fan_in = ci * prod(k))."""
    fan_in = weight[0].numel()
    # std of a unit normal truncated to [-2, 2]
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class ConvBlock(nn.Module):
    """conv(k3, SAME) + LeakyReLU(0.2), computed in ``dtype``.

    The bias is added after the convolution's output is rounded to ``dtype``,
    as flax's Conv does, so that a bfloat16 model rounds where the JAX
    package's does.
    """

    def __init__(self, in_features: int, features: int, ndims: int = 3,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ndims = ndims
        self.dtype = dtype
        self.conv = getattr(nn, f"Conv{ndims}d")(in_features, features, 3, padding=1)
        # flax's init: he-normal kernel, zero bias
        he_normal_(self.conv.weight, generator)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(F, f"conv{self.ndims}d")
        out = conv(x.to(self.dtype), self.conv.weight.to(self.dtype), padding=1)
        bias = self.conv.bias.to(self.dtype).view(-1, *([1] * self.ndims))
        return F.leaky_relu(out + bias, 0.2)


def _upsample_nearest(x: torch.Tensor, factor: int, ndims: int) -> torch.Tensor:
    for d in range(ndims):
        x = torch.repeat_interleave(x, factor, dim=d + 2)
    return x


def _pad_to(x: torch.Tensor, shape, value: float) -> torch.Tensor:
    """Pad the spatial axes of ``x`` at their high end up to ``shape``."""
    pads = []
    for have, want in zip(reversed(x.shape[2:]), reversed(shape[2:])):
        pads += [0, want - have]
    return F.pad(x, pads, value=value) if any(pads) else x


class _MaxPool(torch.autograd.Function):
    """Non-overlapping max pool whose backward splits the gradient of a
    window equally among its tied maxima, as the JAX package's ``_max_pool``
    custom VJP does (``F.max_pool3d`` routes it all to one element). Constant
    regions, such as image backgrounds, make ties the norm."""

    @staticmethod
    def forward(ctx, x, window, ndims):
        out = getattr(F, f"max_pool{ndims}d")(x, window, window)
        ctx.window, ctx.ndims = window, ndims
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        window, ndims = ctx.window, ctx.ndims
        # VALID pooling drops the edges past a whole window: zero gradient there
        up = _pad_to(_upsample_nearest(out, window, ndims), x.shape, -float("inf"))
        gu = _pad_to(_upsample_nearest(g, window, ndims), x.shape, 0.0)
        mask = x == up
        # ties per window, each tied element takes an equal share
        count = getattr(F, f"avg_pool{ndims}d")(
            mask.to(torch.float32), window, window) * window ** ndims
        count = _pad_to(_upsample_nearest(count.to(g.dtype), window, ndims), x.shape, 1.0)
        return torch.where(mask, gu / count, torch.zeros_like(gu)), None, None


def max_pool(x: torch.Tensor, window: int, ndims: int) -> torch.Tensor:
    """Non-overlapping max pool of ``(B, C, *S)`` (VALID: odd edges are
    dropped), with the tie-splitting backward of the JAX package."""
    return _MaxPool.apply(x, window, ndims)


class Unet(nn.Module):
    """N-D encoder-decoder with skip connections on ``(B, C, *S)`` tensors.

    ``in_features`` is the channel count of the input; ``out_features`` that
    of the output. The other arguments follow the JAX Unet; ``generator``
    draws the initial weights.
    """

    def __init__(self, ndims: int, in_features: int, nb_features=None,
                 nb_levels: Optional[int] = None, max_pool=2, feat_mult: int = 1,
                 nb_conv_per_level: int = 1, nb_upsample_skips: int = 0,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        enc_nf, dec_nf = build_feature_lists(nb_features, nb_levels, feat_mult,
                                             nb_conv_per_level)
        self.ndims = ndims
        self.dtype = dtype
        self.nb_conv_per_level = nb_conv_per_level
        self.nb_upsample_skips = nb_upsample_skips
        nb_dec_convs = len(enc_nf)
        self.final_convs = dec_nf[nb_dec_convs:]
        dec_nf = dec_nf[:nb_dec_convs]
        self.nb_levels = nb_dec_convs // nb_conv_per_level + 1
        self.max_pool = ([max_pool] * self.nb_levels if isinstance(max_pool, int)
                         else list(max_pool))

        def block(name, cin, nf):
            self.add_module(name, ConvBlock(cin, nf, ndims, dtype=dtype, generator=generator))
            return nf

        ch, skips = in_features, []
        for level in range(self.nb_levels - 1):
            for conv in range(nb_conv_per_level):
                ch = block(f"enc_conv_{level}_{conv}", ch,
                           enc_nf[level * nb_conv_per_level + conv])
            skips.append(ch)
        for level in range(self.nb_levels - 1):
            real_level = self.nb_levels - level - 2
            for conv in range(nb_conv_per_level):
                ch = block(f"dec_conv_{real_level}_{conv}", ch,
                           dec_nf[level * nb_conv_per_level + conv])
            if level < self.nb_levels - 1 - nb_upsample_skips:
                ch += skips.pop()
        for num, nf in enumerate(self.final_convs):
            ch = block(f"dec_final_conv_{num}", ch, nf)
        self.out_features = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ncpl = self.nb_conv_per_level
        enc_layers = []
        last = x.to(self.dtype)
        for level in range(self.nb_levels - 1):
            for conv in range(ncpl):
                last = getattr(self, f"enc_conv_{level}_{conv}")(last)
            enc_layers.append(last)
            last = max_pool(last, self.max_pool[level], self.ndims)
        for level in range(self.nb_levels - 1):
            real_level = self.nb_levels - level - 2
            for conv in range(ncpl):
                last = getattr(self, f"dec_conv_{real_level}_{conv}")(last)
            if level < self.nb_levels - 1 - self.nb_upsample_skips:
                last = _upsample_nearest(last, self.max_pool[real_level], self.ndims)
                last = torch.cat([last, enc_layers.pop()], dim=1)
        for num in range(len(self.final_convs)):
            last = getattr(self, f"dec_final_conv_{num}")(last)
        return last
