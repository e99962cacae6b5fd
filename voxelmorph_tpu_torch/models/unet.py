"""Configurable N-D U-Net, as in ``voxelmorph_tpu/models/unet.py``.

Encoder of conv(k3) + LeakyReLU(0.2) blocks with max-pool downsampling,
decoder with nearest upsampling and skip concatenation, then the surplus
full-resolution "final convs"; ``nb_upsample_skips`` emits the output at
reduced resolution. ``do_res`` adds each block's input (through a ``resfix``
conv where the widths differ) before the activation, and
``final_activation_function`` (a ``flax.linen`` activation's name) replaces
the last block's LeakyReLU, as in the JAX package. Module names follow the
JAX package's parameter paths (``enc_conv_0_0``, ``dec_conv_3_0``,
``dec_final_conv_0``, each with a ``conv``, and a ``resfix``), so a JAX
checkpoint maps onto the state dict key for key.

Inside the network tensors are channels-first ``(B, C, *S)``, the layout of
``torch.nn.functional.conv3d``. Parameters are float32; ``dtype`` is the
compute type (bfloat16 for the committed full-width checkpoint). The convs
run on cuDNN, as the JAX package runs them on XLA's ``nn.Conv`` by default;
the JAX package's two switches choose otherwise, as there: with
``VXM_PALLAS_CONV=1`` (``ops.conv3.set_pallas_conv``) every 3-D conv block
runs the port's conv kernel (``ops.conv3``), and with ``VXM_XLA_DW_EINSUM=1``
the lean-dw convolution. In the conv-kernel mode the network keeps the
kernel's channels-last memory layout (``torch.channels_last_3d``) from its
input to its output, in the forward and the backward: the max pool, the
nearest upsampling and the skip concatenation all keep it, so a
channels-last input is never copied to another layout.

``remat`` (the default, as the JAX package's ``Unet.remat``) recomputes each
conv block in the backward pass instead of keeping its intermediates
(``torch.utils.checkpoint``, JAX's ``nn.remat(ConvBlock)``): the same values
and parameters, less memory, one more forward of each block. It applies
only while autograd records, so serving under ``torch.no_grad`` pays
nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv3
from ..py.utils import default_unet_features

__all__ = ["Unet", "ConvBlock", "build_feature_lists", "he_normal_", "max_pool",
           "ACTIVATIONS"]

# flax.linen's activations by name, as torch functions of channels-first
# tensors (flax's defaults: gelu's tanh approximation, leaky_relu's slope
# 0.01; softmax and its log over the channel axis)
ACTIVATIONS = {
    "relu": F.relu, "relu6": F.relu6, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "elu": F.elu, "selu": F.selu, "celu": F.celu, "silu": F.silu, "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"), "softplus": F.softplus,
    "soft_sign": F.softsign, "log_sigmoid": F.logsigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01), "hard_tanh": F.hardtanh,
    "hard_sigmoid": F.hardsigmoid, "hard_silu": F.hardswish, "hard_swish": F.hardswish,
    "softmax": lambda x: F.softmax(x, dim=1), "log_softmax": lambda x: F.log_softmax(x, dim=1),
}


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
    """conv(k3, SAME) [+ residual] + LeakyReLU(0.2), computed in ``dtype``.

    The dispatch of the JAX package's ``ConvBlock``: with
    ``conv3.pallas_conv_enabled()`` a 3-D block is ``conv3.conv3_same_cf``
    (``PallasConv3``), rounded in the order the JAX package gives that shape
    (``conv3.jax_kernel_takes``); else with ``conv3.xla_dw_einsum_enabled()``
    it is ``conv3.conv3_same_lean_dw`` (``LeanDwConv``); else cuDNN, where
    the bias is added after the convolution's output is rounded to
    ``dtype``, as flax's Conv does, so that a bfloat16 model rounds where the
    JAX package's does. The first two fuse the activation into the conv
    when the block has one and no residual; otherwise the residual (the
    input, or its ``resfix`` conv on cuDNN where the widths differ) is added
    to the conv's output and the activation follows, in ``dtype``, as in
    JAX. The parameters are the same in every case.
    """

    def __init__(self, in_features: int, features: int, ndims: int = 3,
                 dtype=torch.float32, do_res: bool = False, include_activation: bool = True,
                 generator: Optional[torch.Generator] = None, strides: int = 1):
        super().__init__()
        self.ndims = ndims
        self.strides = int(strides)
        self.dtype = dtype
        self.do_res = do_res
        self.include_activation = include_activation
        conv_cls = getattr(nn, f"Conv{ndims}d")
        self.conv = conv_cls(in_features, features, 3, padding=1)
        # flax's init: he-normal kernel, zero bias
        he_normal_(self.conv.weight, generator)
        nn.init.zeros_(self.conv.bias)
        if do_res and features != in_features:
            self.resfix = conv_cls(in_features, features, 3, padding=1)
            he_normal_(self.resfix.weight, generator)
            nn.init.zeros_(self.resfix.bias)

    def _jax_kernel(self) -> torch.Tensor:
        """The weight in the JAX layout ``(*k, ci, co)``, in ``dtype``."""
        return self.conv.weight.permute(*range(2, self.ndims + 2), 1, 0).to(self.dtype)

    def _flax_conv(self, conv: nn.Module, x: torch.Tensor, strides: int = 1) -> torch.Tensor:
        """flax's Conv on cuDNN: the convolution in ``dtype``, then the bias.
        With ``strides`` > 1, SAME padding as XLA places it: ``ceil(n / s)``
        outputs, the padding's odd voxel at the high end."""
        fn = getattr(F, f"conv{self.ndims}d")
        weight = conv.weight.to(self.dtype)
        if strides == 1:
            out = fn(x, weight, padding=1)
        else:
            pads = []
            for n in reversed(x.shape[2:]):
                total = max((-(-n // strides) - 1) * strides + 3 - n, 0)
                pads += [total // 2, total - total // 2]
            out = fn(F.pad(x, pads), weight, stride=strides)
        return out + conv.bias.to(self.dtype).view(-1, *([1] * self.ndims))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        fused = self.include_activation and not self.do_res
        slope = 0.2 if fused else None
        if conv3.pallas_conv_enabled() and self.ndims == 3 and self.strides == 1 \
                and x.dim() == 5:
            nbytes = x.element_size()
            takes = conv3.jax_kernel_takes(x.shape[1], self.conv.out_channels, *x.shape[2:],
                                           nbytes, nbytes)
            out = conv3.conv3_same_cf(x, self._jax_kernel(), self.conv.bias.to(self.dtype),
                                      act_slope=slope, round_conv_first=not takes)
        elif conv3.xla_dw_einsum_enabled() and self.strides == 1:
            out = conv3.conv3_same_lean_dw(x.movedim(1, -1), self._jax_kernel(),
                                           self.conv.bias.to(self.dtype), slope).movedim(-1, 1)
        else:
            out = self._flax_conv(self.conv, x, self.strides)
            fused = False
        if fused:
            return out
        if self.do_res:
            out = out + (self._flax_conv(self.resfix, x) if hasattr(self, "resfix") else x)
        if self.include_activation:
            out = F.leaky_relu(out, 0.2)
        return out


def _upsample_nearest(x: torch.Tensor, factor: int, ndims: int,
                      channels_last: bool = False) -> torch.Tensor:
    """Nearest upsampling of ``(B, C, *S)`` by ``factor`` on every spatial
    axis, as one broadcast copy (the values of ``repeat_interleave`` on each
    axis, bit for bit). The result is contiguous, or channels-last in memory
    (the broadcast taken over the ``(B, *S, C)`` view) with
    ``channels_last``."""
    if channels_last:
        x = x.movedim(1, -1)
    first = 1 if channels_last else 2  # the first spatial axis
    lead, spatial, trail = x.shape[:first], x.shape[first:first + ndims], x.shape[first + ndims:]
    out = x[(slice(None),) * first + (slice(None), None) * ndims].expand(
        *lead, *[n for size in spatial for n in (size, factor)], *trail)
    out = out.reshape(*lead, *[size * factor for size in spatial], *trail)
    return out.movedim(-1, 1) if channels_last else out


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
    def forward(ctx, x, window, ndims, channels_last):
        out = getattr(F, f"max_pool{ndims}d")(x, window, window)
        ctx.window, ctx.ndims, ctx.channels_last = window, ndims, channels_last
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        window, ndims, last = ctx.window, ctx.ndims, ctx.channels_last
        # VALID pooling drops the edges past a whole window: zero gradient there
        up = _pad_to(_upsample_nearest(out, window, ndims, last), x.shape, -float("inf"))
        gu = _pad_to(_upsample_nearest(g, window, ndims, last), x.shape, 0.0)
        mask = x == up
        # ties per window, each tied element takes an equal share
        count = getattr(F, f"avg_pool{ndims}d")(
            mask.to(torch.float32), window, window) * window ** ndims
        count = _pad_to(_upsample_nearest(count.to(g.dtype), window, ndims, last), x.shape,
                        1.0)
        return torch.where(mask, gu / count, torch.zeros_like(gu)), None, None, None


def max_pool(x: torch.Tensor, window: int, ndims: int,
             channels_last: bool = False) -> torch.Tensor:
    """Non-overlapping max pool of ``(B, C, *S)`` (VALID: odd edges are
    dropped), with the tie-splitting backward of the JAX package; with
    ``channels_last`` the backward's gradient is channels-last in memory."""
    return _MaxPool.apply(x, window, ndims, channels_last)


class Unet(nn.Module):
    """N-D encoder-decoder with skip connections on ``(B, C, *S)`` tensors.

    ``in_features`` is the channel count of the input; ``out_features`` that
    of the output. The other arguments follow the JAX Unet; ``generator``
    draws the initial weights.
    """

    def __init__(self, ndims: int, in_features: int, nb_features=None,
                 nb_levels: Optional[int] = None, max_pool=2, feat_mult: int = 1,
                 nb_conv_per_level: int = 1, do_res: bool = False, nb_upsample_skips: int = 0,
                 final_activation_function: Optional[str] = None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 remat: bool = True):
        super().__init__()
        self.remat = remat
        if final_activation_function is not None and \
                final_activation_function not in ACTIVATIONS:
            raise ValueError(f"unknown final_activation_function '{final_activation_function}'")
        enc_nf, dec_nf = build_feature_lists(nb_features, nb_levels, feat_mult,
                                             nb_conv_per_level)
        self.ndims = ndims
        self.dtype = dtype
        self.nb_conv_per_level = nb_conv_per_level
        self.nb_upsample_skips = nb_upsample_skips
        self.final_activation_function = final_activation_function
        nb_dec_convs = len(enc_nf)
        self.final_convs = dec_nf[nb_dec_convs:]
        dec_nf = dec_nf[:nb_dec_convs]
        self.nb_levels = nb_dec_convs // nb_conv_per_level + 1
        self.max_pool = ([max_pool] * self.nb_levels if isinstance(max_pool, int)
                         else list(max_pool))

        def block(name, cin, nf, include_activation=True):
            self.add_module(name, ConvBlock(cin, nf, ndims, dtype=dtype, do_res=do_res,
                                            include_activation=include_activation,
                                            generator=generator))
            return nf

        # a final activation replaces the LeakyReLU of the last block: the
        # last final conv, or the last decoder conv when there is none
        final_act = final_activation_function is not None
        ch, skips = in_features, []
        for level in range(self.nb_levels - 1):
            for conv in range(nb_conv_per_level):
                ch = block(f"enc_conv_{level}_{conv}", ch,
                           enc_nf[level * nb_conv_per_level + conv])
            skips.append(ch)
        for level in range(self.nb_levels - 1):
            real_level = self.nb_levels - level - 2
            for conv in range(nb_conv_per_level):
                last = (final_act and not self.final_convs and level == self.nb_levels - 2
                        and conv == nb_conv_per_level - 1)
                ch = block(f"dec_conv_{real_level}_{conv}", ch,
                           dec_nf[level * nb_conv_per_level + conv], not last)
            if level < self.nb_levels - 1 - nb_upsample_skips:
                ch += skips.pop()
        for num, nf in enumerate(self.final_convs):
            ch = block(f"dec_final_conv_{num}", ch, nf,
                       not (final_act and num == len(self.final_convs) - 1))
        self.out_features = ch

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The conv block ``name`` on ``x``, rematerialised in the backward
        when ``remat`` and autograd records."""
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
        return block(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ncpl = self.nb_conv_per_level
        # the conv kernel's layout, kept between its convs
        cl = conv3.pallas_conv_enabled() and self.ndims == 3
        enc_layers = []
        last = x.to(self.dtype)
        for level in range(self.nb_levels - 1):
            for conv in range(ncpl):
                last = self._block(f"enc_conv_{level}_{conv}", last)
            enc_layers.append(last)
            last = max_pool(last, self.max_pool[level], self.ndims, cl)
        for level in range(self.nb_levels - 1):
            real_level = self.nb_levels - level - 2
            for conv in range(ncpl):
                last = self._block(f"dec_conv_{real_level}_{conv}", last)
            if level < self.nb_levels - 1 - self.nb_upsample_skips:
                last = _upsample_nearest(last, self.max_pool[real_level], self.ndims, cl)
                last = torch.cat([last, enc_layers.pop()], dim=1)
        for num in range(len(self.final_convs)):
            last = self._block(f"dec_final_conv_{num}", last)
        if self.final_activation_function is not None:
            last = ACTIVATIONS[self.final_activation_function](last)
        return last
