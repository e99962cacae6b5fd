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

``hyper`` (HyperMorph) makes every conv block's convolution, and its
``resfix``, a ``HyperConv``, whose kernel and bias two Linear layers
generate per sample from a hypernetwork embedding passed to ``forward``. As in the JAX package
a hyper block never takes the conv kernel or the lean-dw convolution, so a
hyper U-Net keeps the contiguous layout in every mode.

Inside a model's forward over a mesh's 'space' axis (``parallel.mesh``)
the U-Net runs on this rank's slab of the first spatial dim: each block's
input is widened by one plane of each neighbour's (``halo_exchange``,
before the block's remat, so that its recomputation runs no collective;
``slab_block``), and the block convolves it without padding that dim on
cuDNN and in a ``HyperConv``, or as a SAME convolution cut back to the slab
(``drop_halo``) with the conv kernel and the lean-dw convolution, rounded
as the JAX package rounds the whole volume's shape. The slabs end on
multiples of the pool windows' product (``slab_align``), so the max pools
and upsamplings stay on each rank. Strided blocks (which no model builds)
are not sharded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv3
from ..parallel import mesh as mesh_lib
from ..py.utils import default_unet_features

__all__ = ["Unet", "ConvBlock", "HyperConv", "build_feature_lists", "he_normal_",
           "lecun_normal_", "max_pool", "slab_block", "ACTIVATIONS"]

# flax.linen's activations by name, as torch functions of channels-first
# tensors (flax's defaults: gelu's tanh approximation, leaky_relu's slope
# 0.01; softmax and its log over the channel axis)
ACTIVATIONS = {
    "relu": F.relu, "relu6": F.relu6, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "elu": F.elu, "selu": F.selu, "celu": F.celu, "silu": F.silu, "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"), "softplus": F.softplus,
    "soft_sign": F.softsign, "log_sigmoid": F.logsigmoid,
    "leaky_relu": lambda x: leaky_relu(x, 0.01), "hard_tanh": F.hardtanh,
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


def he_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None,
               scale: float = 2.0) -> torch.Tensor:
    """flax's ``he_normal`` for a conv weight ``(co, ci, *k)``, in place: a
    normal of std sqrt(scale / fan_in), scale 2, truncated at two std and
    rescaled so the truncated draw keeps that std (fan_in = ci * prod(k); for
    a Dense weight ``(out, in)``, in)."""
    fan_in = weight[0].numel()
    # std of a unit normal truncated to [-2, 2]
    std = (scale / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``, the default kernel init of ``nn.Dense`` and
    ``nn.Conv``: ``he_normal_`` with scale 1."""
    return he_normal_(weight, generator, scale=1.0)


class HyperConv(nn.Module):
    """A k3 SAME convolution whose kernel and bias are generated per sample
    from a hypernetwork embedding, as the JAX package's ``HyperConv``.

    ``kernel_gen`` maps the embedding ``(B, nb_hyp_units)`` to the flat
    kernel in the JAX order ``(*k, ci, co)``, ``bias_gen`` to the bias; both
    run in ``dtype``, the matrix product rounded before its bias is added,
    as flax's Dense. Their biases are the "base" kernel and bias: the kernel
    a normal truncated at two std of std sqrt(2 / fan_in) (flax's
    ``truncated_normal`` times the he std, not rescaled to keep that std),
    the bias zero; their weights are N(0, 1e-3). Each sample is convolved
    with its own kernel as one grouped convolution (``groups=B``) in
    ``dtype``, and the bias is added to the rounded output. With ``slab``,
    x is a slab widened by a plane of each neighbour's: its first spatial
    dim is not padded.
    """

    def __init__(self, in_features: int, features: int, ndims: int, nb_hyp_units: int,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.ndims = ndims
        self.dtype = dtype
        fan_in = 3 ** ndims * in_features
        self.kernel_gen = nn.Linear(nb_hyp_units, fan_in * features)
        self.bias_gen = nn.Linear(nb_hyp_units, features)
        he_std = (2.0 / fan_in) ** 0.5
        with torch.no_grad():
            self.kernel_gen.weight.normal_(0.0, 1e-3, generator=generator)
            nn.init.trunc_normal_(self.kernel_gen.bias, 0.0, he_std, -2.0 * he_std,
                                  2.0 * he_std, generator=generator)
            self.bias_gen.weight.normal_(0.0, 1e-3, generator=generator)
            self.bias_gen.bias.zero_()

    def _dense(self, layer: nn.Linear, hyp: torch.Tensor) -> torch.Tensor:
        """flax's Dense in ``dtype``: the product rounded, then the bias."""
        return F.linear(hyp.to(self.dtype), layer.weight.to(self.dtype)) \
            + layer.bias.to(self.dtype)

    def forward(self, x: torch.Tensor, hyp: torch.Tensor, slab: bool = False) -> torch.Tensor:
        nd, ci, co = self.ndims, self.in_features, self.features
        batch, spatial = x.shape[0], x.shape[2:]
        kernels = self._dense(self.kernel_gen, hyp).view(batch, *(3,) * nd, ci, co)
        kernels = kernels.permute(0, nd + 2, nd + 1, *range(1, nd + 1))  # (B, co, ci, *k)
        bias = self._dense(self.bias_gen, hyp)
        out = getattr(F, f"conv{nd}d")(
            x.to(self.dtype).reshape(1, batch * ci, *spatial),
            kernels.reshape(batch * co, ci, *(3,) * nd),
            padding=(0,) + (1,) * (nd - 1) if slab else 1, groups=batch)
        return out.view(batch, co, *out.shape[2:]) + bias.view(batch, co, *[1] * nd)


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
    JAX. The parameters are the same in every case. With ``hyper`` the
    conv and the ``resfix`` are ``HyperConv``s of an embedding of
    ``nb_hyp_units`` features, which ``forward`` takes as ``hyp``, whatever
    the dispatch mode (JAX checks ``hyper`` first).
    """

    def __init__(self, in_features: int, features: int, ndims: int = 3,
                 dtype=torch.float32, do_res: bool = False, include_activation: bool = True,
                 generator: Optional[torch.Generator] = None, strides: int = 1,
                 hyper: bool = False, nb_hyp_units: Optional[int] = None):
        super().__init__()
        self.ndims = ndims
        self.strides = int(strides)
        self.dtype = dtype
        self.do_res = do_res
        self.include_activation = include_activation
        self.hyper = hyper
        if hyper:
            if nb_hyp_units is None:
                raise ValueError("a hyper ConvBlock needs nb_hyp_units")
            self.conv = HyperConv(in_features, features, ndims, nb_hyp_units, dtype, generator)
            if do_res and features != in_features:
                self.resfix = HyperConv(in_features, features, ndims, nb_hyp_units, dtype,
                                        generator)
            return
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

    def _flax_conv(self, conv: nn.Module, x: torch.Tensor, strides: int = 1,
                   slab: bool = False) -> torch.Tensor:
        """flax's Conv on cuDNN: the convolution in ``dtype``, then the bias.
        With ``strides`` > 1, SAME padding as XLA places it: ``ceil(n / s)``
        outputs, the padding's odd voxel at the high end. With ``slab``, x
        is a slab widened by a plane of each neighbour's: its first spatial
        dim is not padded."""
        fn = getattr(F, f"conv{self.ndims}d")
        weight = conv.weight.to(self.dtype)
        if slab:
            out = fn(x, weight, padding=(0,) + (1,) * (self.ndims - 1))
        elif strides == 1:
            out = fn(x, weight, padding=1)
        else:
            pads = []
            for n in reversed(x.shape[2:]):
                total = max((-(-n // strides) - 1) * strides + 3 - n, 0)
                pads += [total // 2, total - total // 2]
            out = fn(F.pad(x, pads), weight, stride=strides)
        return out + conv.bias.to(self.dtype).view(-1, *([1] * self.ndims))

    def forward(self, x: torch.Tensor, hyp: Optional[torch.Tensor] = None,
                depth: Optional[int] = None) -> torch.Tensor:
        """The block on ``x`` ``(B, C, *S)``; with ``depth``, x is a rank's
        slab of a volume whose first spatial dim has ``depth`` planes,
        widened by one plane of each neighbour's (``Unet`` under spatial
        sharding), and the output is the slab's."""
        x = x.to(self.dtype)
        if depth is not None and self.strides != 1:
            raise NotImplementedError("spatial sharding of a strided conv block is not ported")
        fused = self.include_activation and not self.do_res
        slope = 0.2 if fused else None
        if self.hyper:
            out = self.conv(x, hyp, slab=depth is not None)
            fused = False
        elif conv3.pallas_conv_enabled() and self.ndims == 3 and self.strides == 1 \
                and x.dim() == 5:
            nbytes = x.element_size()
            takes = conv3.jax_kernel_takes(x.shape[1], self.conv.out_channels,
                                           depth or x.shape[2], *x.shape[3:], nbytes, nbytes)
            out = _slab_of(conv3.conv3_same_cf(x, self._jax_kernel(),
                                               self.conv.bias.to(self.dtype), act_slope=slope,
                                               round_conv_first=not takes), depth)
        elif conv3.xla_dw_einsum_enabled() and self.strides == 1:
            out = _slab_of(conv3.conv3_same_lean_dw(
                x.movedim(1, -1), self._jax_kernel(), self.conv.bias.to(self.dtype),
                slope).movedim(-1, 1), depth)
        else:
            out = self._flax_conv(self.conv, x, self.strides, depth is not None)
            fused = False
        if fused:
            return out
        if self.do_res:
            if not hasattr(self, "resfix"):
                out = out + _slab_of(x, depth)
            elif self.hyper:
                out = out + self.resfix(x, hyp, slab=depth is not None)
            else:
                out = out + self._flax_conv(self.resfix, x, slab=depth is not None)
        if self.include_activation:
            out = leaky_relu(out, 0.2)
        return out


def slab_block(block: nn.Module, x: torch.Tensor, hyp: Optional[torch.Tensor] = None,
               remat: bool = False) -> torch.Tensor:
    """The conv block ``block`` (a ``ConvBlock``) on ``x``, rematerialised in
    the backward with ``remat`` while autograd records. Inside
    ``parallel.mesh.slabs`` x is this rank's slab: it is widened by a plane
    of each neighbour's first, outside the remat, and the block returns the
    slab's output."""
    depth = None
    space = mesh_lib.current_space()
    if space is not None:
        depth = space.extent(x.shape[2])[0]
        x = mesh_lib.halo_exchange(x, 1, 2, space)
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, hyp, depth, use_reentrant=False, preserve_rng_state=False)
    return block(x, hyp, depth)


def _slab_of(x: torch.Tensor, depth: Optional[int]) -> torch.Tensor:
    """A SAME convolution's output (or input) on a slab widened by a plane
    of each neighbour's, cut back to the slab (``depth`` given); else x."""
    return x if depth is None else mesh_lib.drop_halo(x, 1, 2)


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


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` with JAX's derivative at 0: flax's ``leaky_relu`` is
    ``where(x >= 0, x, slope x)``, whose derivative there is 1, where
    torch's is the slope. A zero pre-activation is common: a zero-padded
    region (SynthMorph's ``out_shape``) through a conv with zero bias."""

    @staticmethod
    def forward(ctx, x, slope):
        y = F.leaky_relu(x, slope)
        ctx.slope = slope
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return conv3._leaky_grad(g, y, ctx.slope), None


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the JAX package's values and derivatives."""
    return _LeakyReLU.apply(x, slope)


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
    draws the initial weights. With ``hyper``, ``forward(x, hyp)`` takes the
    hypernetwork embedding ``(B, nb_hyp_units)`` that every block's
    ``HyperConv`` reads.
    """

    def __init__(self, ndims: int, in_features: int, nb_features=None,
                 nb_levels: Optional[int] = None, max_pool=2, feat_mult: int = 1,
                 nb_conv_per_level: int = 1, do_res: bool = False, nb_upsample_skips: int = 0,
                 final_activation_function: Optional[str] = None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 remat: bool = True, hyper: bool = False, nb_hyp_units: Optional[int] = None):
        super().__init__()
        self.remat = remat
        self.hyper = hyper
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
                                            generator=generator, hyper=hyper,
                                            nb_hyp_units=nb_hyp_units))
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

    @property
    def slab_align(self) -> int:
        """The product of the encoder's pool windows: the unit of the slabs
        of a spatially sharded forward, so that no pool straddles two."""
        return int(np.prod(self.max_pool[:self.nb_levels - 1]))

    def _block(self, name: str, x: torch.Tensor,
               hyp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv block ``name`` on ``x`` (and the embedding ``hyp`` of a
        hyper U-Net), rematerialised in the backward when ``remat`` and
        autograd records. Under spatial sharding the slab is widened by its
        neighbours' planes first, outside the remat (``slab_block``)."""
        return slab_block(getattr(self, name), x, hyp, self.remat)

    def forward(self, x: torch.Tensor, hyp: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.hyper and hyp is None:
            raise ValueError("a hyper U-Net needs the embedding hyp")
        ncpl = self.nb_conv_per_level
        # the conv kernel's layout, kept between its convs (a hyper block
        # never takes the kernel)
        cl = conv3.pallas_conv_enabled() and self.ndims == 3 and not self.hyper
        enc_layers = []
        last = x.to(self.dtype)
        for level in range(self.nb_levels - 1):
            for conv in range(ncpl):
                last = self._block(f"enc_conv_{level}_{conv}", last, hyp)
            enc_layers.append(last)
            last = max_pool(last, self.max_pool[level], self.ndims, cl)
        for level in range(self.nb_levels - 1):
            real_level = self.nb_levels - level - 2
            for conv in range(ncpl):
                last = self._block(f"dec_conv_{real_level}_{conv}", last, hyp)
            if level < self.nb_levels - 1 - self.nb_upsample_skips:
                last = _upsample_nearest(last, self.max_pool[real_level], self.ndims, cl)
                last = torch.cat([last, enc_layers.pop()], dim=1)
        for num in range(len(self.final_convs)):
            last = self._block(f"dec_final_conv_{num}", last, hyp)
        if self.final_activation_function is not None:
            last = ACTIVATIONS[self.final_activation_function](last)
        return last
