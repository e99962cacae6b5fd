"""The U-Net's 3x3x3 SAME convolution: CUDA kernel, plain version, autograd.

Counterpart of ``voxelmorph_tpu/ops/pallas_conv.py``. A stride-1 3x3x3 SAME
convolution with bias and an optional fused LeakyReLU,

    y[b, o, x] = act(bias[o] + sum_{t in [0, 3)^3, c} kernel[t, c, o] * x[b, c, x + t - 1])

with zero padding, f32 accumulation and one rounding to the output dtype.
Public functions keep the JAX package's layouts: ``kernel`` is
``(3, 3, 3, ci, co)``, ``conv3_same_cf`` takes ``(B, ci, D, H, W)`` and
``conv3_same`` channels-last ``(B, D, H, W, ci)``. In memory both are
channels-last: ``conv3_same_cf`` computes on ``torch.channels_last_3d``
tensors (NDHWC storage) and returns one; an input in another layout is
copied once, and ``conv3_same_cf.layout_copies`` counts those copies.
``conv3_same`` is a view on both sides.

On CUDA tensors the forward, and the input gradient of the backward (the same
convolution with the taps flipped and ci and co swapped), launch the
hand-written kernel of ``csrc/conv3.cu`` for every shape, or raise: on the
tensor cores (``tile_plan`` picks the tile per shape), but for the float32
forward, which sums on the CUDA cores in cuDNN's order (``_conv3``). On CPU
tensors they run ``conv3_same_cf_plain``, which follows the Pallas kernel's
own formulation: im2col of the 27 taps in ``[dz, dy, dx, ci]`` order and one
matrix product per z-slab chunk. The weight and bias gradients are 27
shifted contractions over (batch, voxels), plain matrix products over the
channels-last storage on both devices, as the JAX package leaves them to XLA.

``round_conv_first`` chooses where the output is rounded. The JAX package's
``VXM_PALLAS_CONV=1`` mode rounds once after bias and activation (in f32)
where its Pallas kernel takes the shape, and elsewhere falls back to XLA's
convolution, which rounds the convolution to the compute dtype first and adds
the bias and applies the activation in that dtype. ``jax_kernel_takes`` says
which applies to a shape; the CUDA kernel itself never declines one.

``conv3_same_lean_dw`` is the port of the all-XLA lean-dw path
(``VXM_XLA_DW_EINSUM=1``): cuDNN convolutions for the forward and the input
gradient, the shifted contractions for the weight gradient. It is not a
Pallas kernel in the JAX package, so it has no CUDA kernel here.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["set_pallas_conv", "pallas_conv_enabled", "set_xla_dw_einsum",
           "xla_dw_einsum_enabled", "jax_kernel_takes", "conv3_same_cf_plain",
           "kernel_tolerance", "tile_plan", "fma_tile_plan", "conv3_same_cf",
           "conv3_input_grad", "conv3_same", "conv3_same_lean_dw"]

_FORCED = None     # process-local override of VXM_PALLAS_CONV
_FORCED_DW = None  # process-local override of VXM_XLA_DW_EINSUM

_CL = torch.channels_last_3d
# the CUDA kernel's fragments (csrc/conv3.cu): rows of 16 x-voxels, groups
# of 16 output channels; input channels staged KC at a time (32 bytes)
_FR = 16
_KC = {torch.bfloat16: 16, torch.float32: 8}
# M fragments of a warp in the kernel's large tiles (Mma<T>::MF)
_MF_BIG = {torch.bfloat16: 4, torch.float32: 2}
_MAX_WARPS = 8
# chunks of the input staged at a time (csrc/conv3.cu: Mma<T>::STAGES)
_STAGES = {torch.bfloat16: 1, torch.float32: 2}
_SMEM_LIMIT = 232448
# streaming multiprocessors of an H100: the least number of blocks a conv
# launches where its shape allows
_MIN_BLOCKS = 132
# voxels a row of a halo tile costs to stage beyond its own (tile_plan)
_ROW_COST = 16
# bytes of f32 im2col columns the plain version builds at a time
_PLAIN_CHUNK_BYTES = 256 * 2 ** 20
_DTYPES = (torch.float32, torch.bfloat16)


def set_pallas_conv(enabled: Optional[bool]) -> None:
    """Force the conv-kernel dispatch of ``ConvBlock`` on or off for this
    process (None: read VXM_PALLAS_CONV). Takes effect at the next call."""
    global _FORCED
    _FORCED = enabled


def pallas_conv_enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return os.environ.get("VXM_PALLAS_CONV", "0") == "1"


def set_xla_dw_einsum(enabled: Optional[bool]) -> None:
    """Force the lean-dw dispatch of ``ConvBlock`` on or off for this process
    (None: read VXM_XLA_DW_EINSUM)."""
    global _FORCED_DW
    _FORCED_DW = enabled


def xla_dw_einsum_enabled() -> bool:
    if _FORCED_DW is not None:
        return _FORCED_DW
    return os.environ.get("VXM_XLA_DW_EINSUM", "0") == "1"


# --- which convolutions the JAX package's Pallas kernel takes ----------------
# A copy of pallas_conv.py's tile picker (_lanes, _sub, _footprint,
# _pick_tiles and the ci % 2 test of conv3_same_cf), used only to choose the
# rounding order that the JAX package gives each convolution.

_JAX_VMEM_BUDGET = int(11.5 * 1024 * 1024)


def _lanes(n: int) -> int:
    return -(-n // 128) * 128


def _sub(n: int, s: int) -> int:
    return -(-n // s) * s


def _jax_footprint(ci, co, tz, th, W, in_bytes, out_bytes):
    L2 = (th + 2) * W + 2
    win = 2 * ci * (tz + 2) * _lanes(L2) * in_bytes
    P = _sub(27 * ci, 16) * _lanes(th * W) * in_bytes
    out = 2 * co * tz * _lanes(th * W) * out_bytes
    wmat = _sub(co, 16) * _lanes(27 * ci) * in_bytes
    temps = 6 * ci * _lanes(th * W) * 4
    return win + P + out + wmat + temps


def jax_kernel_takes(ci: int, co: int, D: int, H: int, W: int, in_bytes: int,
                     out_bytes: int) -> bool:
    """True where the JAX package's Pallas conv kernel takes this shape (it
    rounds once, after bias and activation), False where it falls back to
    XLA's convolution (which rounds the convolution first)."""
    if ci % 2:
        return False
    for tz in (8, 4, 2, 1):
        if D % tz:
            continue
        for th in (32, 16, 8, 4):
            if H % th or (th * W) % 128:
                continue
            if _jax_footprint(ci, co, tz, th, W, in_bytes, out_bytes) <= _JAX_VMEM_BUDGET:
                return True
    return False


# --- the plain version --------------------------------------------------------

def _epilogue(acc, bias, act_slope, out_dtype, round_conv_first):
    """Bias, activation and rounding of the f32 sums ``acc`` (B, co, N)."""
    bias = bias.view(1, -1, 1)
    if round_conv_first:
        y = acc.to(out_dtype) + bias.to(out_dtype)
        if act_slope is not None:
            slope = torch.tensor(act_slope, dtype=out_dtype)
            y = torch.where(y >= 0, y, y * slope)
        return y
    y = acc + bias
    if act_slope is not None:
        y = torch.where(y >= 0, y, act_slope * y)
    return y.to(out_dtype)


def conv3_same_cf_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        act_slope: Optional[float] = 0.2, out_dtype=None,
                        round_conv_first: bool = False) -> torch.Tensor:
    """The convolution as the Pallas kernel formulates it, with plain ops.

    x: ``(B, ci, D, H, W)``; kernel ``(3, 3, 3, ci, co)`` and bias ``(co,)``
    (None: zero) are first rounded to x's dtype. The 27 shifted taps of the zero-padded
    input are stacked in ``[dz, dy, dx, ci]`` order (im2col) for a chunk of
    z-planes at a time and multiplied by the ``(co, 27 ci)`` weight matrix in
    f32. Returns ``(B, co, D, H, W)`` in ``out_dtype`` (default x's dtype),
    channels-last in memory.
    """
    B, ci, D, H, W = x.shape
    co = kernel.shape[-1]
    out_dtype = out_dtype or x.dtype
    if bias is None:
        bias = x.new_zeros(co)
    wmat = kernel.to(x.dtype).float().permute(4, 0, 1, 2, 3).reshape(co, 27 * ci)
    b = bias.to(x.dtype).float()
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
    out = torch.empty((B, co, D, H, W), dtype=out_dtype, device=x.device, memory_format=_CL)
    planes = max(1, min(D, _PLAIN_CHUNK_BYTES // (27 * ci * H * W * 4 * B)))
    for z0 in range(0, D, planes):
        n = min(planes, D - z0)
        cols = torch.stack([xp[:, :, z0 + dz:z0 + dz + n, dy:dy + H, dx:dx + W]
                            for dz, dy, dx in itertools.product(range(3), repeat=3)], 1)
        acc = torch.matmul(wmat, cols.reshape(B, 27 * ci, n * H * W))
        out[:, :, z0:z0 + n] = _epilogue(acc, b, act_slope, out_dtype,
                                         round_conv_first).view(B, co, n, H, W)
    return out


def kernel_tolerance(plain: torch.Tensor, bias: torch.Tensor,
                     round_conv_first: bool) -> torch.Tensor:
    """Elementwise bound on |kernel - plain version| for the plain output
    ``plain`` (B, co, ...): both sum the same f32 products in other orders,
    so they differ by ~1e-6 of the terms, which can flip a rounding to the
    output dtype. float32: 1e-5 of the largest |plain|. bfloat16: that, plus
    one bf16 step (2^-7 of the magnitude) at each rounding on the way to y:
    one of |y| when rounded once; of the convolution, the bias sum and the
    activation when rounded first, together 2^-7 (3 |y| + |bias|).
    """
    p = plain.float().abs()
    tol = torch.full_like(p, 1e-5 * p.max().item())
    if plain.dtype == torch.bfloat16:
        b = bias.float().abs().view(1, -1, *([1] * (plain.dim() - 2)))
        tol = tol + 2.0 ** -7 * (3 * p + b if round_conv_first else p)
    return tol


# --- the CUDA kernel ----------------------------------------------------------

def _stage_bytes(halo_voxels, nf, dtype):
    elem = 2 if dtype == torch.bfloat16 else 4
    return halo_voxels * 32 + 27 * _KC[dtype] * _FR * nf * elem


def _n_fragments(co: int) -> int:
    """N fragments of 16 output channels a block computes: all of co up to
    48, else groups of 32."""
    return -(-co // _FR) if co <= 3 * _FR else 2


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, D: int, H: int, W: int, co: int, dtype) -> tuple:
    """The CUDA kernel's tile for a conv: ``(mf, nf, nwarps, tz, ty, txf)``.

    A block of ``nwarps`` warps computes ``tz x ty x 16 txf`` output voxels,
    rows of 16 x-voxels of which each warp owns ``mf``, for ``16 nf`` output
    channels. The largest tile that still gives ``_MIN_BLOCKS`` blocks is
    taken (one block per SM of an H100 at least), and of its shapes the one
    that stages the least: the voxels of all its blocks' halo tiles (ragged
    edges included), plus ``_ROW_COST`` for each row of a halo tile, which
    a warp stages at once (on an H100 a 4 x 4 x 32 bfloat16 tile beat a
    4 x 8 x 16 one). The deep convs of the U-Net get one row of one warp
    per block.
    """
    nf0 = _n_fragments(co)
    xf = -(-W // _FR)
    mfb = _MF_BIG[dtype]
    for mf, nwarps, nf in ((mfb, 8, nf0), (mfb, 4, nf0), (1, 4, nf0), (1, 2, nf0),
                           (1, 1, nf0), (1, 1, 1)):
        rows = mf * nwarps
        groups = -(-co // (_FR * nf))
        best = None
        for tz in range(1, rows + 1):
            for ty in range(1, rows // tz + 1):
                if rows % (tz * ty) or rows // (tz * ty) > xf:
                    continue
                txf = rows // (tz * ty)
                halo = (tz + 2) * (ty + 2) * (_FR * txf + 2)
                smem = max(_STAGES[dtype] * _stage_bytes(halo, nf, dtype),
                           rows * _FR * _FR * nf * 4)
                if smem > _SMEM_LIMIT:
                    continue
                blocks = B * -(-D // tz) * -(-H // ty) * -(-xf // txf) * groups
                cost = blocks * (halo + _ROW_COST * (tz + 2) * (ty + 2))
                if best is None or cost < best[0]:
                    best = (cost, blocks, (mf, nf, nwarps, tz, ty, txf))
        if best[1] >= _MIN_BLOCKS:
            break
    return best[2]


def fma_tile_plan(B: int, D: int, H: int, co: int) -> tuple:
    """The tile ``(tz, ty)`` of the float32 CUDA-core kernel: blocks of
    ``tz x ty x 32`` voxels for 16 output channels, the largest that still
    gives ``_MIN_BLOCKS`` blocks along z, y and the channels alone, and no
    smaller than 2 x 4 x 32 (64 threads): on an H100, blocks of one row of
    8 threads made the deep convs slower than fewer, larger blocks."""
    groups = -(-co // _FR)
    for tz, ty in ((4, 8), (2, 8), (2, 4)):
        if B * -(-D // tz) * -(-H // ty) * groups >= _MIN_BLOCKS:
            break
    return tz, ty


def _kernel_args(x, kernel, bias, act_slope, round_conv_first, plan=None, f32_fma=False):
    """The arguments of ``vxm_conv3_fwd`` (``csrc/conv3.cu``) but the stream.

    x: ``(B, ci, D, H, W)``, channels-last in memory; kernel ``(3, 3, 3, ci,
    co)`` and bias ``(co,)`` (None: no bias) are rounded to x's dtype, the
    kernel laid out ``(27, co, ci)``. ``plan`` is the tensor-core tile
    (default ``tile_plan``); ``f32_fma`` runs float32 on the CUDA cores in
    cuDNN's order instead, ``plan`` then its ``(tz, ty)`` (default
    ``fma_tile_plan``). Returns ``(y, operands, args)``: the output to
    be written (channels-last), the tensors that ``args``' pointers point
    into, to be kept alive until the kernel has run, and the arguments.
    """
    B, ci, D, H, W = x.shape
    co = kernel.shape[-1]
    if f32_fma:
        plan = (0, 0, 0, *(plan or fma_tile_plan(B, D, H, co)), 0)
    else:
        plan = plan or tile_plan(B, D, H, W, co, x.dtype)
    w = kernel.to(x.dtype).reshape(27, ci, co).transpose(1, 2).contiguous()
    b = None if bias is None else bias.to(x.dtype).contiguous()
    y = torch.empty((B, co, D, H, W), dtype=x.dtype, device=x.device, memory_format=_CL)
    args = (x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            B, ci, co, D, H, W, int(x.dtype == torch.bfloat16), int(act_slope is not None),
            _slope(act_slope, round_conv_first, x.dtype), int(round_conv_first), int(f32_fma),
            *plan)
    return y, (x, w, b), args


@functools.lru_cache(maxsize=None)
def _slope(act_slope, round_conv_first, dtype):
    """The LeakyReLU slope as the kernel multiplies by it: in the compute
    dtype where XLA's elementwise op does, else in f32."""
    if act_slope is None:
        return 0.0
    return torch.tensor(act_slope, dtype=dtype if round_conv_first else torch.float32).item()


# ctypes types of vxm_conv3_fwd's arguments
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
    [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _conv3_cuda(x, kernel, bias, act_slope, out_dtype, round_conv_first, forward):
    """Launch ``csrc/conv3.cu`` on the current stream; raises if the build or
    the launch fails. x is channels-last in memory. A float32 ``forward``
    runs on the CUDA cores in cuDNN's order (see ``_conv3``)."""
    if x.dtype not in _DTYPES or out_dtype != x.dtype:
        raise TypeError(f"the conv3 kernel takes float32 or bfloat16 and returns the "
                        f"input's dtype; got {x.dtype} -> {out_dtype}")
    y, _operands, args = _kernel_args(x, kernel, bias, act_slope, round_conv_first,
                                      f32_fma=forward and x.dtype == torch.float32)
    fn = _build.entry_point("conv3", "vxm_conv3_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vxm_conv3_fwd CUDA kernel failed to launch: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, co={kernel.shape[-1]}, {x.dtype}, "
                           f"tile {args[-6:]})")
    conv3_same_cf.launches += 1
    return y


def _channels_last(x):
    """x as a channels_last_3d tensor: x itself where it is one, else one
    copy, counted on ``conv3_same_cf.layout_copies``."""
    if x.is_contiguous(memory_format=_CL):
        return x
    conv3_same_cf.layout_copies += 1
    return x.contiguous(memory_format=_CL)


def _conv3(x, kernel, bias, act_slope, out_dtype, round_conv_first, forward=True):
    """The convolution on x's device. On CUDA, bfloat16 runs on the tensor
    cores, and so does the float32 input gradient (``forward`` False, by the
    3xTF32 split); the float32 forward sums on the CUDA cores in the order
    of cuDNN's float32 convolution, bit for bit: its outputs decide the
    network's discrete branches (LeakyReLU sides, max-pool ties), which a
    forward that rounds otherwise flips, and a train step in the conv-kernel
    mode then departs from one in cuDNN mode by more than its order of sums."""
    x = _channels_last(x)
    if x.device.type == "cpu":
        return conv3_same_cf_plain(x, kernel, bias, act_slope, out_dtype, round_conv_first)
    if x.device.type != "cuda":
        raise ValueError(f"conv3 runs on CUDA or CPU tensors, not {x.device}")
    return _conv3_cuda(x, kernel, bias, act_slope, out_dtype, round_conv_first, forward)


def _flip_transpose_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, ci, co) -> taps flipped, ci <-> co: the kernel of the input
    gradient of a SAME convolution."""
    return kernel.flip(0, 1, 2).transpose(3, 4)


def conv3_input_grad(gf: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The input gradient of ``conv3_same_cf`` for the cotangent ``gf`` of
    its pre-activation output ``(B, co, D, H, W)``: the same convolution
    with the taps flipped and ci and co swapped, no bias and no activation,
    in gf's dtype. On CUDA tensors the kernel (float32 on the tensor cores
    by the 3xTF32 split), counted on ``conv3_same_cf.launches``."""
    return _conv3(gf, _flip_transpose_kernel(kernel.to(gf.dtype)), None, None, gf.dtype,
                  False, forward=False)


def _leaky_grad(g, y, act_slope):
    """The cotangent before a LeakyReLU of positive slope, from the sign of
    its output (the activation is monotone)."""
    if act_slope is None:
        return g
    # the slope as a 0-dim CPU tensor of g's dtype: the same product as a
    # device tensor's, with no copy to the device (which would sync the host);
    # the product's buffer takes the result, so the mask is the one temporary
    scaled = g * torch.tensor(act_slope, dtype=g.dtype)
    return torch.where(y >= 0, g, scaled, out=scaled)


def _shifted_dw_db(x: torch.Tensor, gf: torch.Tensor):
    """Weight and bias gradients of a 3^N SAME convolution with N = 1..3
    spatial axes, in f32: ``dw[t] = sum_{b, v} x[b, :, v + t - 1] gf[b, :, v]^T``
    for each of the 3^N taps t, and ``db = sum_{b, v} gf[b, :, v]``.

    x: ``(B, ci, *S)``, gf: ``(B, co, *S)``, read channels-last: a
    channels-last tensor's storage is read without a copy besides the
    padding. Each tap is one matrix product over a slice of the zero-padded
    input, flattened: x is padded by one voxel on each side (and the first
    axis by one more at its end) to ``(B, S0 + 3, S1 + 2, ..., ci)`` and gf
    by two zeros at the end of every axis but the first, so that in the
    flattened ``(B, n, c)`` layout a tap's shifted input is a contiguous
    slice of rows at a fixed offset, and the pad rows of gf cancel what the
    slice reads past a row: ``dw[t] = xflat[:, off:off + n]^T @ gflat``.
    Returns dw ``(3,) * N + (ci, co)`` and db ``(co,)``.
    """
    B, ci, *S = x.shape
    co = gf.shape[1]
    nd = len(S)
    xpad, gpad = [0, 0], [0, 0]  # F.pad lists the last axis (channels) first
    for axis in reversed(range(nd)):
        xpad += [1, 2] if axis == 0 else [1, 1]
        gpad += [0, 0] if axis == 0 else [0, 2]
    xflat = F.pad(x.float().movedim(1, -1), xpad).reshape(B, -1, ci)
    gflat = F.pad(gf.float().movedim(1, -1), gpad).reshape(B, -1, co)
    n = gflat.shape[1]
    strides = [1] * nd
    for axis in reversed(range(nd - 1)):
        strides[axis] = strides[axis + 1] * (S[axis + 1] + 2)
    taps = []
    for tap in itertools.product(range(3), repeat=nd):
        off = sum(t * s for t, s in zip(tap, strides))
        taps.append(torch.matmul(xflat[:, off:off + n].transpose(1, 2), gflat).sum(0))
    dw = torch.stack(taps, 0).reshape(*((3,) * nd), ci, co)
    db = gflat.sum(dim=(0, 1))
    return dw, db


class _Conv3Block(torch.autograd.Function):
    """The convolution with the VJP of ``pallas_conv._conv3_block_cf``: dx is
    the same convolution (the kernel on CUDA) with flipped, transposed taps,
    skipped when x needs no gradient; dw and db are shifted contractions."""

    @staticmethod
    def forward(ctx, x, kernel, bias, act_slope, round_conv_first):
        y = _conv3(x, kernel, bias, act_slope, x.dtype, round_conv_first)
        ctx.act_slope = act_slope
        ctx.save_for_backward(x, kernel, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, kernel, y = ctx.saved_tensors
        gf = _leaky_grad(g, y, ctx.act_slope)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3_input_grad(gf, kernel)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _shifted_dw_db(x, gf)
            dw, db = dw.to(kernel.dtype), db.to(x.dtype)
        return dx, dw, db, None, None


def _check(x, kernel, bias):
    if x.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3) or kernel.dim() != 5:
        raise ValueError(f"conv3 takes x (B, ci, D, H, W) and kernel (3, 3, 3, ci, co); got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.shape[3] != x.shape[1] or tuple(bias.shape) != (kernel.shape[4],):
        raise ValueError(f"x {tuple(x.shape)}, kernel {tuple(kernel.shape)} and bias "
                         f"{tuple(bias.shape)} disagree on channels")


def conv3_same_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
                  act_slope: Optional[float] = 0.2, out_dtype=None,
                  round_conv_first: bool = False) -> torch.Tensor:
    """3x3x3 SAME conv + bias (+ LeakyReLU), batched channels-first.

    x: ``(B, ci, D, H, W)``; kernel: ``(3, 3, 3, ci, co)``; bias: ``(co,)``;
    kernel and bias are rounded to x's dtype. Returns ``(B, co, D, H, W)``,
    differentiable in all three. Computes channels-last: the output is a
    ``torch.channels_last_3d`` tensor, and an x (or a cotangent) in another
    layout is copied once. On CUDA tensors the forward and the input
    gradient launch the CUDA kernel, for every shape, and raise if the build
    or a launch fails; on CPU tensors they run ``conv3_same_cf_plain``.
    ``conv3_same_cf.launches`` counts kernel launches and
    ``conv3_same_cf.layout_copies`` the layout copies.
    """
    _check(x, kernel, bias)
    out = _Conv3Block.apply(x, kernel.to(x.dtype), bias.to(x.dtype), act_slope,
                            bool(round_conv_first))
    return out if out_dtype is None else out.to(out_dtype)


conv3_same_cf.launches = 0
conv3_same_cf.layout_copies = 0


def conv3_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
               act_slope: Optional[float] = 0.2, out_dtype=None,
               round_conv_first: bool = False) -> torch.Tensor:
    """Channels-last ``conv3_same_cf``: x ``(B, D, H, W, ci)`` -> ``(B, D, H, W, co)``,
    views of the channels-last tensors ``conv3_same_cf`` takes and returns
    (no copy for a contiguous x)."""
    out = conv3_same_cf(x.movedim(-1, 1), kernel, bias, act_slope=act_slope,
                        out_dtype=out_dtype, round_conv_first=round_conv_first)
    return out.movedim(1, -1)


# --- the lean-dw path (no kernel) ---------------------------------------------

def _torch_weight(kernel: torch.Tensor) -> torch.Tensor:
    """(*k, ci, co) -> PyTorch's (co, ci, *k)."""
    nd = kernel.dim() - 2
    return kernel.permute(nd + 1, nd, *range(nd))


def _lean_fwd_raw(x_cf, kernel, bias, act_slope):
    """XLA's convolution: rounded to the compute dtype, then the bias and the
    activation in that dtype."""
    nd = x_cf.dim() - 2
    out = getattr(F, f"conv{nd}d")(x_cf, _torch_weight(kernel), padding=1)
    out = out + bias.view(-1, *([1] * nd))
    if act_slope is not None:
        out = torch.where(out >= 0, out,
                          out * torch.tensor(act_slope, dtype=out.dtype))
    return out


class _LeanDw(torch.autograd.Function):
    """``pallas_conv.conv3_same_lean_dw``: the library convolution forward
    and input gradient, the shifted contractions for dw and db."""

    @staticmethod
    def forward(ctx, x_cf, kernel, bias, act_slope):
        y = _lean_fwd_raw(x_cf, kernel, bias, act_slope)
        ctx.act_slope = act_slope
        ctx.save_for_backward(x_cf, kernel, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, kernel, y = ctx.saved_tensors
        nd = x.dim() - 2
        gf = _leaky_grad(g, y, ctx.act_slope)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            flipped = kernel.flip(*range(nd)).transpose(nd, nd + 1)
            dx = getattr(F, f"conv{nd}d")(gf, _torch_weight(flipped), padding=1)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _shifted_dw_db(x, gf)
            dw, db = dw.to(kernel.dtype), db.to(g.dtype)
        return dx, dw, db, None


def conv3_same_lean_dw(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       act_slope: Optional[float]) -> torch.Tensor:
    """``nn.Conv``-equivalent 3^N SAME conv (+ bias, + optional LeakyReLU),
    N = 1..3, channels-last: x ``(B, *S, ci)``, kernel ``(3,) * N + (ci,
    co)``, bias ``(co,)``, all in the compute dtype. The weight gradient is
    the shifted contractions instead of the library's."""
    nd = x.dim() - 2
    if not 1 <= nd <= 3 or tuple(kernel.shape[:nd]) != (3,) * nd:
        raise ValueError(f"conv3_same_lean_dw takes 1-3 spatial axes and a 3^N kernel; got "
                         f"x {tuple(x.shape)} and kernel {tuple(kernel.shape)}")
    return _LeanDw.apply(x.movedim(-1, 1), kernel, bias, act_slope).movedim(1, -1)
