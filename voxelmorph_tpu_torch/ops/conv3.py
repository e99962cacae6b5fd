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
forward, which sums on the CUDA cores in cuDNN's order (``_conv3``;
``fma_plan`` picks its tile, ``conv3_fma_chain`` is its plain version bit
for bit). On CPU
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
           "conv3_fma_chain", "fma_chain_sums", "kernel_tolerance", "staging", "tile_plan",
           "fma_plan", "conv3_same_cf", "conv3_input_grad", "conv3_same", "conv3_same_lean_dw"]

_FORCED = None     # process-local override of VXM_PALLAS_CONV
_FORCED_DW = None  # process-local override of VXM_XLA_DW_EINSUM

_CL = torch.channels_last_3d
# the CUDA kernel (csrc/conv3.cu): rows of 16 x-voxels; input channels
# staged KC at a time (32-byte rows); the widths of output channels a block
# computes (a wider conv takes several groups of the widest)
_FR = 16
_KC = {torch.bfloat16: 16, torch.float32: 8}
_WIDTHS = (16, 32, 48, 64, 128)
_CONSUMER_WARPS = 8
# weight planes of a group of 9 taps (float32: a big and a small copy each),
# and bytes of a voxel's 16 channels in the epilogue's buffer
_PLANES = {torch.bfloat16: 9, torch.float32: 18}
_OUT_STRIDE = {torch.bfloat16: 48, torch.float32: 96}
_ALIGN = 1024
_SMEM_LIMIT = 232448
# streaming multiprocessors of an H100: the persistent grid where no card
# says otherwise
_SMS = 132
# the float32 forward on the CUDA cores: rows of 36 floats staged, at most 8
# consumer warps; by the output channels CT of a warp, a lane's (VZ, VX): VX
# contiguous x-voxels at VZ z planes, and the widths FX of a tile along x it
# takes (the warp FX / VX lanes along x by 32 VX / FX along y)
_F_ROW = 36
_F_WARPS = 8
_F_LANE = {8: (2, 8), 4: (1, 4)}
_F_WIDTHS = {8: (32, 16), 4: (32,)}
_F_MAX_N = 64
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


def _fma(p: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf``, exactly: ``p`` the float64 product of two float32
    values (exact: 48 bits), ``acc`` a float32 value in float64. The sum is
    rounded to odd in float64 (its error by TwoSum; where that is not zero,
    the sum rounded toward zero with its last bit set), which then rounds to
    float32 as the exact sum would: 53 bits is more than float32's 24 + 2."""
    s = p + acc
    bb = s - p
    err = (p - (s - bb)).add_(acc - bb)
    # toward zero: one step down in magnitude where the rounding went away
    # from zero (the error's sign opposite the sum's); then the last bit
    bits = s.view(torch.int64)
    bits.sub_((err * s < 0).long()).bitwise_or_((err != 0).long())
    return bits.view(torch.float64).float().double()


def fma_chain_sums(x: torch.Tensor, kernel: torch.Tensor, planes=None) -> torch.Tensor:
    """The float32 sums of ``conv3_fma_chain`` before its bias: each output
    one chain of float32 FMAs over (c, dz, dy, dx) in that order from 0, the
    zero padding's taps included, each FMA emulated in float64 (``_fma``).
    x: ``(B, ci, D, H, W)``, kernel ``(3, 3, 3, ci, co)`` rounded to float32;
    ``planes``: the output z planes (default all). Returns ``(B, co,
    len(planes), H, W)`` float32."""
    B, ci, D, H, W = x.shape
    co = kernel.shape[-1]
    z = torch.arange(D, device=x.device) if planes is None else \
        torch.as_tensor(planes, device=x.device)
    w = kernel.to(torch.float32).double()
    xp = F.pad(x.to(torch.float32).double(), (1, 1, 1, 1, 1, 1))
    acc = torch.zeros((B, co, len(z), H, W), dtype=torch.float64, device=x.device)
    for c in range(ci):
        for dz in range(3):
            xs = xp[:, c, z + dz].unsqueeze(1)
            for dy, dx in itertools.product(range(3), repeat=2):
                acc = _fma(w[dz, dy, dx, c].view(1, co, 1, 1, 1) * xs[..., dy:dy + H, dx:dx + W],
                           acc)
    return acc.float()


def conv3_fma_chain(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                    act_slope: Optional[float] = 0.2, round_conv_first: bool = False,
                    planes=None, sums: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float32 forward as the CUDA-core kernel computes it, bit for bit:
    each output one chain of float32 FMAs over (c, dz, dy, dx) in that
    order from 0 (``fma_chain_sums``), then the bias, activation and
    rounding of ``conv3_same_cf_plain``. The order of cuDNN's float32
    convolution.

    x: ``(B, ci, D, H, W)``; kernel ``(3, 3, 3, ci, co)`` and bias ``(co,)``
    (None: zero) are rounded to float32. ``planes``: the output z planes to
    compute (default all); ``sums``: ``fma_chain_sums`` of the same x,
    kernel and planes, where the caller has them. Returns ``(B, co,
    len(planes), H, W)`` float32. 27 ci float64 steps over the outputs: for
    the tests and the chip check, not a fast path.
    """
    B, co = x.shape[0], kernel.shape[-1]
    if sums is None:
        sums = fma_chain_sums(x, kernel, planes)
    if bias is None:
        bias = x.new_zeros(co, dtype=torch.float32)
    out = _epilogue(sums.reshape(B, co, -1), bias.to(torch.float32), act_slope, torch.float32,
                    round_conv_first)
    return out.view(sums.shape)


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

def block_width(co: int) -> int:
    """Output channels a block of the tensor-core kernel computes: the
    narrowest width that takes all of co, else the widest (several groups)."""
    return next((n for n in _WIDTHS if n >= co), _WIDTHS[-1])


def rows_per_warp(dtype, n: int) -> int:
    """Rows of 16 voxels each of a tile's warps owns by default (the
    kernel's rows_per_warp): the sums take rows * n / 2 registers a thread,
    twice that in float32 (the total and the tensor cores' part of 3 taps),
    beside the A fragments of the products in flight. A plan may take 1
    instead, where small volumes leave SMs without a tile."""
    if dtype == torch.bfloat16:
        return 4 if n <= 48 else 2
    return 4 if n <= 16 else 2 if n <= 64 else 1


def staging(ci: int, dtype, address: int = 0) -> str:
    """How the kernel stages an input of ``ci`` channels at ``address`` (as
    ``vxm_conv3_fwd`` decides it): "tma" where its channel rows are whole
    16-byte vectors, "cp.async" where they are whole 4-byte words, else
    "copies" (element by element), the first two only from a 16-byte
    aligned address."""
    row = ci * dtype.itemsize
    if address % 16:
        return "copies"
    return "tma" if row % 16 == 0 else "cp.async" if row % 4 == 0 else "copies"


def _align(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def smem_bytes(halo_voxels, n, nchunks, hstages, wstages, dtype, groups=1, teams=1) -> int:
    """Dynamic shared memory of a launch, as ``csrc/conv3.cu`` lays it out:
    for each of ``teams`` teams of consumer warps ``hstages`` halo tiles and
    ``wstages`` weight groups (0: all ``3 nchunks`` resident, shared), each
    1024-aligned, the epilogue's buffers (two a warp), the bias of ``groups`` blocks of
    ``n`` channels in f32, the mbarriers, and room to align the base."""
    nh, nw = teams * hstages, teams * wstages or 3 * nchunks
    return (nh * _align(halo_voxels * 32) + nw * _align(_PLANES[dtype] * n * 32)
            + _CONSUMER_WARPS * 2 * _FR * _OUT_STRIDE[dtype] + -(-groups * n * 4 // 16) * 16
            + (2 * nh + 2 * nw) * 8 + _ALIGN)


def _stages(halo_voxels, n, nchunks, groups, dtype, teams=1, stream=None):
    """A team's rings: every weight group resident where they fit (and co
    needs one group), else streamed through a ring of at least two groups
    (for two teams only where ``stream``, default for one team); as many
    stages as fit, up to 3. None where nothing fits."""
    stream = teams == 1 if stream is None else stream
    options = ([(hs, 0) for hs in (3, 2, 1)] if groups == 1 else []) + \
        ([(3, 3), (3, 2), (2, 2)] if stream else [])
    for hs, ws in options:
        if smem_bytes(halo_voxels, n, nchunks, hs, ws, dtype, groups, teams) <= _SMEM_LIMIT:
            return hs, ws
    return None


def _tiles(B, D, H, xf, groups, team_warps, mf, dtype, n, nchunks, stream):
    """Each tile shape of ``team_warps * mf`` rows that fits, with its rings:
    ``(tiles, halo voxels, (mf, n, tz, ty, txf, hstages, wstages,
    team_warps))``."""
    rows = team_warps * mf
    for tz in range(1, rows + 1):
        for ty in range(1, rows // tz + 1):
            if rows % (tz * ty):
                continue
            txf = rows // (tz * ty)
            if txf > xf or _FR * txf + 2 > 256:
                continue
            halo = (tz + 2) * (ty + 2) * (_FR * txf + 2)
            stages = _stages(halo, n, nchunks, groups, dtype, _CONSUMER_WARPS // team_warps,
                             stream)
            if stages is not None:
                tiles = B * -(-D // tz) * -(-H // ty) * -(-xf // txf) * groups
                yield tiles, halo, (mf, n, tz, ty, txf, *stages, team_warps)


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, ci: int, co: int, D: int, H: int, W: int, dtype, sms: int = _SMS,
              route: Optional[str] = None) -> tuple:
    """The tensor-core kernel's plan for a conv: ``(mf, n, tz, ty, txf,
    hstages, wstages, team_warps, blocks)``.

    A team of ``team_warps`` consumer warps computes ``n`` output channels
    (``block_width``) of a tile of ``tz x ty x 16 txf`` voxels, ``mf``
    rows of 16 x-voxels a warp. Where the weights stay resident and the
    input goes by TMA (``route``, default ``staging(ci, dtype)``), each of
    a block's two warpgroups is a team of 4 and they take its tiles in turn
    (one's epilogue under the other's products); else one team of 8 shares
    each tile and its weight loads. At ``rows_per_warp`` rows a warp, of the
    tile shapes the one whose tiles fill the fewest rounds of ``sms``
    persistent blocks' teams (one block per SM; ragged edge tiles
    included), then stages the fewest halo voxels, with its rings
    (``_stages``: ``wstages`` 0 keeps the weights resident). Where that
    leaves an SM without a tile (a small volume), the plan over 1 or
    ``rows_per_warp`` rows a warp and both teams (a team of 4 then also
    streaming its own weights) of the fewest rows a warp computes on the
    busiest SM (its tiles over its teams, times ``mf``), then the fewest
    weight loads there (streamed, one a tile; resident, one), then the most
    SMs with a tile, then the fewest halo voxels staged in all (on an
    H100, at 20x24x28, two teams of 4 each streaming the weights for a tile
    of their own were slower than one team of 8 on twice the rows, with
    120 tiles for 132 SMs). ``blocks`` is the persistent grid, one block
    per SM or one per tile.
    """
    n = block_width(co)
    groups = -(-co // n)
    mf = rows_per_warp(dtype, n)
    nchunks = -(-ci // _KC[dtype])
    xf = -(-W // _FR)
    tma = (route or staging(ci, dtype)) == "tma"
    shape = (B, D, H, xf, groups)
    plan = None
    for team_warps in ((4, 8) if tma and groups == 1 else (8,)):
        teams = _CONSUMER_WARPS // team_warps
        options = list(_tiles(*shape, team_warps, mf, dtype, n, nchunks, None))
        if options:
            tiles, _halo, plan = min(options, key=lambda o: (-(-o[0] // (teams * sms)), o[1]))
            break
    if plan is None or tiles < sms:
        options = [o for team_warps in ((4, 8) if tma else (8,)) for m in dict.fromkeys((mf, 1))
                   for o in _tiles(*shape, team_warps, m, dtype, n, nchunks, True)]
        if not options:
            raise ValueError(f"no tile of the conv3 kernel fits {ci} -> {co} channels in "
                             f"{dtype}")
        def cost(option):
            tiles, halo, (mf, *_, wstages, team_warps) = option
            per_sm = -(-tiles // sms)
            return (-(-per_sm * team_warps // _CONSUMER_WARPS) * mf,
                    per_sm if wstages else 1, -min(tiles, sms), tiles * halo)
        tiles, _halo, plan = min(options, key=cost)
    return (*plan, min(tiles, sms))


def fma_smem_bytes(ct: int, n: int, tz: int, ty: int, kc: int, stages: int,
                   tma: bool = False, fx: int = 32) -> int:
    """Dynamic shared memory of the CUDA-core kernel's launch, as
    ``csrc/conv3.cu`` lays it out: ``stages`` stages of ``kc`` channel planes
    of the halo tile (each padded so that the planes fall 32 / kc banks
    apart) and the chunk's weights for ``n`` output channels, 128-aligned;
    where the input comes by TMA (``tma``), a landing buffer of the halo
    tile's kc channels (room for ``fx`` + 4 voxels a row, as rows of 2
    channels take); then the mbarriers."""
    plane = (tz + 2) * (ty + 2) * _F_ROW
    cs = plane + (32 // kc % 32 - plane) % 32
    stage = -(-(kc * cs * 4 + kc * n * 27 * 4) // 128) * 128
    land = -(-((tz + 2) * (ty + 2) * (fx + 4) * kc * 4) // 128) * 128 if tma else 0
    return stages * stage + land + (2 * stages + 2) * 8


def _fma_options(B, ci, co, D, H, W):
    """Each plan of the CUDA-core kernel that fits: for each lane width and
    tile width FX, a tile of every output channel (up to ``_F_MAX_N`` and 8
    warps of CT) and FX x (32 VX / FX) sy x VZ sz voxels for each sy x sz
    slabs the warps allow, with the most stages that fit. Yields ``(ct, n,
    fx, tz, ty, stages, kc, tiles, warps)``."""
    kc = min(4, 1 << (ci - 1).bit_length())
    # the input by TMA: whole 16-byte channel rows, or 2 channels in rows of
    # whole 16-byte runs
    tma = ci % 4 == 0 or (ci == 2 and W % 2 == 0)
    for ct, (vz, vx) in _F_LANE.items():
        n = min(-(-co // ct) * ct, _F_MAX_N, _F_WARPS * ct)
        g = n // ct
        groups = -(-co // n)
        for fx, slabs in itertools.product(_F_WIDTHS[ct], range(1, _F_WARPS // g + 1)):
            for sy in range(1, slabs + 1):
                if slabs % sy:
                    continue
                ty, tz = 32 * vx // fx * sy, vz * (slabs // sy)
                stages = next((st for st in (4, 3, 2) if fma_smem_bytes(
                    ct, n, tz, ty, kc, st, tma, fx) <= _SMEM_LIMIT), None)
                if stages is None:
                    continue
                tiles = B * -(-D // tz) * -(-H // ty) * -(-W // fx) * groups
                yield ct, n, fx, tz, ty, stages, kc, tiles, g * slabs


@functools.lru_cache(maxsize=None)
def fma_plan(B: int, ci: int, co: int, D: int, H: int, W: int, sms: int = _SMS) -> tuple:
    """The CUDA-core kernel's plan for a float32 forward: ``(ct, n, tz, ty,
    fx / 16, stages, kc, 0, blocks)``, the arguments ``vxm_conv3_fwd`` takes
    in the slots of the tensor-core plan.

    A tile is fx x ty x tz voxels (fx 32, or 16 at 8 channels a lane) with
    ``n`` output channels (every one of the conv up to 64; more in groups),
    ``ct`` of them a consumer warp (8, each lane 8 x 2 voxels, or 4 with 4 x
    1), ``kc`` input channels a stage in a ring of ``stages``. Of the tile
    shapes, the one of least estimated
    time on ``sms`` persistent blocks (one per SM): the rounds of tiles
    times a tile's FMAs a warp, times the warps an SM scheduler holds
    (one or two; one hides load latency less: taken as 0.7 of its issue
    slots against 0.9), over the share of FMAs in the warp's instructions
    (the loads: 12 for 384 FMAs at ct 8, 5 for 48 at 4), the narrow warps
    at 0.8 of that again (twice the warps read each staged row, which puts
    shared memory near its rate; an estimate) and tiles 16 wide at 0.95
    (their rows' 16-byte loads meet in a bank in half the quarter-warps);
    then the fewest halo voxels staged in all, then the most warps a block.
    Small volumes take the narrow warps and small tiles, so that more SMs
    have one; widths of 112 and 56 tiles 16 wide, which fit them.
    """
    best = None
    for ct, n, fx, tz, ty, stages, kc, tiles, warps in _fma_options(B, ci, co, D, H, W):
        vz, vx = _F_LANE[ct]
        per_scheduler = -(-warps // 4)
        issue = 0.9 if per_scheduler >= 2 else 0.7
        fma_share = (384 / 396 if ct == 8 else 0.8 * 48 / 53) * (0.95 if fx == 16 else 1.0)
        cost = -(-tiles // sms) * 27 * ci * vx * vz * ct * per_scheduler / (issue * fma_share)
        halo = tiles * (tz + 2) * (ty + 2) * (fx + 2)
        key = (cost, halo, -warps)
        if best is None or key < best[0]:
            best = key, (ct, n, tz, ty, fx // 16, stages, kc, 0, min(tiles, sms))
    if best is None:
        raise ValueError(f"no tile of the float32 CUDA-core kernel fits {ci} -> {co} channels")
    return best[1]


def _fma_weights(kernel: torch.Tensor, ct: int, n: int, kc: int) -> torch.Tensor:
    """kernel ``(3, 3, 3, ci, co)`` in float32 laid out as the CUDA-core
    kernel's stages read it: for each group of ``n`` output channels and
    each chunk of ``kc`` input channels, ``[kc][n / ct][27 taps][ct]``, zero
    past ci and co."""
    ci, co = kernel.shape[3:]
    groups, nchunks = -(-co // n), -(-ci // kc)
    w = F.pad(kernel.to(torch.float32).reshape(27, ci, co),
              (0, groups * n - co, 0, nchunks * kc - ci))
    w = w.reshape(27, nchunks, kc, groups, n // ct, ct).permute(3, 1, 2, 4, 0, 5)
    return w.contiguous()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel's cvt.rna.tf32.f32; t finite."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tensor_core_weights(kernel: torch.Tensor, dtype, n: int) -> torch.Tensor:
    """kernel ``(3, 3, 3, ci, co)`` laid out as the tensor-core kernel loads
    it: rows of KC input channels, zero past ci and past co (up to whole
    blocks of ``n``), ``[chunk][dz][dy dx][co][KC]``; float32 as its 3xTF32
    split, ``[chunk][dz][big, small][dy dx][co][KC]``."""
    ci, co = kernel.shape[3:]
    kc = _KC[dtype]
    nchunks, width = -(-ci // kc), -(-co // n) * n
    w = F.pad(kernel.to(dtype).reshape(27, ci, co), (0, width - co, 0, nchunks * kc - ci))
    w = w.reshape(3, 9, nchunks, kc, width).permute(2, 0, 1, 4, 3)
    if dtype == torch.float32:
        big = _tf32(w.contiguous())
        w = torch.stack([big, _tf32(w - big)], 2)
    return w.contiguous()


def _kernel_args(x, kernel, bias, act_slope, round_conv_first, plan=None, f32_fma=False):
    """The arguments of ``vxm_conv3_fwd`` (``csrc/conv3.cu``) but the stream.

    x: ``(B, ci, D, H, W)``, channels-last in memory; kernel ``(3, 3, 3, ci,
    co)`` and bias ``(co,)`` (None: no bias) are rounded to x's dtype, the
    kernel laid out for the route taken. ``plan`` is the tensor-core plan
    (default ``tile_plan`` for x's card); ``f32_fma`` runs float32 on the
    CUDA cores in cuDNN's order instead, ``plan`` then the CUDA-core plan
    (default ``fma_plan``). Returns ``(y, operands, args)``: the output to
    be written (channels-last), the tensors that ``args``' pointers point
    into, to be kept alive until the kernel has run, and the arguments.
    """
    B, ci, D, H, W = x.shape
    co = kernel.shape[-1]
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else _SMS)
    if f32_fma:
        plan = plan or fma_plan(B, ci, co, D, H, W, sms)
        w = _fma_weights(kernel, plan[0], plan[1], plan[6])
    else:
        plan = plan or tile_plan(B, ci, co, D, H, W, x.dtype, sms,
                                 staging(ci, x.dtype, x.data_ptr()))
        w = _tensor_core_weights(kernel, x.dtype, plan[1])
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
    [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _conv3_cuda(x, kernel, bias, act_slope, out_dtype, round_conv_first, forward):
    """Launch ``csrc/conv3.cu`` on the current stream; raises if the build or
    the launch fails. x is channels-last in memory. A float32 ``forward``
    runs on the CUDA cores in cuDNN's order (see ``_conv3``), counted also on
    ``conv3_same_cf.f32_fma_launches``."""
    if x.dtype not in _DTYPES or out_dtype != x.dtype:
        raise TypeError(f"the conv3 kernel takes float32 or bfloat16 and returns the "
                        f"input's dtype; got {x.dtype} -> {out_dtype}")
    f32_fma = forward and x.dtype == torch.float32
    y, _operands, args = _kernel_args(x, kernel, bias, act_slope, round_conv_first,
                                      f32_fma=f32_fma)
    fn = _build.entry_point("conv3", "vxm_conv3_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vxm_conv3_fwd CUDA kernel failed to launch: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, co={kernel.shape[-1]}, {x.dtype}, "
                           f"plan {args[-9:]})")
    conv3_same_cf.launches += 1
    conv3_same_cf.f32_fma_launches += f32_fma
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
    of cuDNN's float32 convolution, bit for bit (``conv3_fma_chain``), in
    persistent warp-specialised blocks that hold every output channel of a
    tile (``fma_plan``): its outputs decide the
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
    ``conv3_same_cf.launches`` counts kernel launches (of them,
    ``conv3_same_cf.f32_fma_launches`` the float32 forward's, on the CUDA
    cores) and ``conv3_same_cf.layout_copies`` the layout copies.
    """
    _check(x, kernel, bias)
    out = _Conv3Block.apply(x, kernel.to(x.dtype), bias.to(x.dtype), act_slope,
                            bool(round_conv_first))
    return out if out_dtype is None else out.to(out_dtype)


conv3_same_cf.launches = 0
conv3_same_cf.f32_fma_launches = 0
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
