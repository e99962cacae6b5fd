"""The port's CUDA kernels run on the CPU, against their plain versions.

``csrc/warp_bounded.cu`` and ``csrc/conv3.cu`` are compiled with the host's
C++ compiler against stand-ins for ``<cuda_runtime.h>``, ``<cuda.h>``,
``<cuda_bf16.h>``, ``<cuda_pipeline_primitives.h>`` and the helpers of
``csrc/tensor_core.cuh`` and ``csrc/hopper.cuh`` (``tests/cuda_emulation/``)
that run each block's threads as ``std::thread``s with a barrier for
``__syncthreads()``, give each thread its lane's part of a tensor-core
product (wgmma, its B read through the descriptor and the 32-byte
swizzle), make mbarriers blocking objects, a TMA load an immediate copy of
its box (zeros outside the tensor) and ``cp.async`` a plain copy. The
kernels then run through
their C entry points on CPU tensors, at shapes that leave ragged edge tiles
in every direction. The bounded-warp forward and backward must equal
``windowed_transform`` and ``warp_bounded_bwd_plain`` bit for bit: they add
the same terms in the same order with the same roundings. The conv kernel
sums its products in another order than the plain version's matrix product
(and in float32 splits them into TF32 parts), so it is held within
``conv3.kernel_tolerance``, at several of its plans: both staging routes
of the input (TMA and the producer's own copies), resident and streamed
weights, block widths up to 128 and blocks that walk several tiles; its
float32 forward, one chain of FMAs an output in cuDNN's order, must also
equal ``conv3.conv3_fma_chain`` bit for bit, at plans of its own. This checks the
kernels' indexing and arithmetic where there is no GPU; the GPU build and
launch are checked by ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import bounded_case
from voxelmorph_tpu_torch import _build
from voxelmorph_tpu_torch.ops import conv3
from voxelmorph_tpu_torch.ops import warp_bounded as warp_bounded_ops
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded_bwd_plain, windowed_transform

SHIM = Path(__file__).resolve().parent / "cuda_emulation"
# (batch, spatial, channels, halo): several blocks along x and y, with
# partial tiles at the far edges. At these sizes the kernels march along z
# in runs of the fewest planes they take (4 for the forward at halo 1 and
# for the backward, 8 for the forward at larger halos): D shorter than one
# run (7, 6, 3 planes, the last fewer than the halo), and D of several runs
# with a ragged last one (20 = 8 + 8 + 4, 19 = 4 * 4 + 3, 17, 18, 9, 5, 6).
# W is not a multiple of 4 voxels in most cases, so that rows of W * C
# floats differ in alignment (C = 1, 3: part 16-byte and part 4-byte
# copies, C = 2 with W even and C = 4: 16-byte copies), at every C and halo
# in [1, 4].
CASES = [(1, (5, 9, 40), 1, 1), (2, (6, 10, 35), 3, 1), (1, (7, 9, 33), 2, 2),
         (1, (6, 8, 34), 4, 3), (1, (9, 17, 20), 3, 4),
         (1, (20, 9, 37), 1, 2), (1, (19, 10, 34), 2, 1), (2, (17, 7, 35), 3, 3),
         (1, (18, 9, 33), 4, 4), (1, (19, 11, 38), 3, 2), (1, (3, 9, 35), 2, 4),
         (1, (17, 6, 33), 1, 3)]


def _compile(tmp_path_factory, name, shared, launches, defines=()):
    """Build ``csrc/<name>.cu`` for the CPU: its dynamic shared arrays
    ``shared`` become pointers to the stand-in's buffer and its
    ``launches`` kernel launches calls of ``emu_launch``; ``defines`` are
    macros ("NAME=VALUE") set on the compiler's command line."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CUDA source for the CPU")
    src = _build.SOURCES[name].read_text()
    for array in shared:
        src = re.sub(rf"extern __shared__ (?:__align__\(\d+\) )?(\w[\w ]*) {array}\[\];",
                     rf"\1* {array} = reinterpret_cast<\1*>(emu_shared_memory);", src)
    src = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<grid, block, \w+, stream>>>\(",
                 r"emu_launch(grid, block, \1, ", src)
    assert src.count("emu_launch(") == launches and "__shared__" not in src
    # a csrc/ header is included by name, and the stand-in of the same name
    # is found on the include path: the source is compiled away from csrc/
    for header in re.findall(r'#include "(\w+\.cuh)"', src):
        assert (SHIM / header).is_file() and (_build.SOURCES[name].parent / header).is_file()
    out = tmp_path_factory.mktemp("emulation")
    (out / f"{name}.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", *(f"-D{d}" for d in defines), "-I", str(SHIM),
                    "-o", str(out / f"lib{name}.so"),
                    str(out / f"{name}.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(out / f"lib{name}.so"))


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    return _compile(tmp_path_factory, "warp_bounded", ["tile"], 2)


@pytest.fixture(scope="module")
def conv_kernel(tmp_path_factory):
    lib = _compile(tmp_path_factory, "conv3", ["smem_raw", "fsmem"], 2)
    fn = lib.vxm_conv3_fwd
    fn.argtypes = conv3._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _call(lib, name, *args):
    """Call the entry point ``name`` with ``args`` (the stream last) and no
    tier word: an unconditional launch, counted nowhere."""
    fn = getattr(lib, name)
    fn.argtypes = warp_bounded_ops._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn(*args[:-1], None, 0, None, args[-1])


def _case(batch, spatial, nch, halo):
    vol, shift = (torch.from_numpy(a) for a in bounded_case(
        nch * 10 + halo, spatial, nch, halo, batch=batch))
    g = torch.from_numpy(np.random.default_rng(halo).normal(size=vol.shape).astype(np.float32))
    return vol, shift, g


@pytest.mark.parametrize("batch,spatial,nch,halo", CASES)
def test_forward_kernel_equals_plain(kernels, batch, spatial, nch, halo):
    vol, shift, _ = _case(batch, spatial, nch, halo)
    out = torch.full_like(vol, float("nan"))
    assert _call(kernels, "vxm_warp_bounded_fwd", vol.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), batch, *spatial, nch, halo, None) == 0
    assert torch.equal(out, windowed_transform(vol, shift, halo))


@pytest.mark.parametrize("batch,spatial,nch,halo", CASES)
def test_backward_kernel_equals_plain(kernels, batch, spatial, nch, halo):
    vol, shift, g = _case(batch, spatial, nch, halo)
    dvol = torch.full_like(vol, float("nan"))
    dshift = torch.full_like(shift, float("nan"))
    assert _call(kernels, "vxm_warp_bounded_bwd", vol.data_ptr(), shift.data_ptr(),
                 g.data_ptr(), dvol.data_ptr(), dshift.data_ptr(), batch, *spatial, nch,
                 halo, None) == 0
    ref_vol, ref_shift = warp_bounded_bwd_plain(vol, shift, g, halo)
    assert ref_vol.abs().max() > 1 and ref_shift.abs().max() > 1
    assert torch.equal(dvol, ref_vol)
    assert torch.equal(dshift, ref_shift)


@pytest.mark.parametrize("nch,halo", [(5, 1), (4, 8), (0, 1), (1, 5), (1, 0)])
def test_entry_points_refuse_what_they_cannot_run(kernels, nch, halo):
    """Channels or a halo outside [1, 4], the wrapper's range: refused by
    the entry points' own check, whatever shared memory a tile would take."""
    buf = torch.zeros(4096)
    p = buf.data_ptr()
    assert _call(kernels, "vxm_warp_bounded_fwd", p, p, p, 1, 4, 4, 4, nch, halo, None) != 0
    assert _call(kernels, "vxm_warp_bounded_bwd", p, p, p, p, p, 1, 4, 4, 4, nch, halo,
                 None) != 0


@pytest.mark.parametrize("nch,halo", [(2, 1), (4, 2), (3, 1)])
def test_kernels_take_tensors_at_any_float_offset(kernels, nch, halo):
    """Inputs and outputs one float past a 16-byte boundary (views into a
    larger buffer): the row copies fall back to 4 bytes and the results
    stay bit-equal to the plain versions."""
    vol, shift, g = _case(1, (10, 9, 36), nch, halo)

    def shifted(t):
        buf = torch.full((t.numel() + 1,), float("nan"))
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view

    vol, shift, g = shifted(vol), shifted(shift), shifted(g)
    out, dvol, dshift = shifted(torch.zeros_like(vol)), shifted(vol * 0), shifted(shift * 0)
    assert _call(kernels, "vxm_warp_bounded_fwd", vol.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), 1, 10, 9, 36, nch, halo, None) == 0
    assert torch.equal(out, windowed_transform(vol, shift, halo))
    assert _call(kernels, "vxm_warp_bounded_bwd", vol.data_ptr(), shift.data_ptr(),
                 g.data_ptr(), dvol.data_ptr(), dshift.data_ptr(), 1, 10, 9, 36, nch,
                 halo, None) == 0
    ref_vol, ref_shift = warp_bounded_bwd_plain(vol, shift, g, halo)
    assert torch.equal(dvol, ref_vol) and torch.equal(dshift, ref_shift)


# (batch, ci, co, D, H, W, layout, tile, fma): ragged tiles along x, y
# and z; ci and co not multiples of the staged chunk (16 bf16, 8 f32) or of
# a block width; input channel rows that are whole 16-byte vectors (TMA)
# and ones that are not (the producer's copies: ci 2, 3, 10, and 10 or 12
# as the input gradient's); block widths 16, 32, 48 (32 + 16), 64, and 128
# (the input gradient of 128 -> 64, and the forward of 8 -> 72);
# channels-last inputs and NCDHW ones (one layout copy). tile, the
# tensor-core plan: "auto" is tile_plan's for
# an H100's 132 SMs, which at these small volumes takes 1 row a warp; a
# dict overrides it: "sms" the SMs the plan is made for (a few: the rows a
# warp owns at full width), "team" the warps of a team (4 or 8), "shape"
# (tz, ty) of the tile (txf what the rows leave), "weights" "resident" or
# "streamed" (the most stages that fit), "blocks" the persistent grid
# (fewer blocks than tiles: a block walks several). fma, the float32
# forward's CUDA-core plan: "auto" is fma_plan's for 132 SMs; a dict
# overrides it: "ct" the output channels of a warp (8 or 4; "n" those of
# a tile, default every channel up to 64 and 8 warps; "fx" the tile's width,
# 32 or, at 8 channels, 16), "shape" (ty, tz),
# "kc" input channels a stage, "stages" of the ring (default the most that
# fit), "blocks" the persistent grid.
CONV_CASES = [pytest.param(*case, id="-".join(map(str, case[:7]))) for case in [
    (1, 10, 20, 5, 9, 33, "cl", "auto", "auto"),
    (2, 3, 4, 6, 10, 35, "ncdhw", "auto", {"ct": 8, "shape": (8, 2), "kc": 8, "stages": 3}),
    (1, 16, 10, 7, 9, 34, "cl", {"sms": 4, "blocks": 2},
     {"ct": 8, "shape": (8, 4), "kc": 1, "blocks": 2}),
    (1, 2, 16, 5, 7, 37, "cl", {"shape": (2, 2)},
     {"ct": 8, "shape": (16, 4), "stages": 2, "blocks": 1}),
    (1, 24, 40, 3, 5, 40, "ncdhw", {"shape": (1, 4), "weights": "streamed"},
     {"ct": 8, "fx": 16}),
    (2, 32, 17, 4, 3, 18, "cl", {"shape": (2, 2), "blocks": 3}, {"ct": 4, "blocks": 3}),
    (1, 48, 64, 3, 4, 16, "cl", {"sms": 1, "team": 8, "weights": "streamed", "blocks": 1},
     {"ct": 8}),
    (1, 12, 20, 9, 17, 40, "cl", {"sms": 8, "weights": "resident"},
     {"ct": 8, "shape": (16, 2), "blocks": 5}),
    # SynthMorph's 64-wide U-Net: the decoder's skip concat (ci 128, its
    # input gradient 128 wide) and the first block (ci 2)
    (1, 128, 64, 5, 6, 9, "cl", "auto", {"ct": 8}),
    (1, 2, 64, 6, 5, 11, "cl", {"weights": "streamed"}, {"ct": 4, "n": 32, "blocks": 4}),
    # more output channels than a CUDA-core tile takes: groups of 64
    (1, 8, 72, 4, 5, 20, "cl", "auto", {"ct": 8, "blocks": 2}),
    # 2 input channels in rows of whole 16-byte runs (W even): the
    # CUDA-core kernel's input by TMA along the rows
    (1, 2, 16, 4, 6, 30, "cl", "auto", {"ct": 8, "fx": 16, "blocks": 2})]]

_WEIGHTS = {"resident": [(hs, 0) for hs in (3, 2, 1)],
            "streamed": [(3, 3), (3, 2), (2, 2)]}


def _fma_plan(fma, batch, ci, co, D, H, W):
    """The float32 forward's CUDA-core plan of a case: fma_plan's, with the
    case's overrides."""
    if fma == "auto":
        return conv3.fma_plan(batch, ci, co, D, H, W)
    ct, n, tz, ty, txf, stages, kc, _, blocks = conv3.fma_plan(batch, ci, co, D, H, W,
                                                               fma.get("sms", 132))
    if "ct" in fma:
        ct = fma["ct"]
        n = fma.get("n", min(-(-co // ct) * ct, 64, 8 * ct))
        txf = fma.get("fx", 32) // 16
        vz, vx = conv3._F_LANE[ct]
        ty, tz = fma.get("shape", (2 * vx // txf, vz))
    kc = fma.get("kc", kc)
    tma = ci % 4 == 0 and kc % 4 == 0 or ci == kc == 2 and W % 2 == 0
    stages = fma.get("stages") or next(
        st for st in (4, 3, 2)
        if conv3.fma_smem_bytes(ct, n, tz, ty, kc, st, tma, 16 * txf) <= conv3._SMEM_LIMIT)
    tiles = batch * -(-D // tz) * -(-H // ty) * -(-W // (16 * txf)) * -(-co // n)
    return ct, n, tz, ty, txf, stages, kc, 0, fma.get("blocks", min(tiles, 132))


def _plan(tile, fma, batch, ci, co, D, H, W, dtype, f32_fma):
    """The plan of a case: the CUDA-core plan, or the tensor-core plan for
    a conv of ci -> co channels, tile_plan's with the case's overrides."""
    if f32_fma:
        return _fma_plan(fma, batch, ci, co, D, H, W)
    if tile == "auto":
        return conv3.tile_plan(batch, ci, co, D, H, W, dtype)
    plan = list(conv3.tile_plan(batch, ci, co, D, H, W, dtype, tile.get("sms", 132)))
    mf, n = plan[:2]
    team_warps = plan[7] = tile.get("team", plan[7])
    if "shape" in tile or "team" in tile:
        tz, ty = tile.get("shape", (2, 2))
        plan[2:5] = [tz, ty, team_warps * mf // (tz * ty)]
    tz, ty, txf = plan[2:5]
    halo = (tz + 2) * (ty + 2) * (16 * txf + 2)
    nchunks = -(-ci // conv3._KC[dtype])
    groups, teams = -(-co // n), 8 // team_warps
    if "weights" in tile:
        plan[5:7] = next(stages for stages in _WEIGHTS[tile["weights"]] if conv3.smem_bytes(
            halo, n, nchunks, *stages, dtype, groups, teams) <= conv3._SMEM_LIMIT)
    elif "shape" in tile or "team" in tile:
        plan[5:7] = conv3._stages(halo, n, nchunks, groups, dtype, teams, stream=True)
    tiles = batch * -(-D // tz) * -(-H // ty) * -(-W // (16 * txf)) * groups
    plan[8] = tile.get("blocks", min(tiles, 132))
    return tuple(plan)


def _conv_launch(fn, x, kernel, bias, act_slope, round_conv_first, plan, forward):
    """The wrapper's launch of ``vxm_conv3_fwd`` (``ops/conv3.py``), on the
    CPU: x laid out channels-last as the wrapper does, then the kernel (a
    float32 forward on the CUDA cores, the rest on the tensor cores)."""
    x = conv3._channels_last(x)
    y, _operands, args = conv3._kernel_args(x, kernel, bias, act_slope, round_conv_first, plan,
                                            forward and x.dtype == torch.float32)
    y.fill_(float("nan"))
    assert fn(*args, None) == 0
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("orientation", ["forward", "dx"])
@pytest.mark.parametrize("batch,ci,co,D,H,W,layout,tile,fma", CONV_CASES)
def test_conv_kernel_within_tolerance_of_plain(conv_kernel, batch, ci, co, D, H, W, layout,
                                               tile, fma, orientation, dtype):
    """The forward (bias, LeakyReLU, each rounding order) and the dx
    orientation (taps flipped, ci and co swapped, no bias or activation);
    float32's forward is the CUDA-core kernel, which must also equal
    conv3_fma_chain (cuDNN's order of FMAs) bit for bit, its dx the 3xTF32
    one."""
    rng = np.random.default_rng(ci * co + D)
    kernel = torch.from_numpy((rng.normal(size=(3, 3, 3, ci, co)) * 0.3).astype(np.float32))
    if orientation == "forward":
        x = rng.normal(size=(batch, ci, D, H, W))
        bias = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32))
        settings = [(0.2, False), (0.2, True), (None, False)]
    else:  # a cotangent of co channels through the flipped, transposed kernel
        x = rng.normal(size=(batch, co, D, H, W))
        kernel = kernel.flip(0, 1, 2).transpose(3, 4)
        bias = torch.zeros(ci)
        settings = [(None, False)]
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    if layout == "cl":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    f32_fma = orientation == "forward" and dtype == torch.float32
    plan = _plan(tile, fma, batch, *kernel.shape[3:], D, H, W, dtype, f32_fma)
    sums = None  # the FMA chains of the float32 forward, for every setting
    for act_slope, round_first in settings:
        copies = conv3.conv3_same_cf.layout_copies
        # the wrapper passes no bias for dx
        kernel_bias = bias if orientation == "forward" else None
        forward = orientation == "forward"
        y = _conv_launch(conv_kernel, x, kernel, kernel_bias, act_slope, round_first, plan,
                         forward)
        assert conv3.conv3_same_cf.layout_copies - copies == (layout != "cl")
        plain = conv3.conv3_same_cf_plain(x, kernel, bias, act_slope, None, round_first)
        assert y.dtype == plain.dtype == dtype
        assert plain.float().abs().max() > 1
        err = (y.float() - plain.float()).abs()
        tol = conv3.kernel_tolerance(plain, bias, round_first)
        assert (err <= tol).all(), (act_slope, round_first, err.max().item())
        if f32_fma:
            sums = conv3.fma_chain_sums(x, kernel) if sums is None else sums
            chain = conv3.conv3_fma_chain(x, kernel, bias, act_slope, round_first, sums=sums)
            assert torch.equal(y, chain), (act_slope, round_first, (y != chain).sum().item())
        if dtype == torch.bfloat16:
            # the sums differ by ~1e-6 of the terms, which rarely flips a bf16
            # rounding; the other rounding order differs in about a third
            assert (y == plain).float().mean() >= 0.99, (act_slope, round_first)
        # two launches give the same bits
        assert torch.equal(y, _conv_launch(conv_kernel, x, kernel, kernel_bias, act_slope,
                                           round_first, plan, forward))


def test_conv_cases_cover_the_kernel_routes():
    """CONV_CASES reach every route of the tensor-core kernel: the three
    stagings of the input (``conv3.staging``), resident and streamed weights
    in teams of one warpgroup and of both, each block width the U-Nets use
    (48 composed of two products), 1 row a warp and the full-width rows,
    blocks that walk several tiles, and a partial tile in every
    direction."""
    seen = set()
    for param in CONV_CASES:
        batch, ci, co, D, H, W, _layout, tile, fma = param.values
        for c_in, c_out in ((ci, co), (co, ci)):
            for dtype in (torch.bfloat16, torch.float32):
                mf, n, tz, ty, txf, hs, ws, team_warps, blocks = _plan(
                    tile, fma, batch, c_in, c_out, D, H, W, dtype, False)
                tiles = batch * -(-D // tz) * -(-H // ty) * -(-W // (16 * txf)) * -(-c_out // n)
                seen |= {conv3.staging(c_in, dtype), f"n{n}",
                         f"team{team_warps}-{'resident' if ws == 0 else 'streamed'}",
                         "mf1" if mf == 1 else f"mf{mf}-{str(dtype)[6:]}"}
                seen |= {"walks"} if blocks < tiles else set()
                seen |= {axis for axis, size, step in (("z", D, tz), ("y", H, ty),
                                                       ("x", W, 16 * txf)) if size % step}
    assert {"tma", "cp.async", "copies", "n16", "n32", "n48", "n64", "n128", "team4-resident",
            "team4-streamed", "team8-resident", "team8-streamed", "mf1", "mf4-bfloat16",
            "mf2-bfloat16", "mf4-float32", "mf2-float32", "walks", "z", "y", "x"} <= seen, seen


def test_conv_cases_cover_the_fma_routes():
    """CONV_CASES reach every route of the float32 CUDA-core kernel: the
    input by TMA (whole 16-byte channel rows, stages of 4 or 8 channels;
    or 2 channels in rows of whole 16-byte runs) and by cp.async, both
    warp widths (8 output channels, 8 x 2 voxels a lane; 4 channels, 4 x
    1), tiles 32 and 16 wide, 1 to 8 channel warps (3 and 5 too) and of
    slabs, stages of 1,
    2, 4 and 8 input channels with a partial last one, rings of 2 to 4
    stages that wrap, blocks that walk several tiles, several groups of
    output channels, channels past co in a tile, and a partial tile in
    every direction."""
    seen = set()
    for param in CONV_CASES:
        batch, ci, co, D, H, W, _layout, tile, fma = param.values
        ct, n, tz, ty, txf, stages, kc, _, blocks = _plan(tile, fma, batch, ci, co, D, H, W,
                                                          torch.float32, True)
        vz, vx = conv3._F_LANE[ct]
        fx = 16 * txf
        tiles = batch * -(-D // tz) * -(-H // ty) * -(-W // fx) * -(-co // n)
        chunks = -(-ci // kc)
        route = ("tma" if ci % 4 == 0 and kc % 4 == 0 else
                 "tma rows" if ci == kc == 2 and W % 2 == 0 else "cp.async")
        seen |= {f"ct{ct}", f"fx{fx}", f"g{n // ct}", f"slabs{ty // (32 * vx // fx) * tz // vz}",
                 f"kc{kc}", f"stages{stages}", route}
        seen |= {"partial chunk"} if ci % kc else set()
        seen |= {"ring wraps"} if -(-tiles // blocks) * chunks > stages else set()
        seen |= {"walks"} if blocks < tiles else set()
        seen |= {"groups"} if co > n else set()
        seen |= {"past co"} if -(-co // n) * n > co else set()
        seen |= {axis for axis, size, step in (("z", D, tz), ("y", H, ty), ("x", W, fx))
                 if size % step}
    assert {"tma", "tma rows", "cp.async", "ct8", "ct4", "fx32", "fx16", "g1", "g2", "g3",
            "g5", "g8",
            "slabs1", "slabs2", "slabs4",
            "kc1", "kc2", "kc4", "kc8", "stages2", "stages3", "stages4", "partial chunk",
            "ring wraps", "walks", "groups", "past co", "z", "y", "x"} <= seen, seen


@pytest.mark.parametrize("change", [dict(n=80), dict(tz=3), dict(mf=2), dict(bf16=2),
                                    dict(ci=0), dict(hstages=5), dict(wstages=5),
                                    dict(blocks=0), dict(f32_fma=2), dict(f32_fma=1),
                                    dict(team_warps=6), dict(team_warps=4, wstages=1),
                                    dict(wstages=1), dict(n=96)])
def test_conv_entry_point_refuses_what_it_cannot_run(conv_kernel, change):
    """A block width the kernel has no instantiation of (80, 96), a tile
    whose rows do not match the warps', rows a warp does not own at that
    width (2 at 16 float32 channels: 4 or 1), an unknown dtype, no
    channels, too many stages, no blocks, an unknown route, the CUDA-core
    route given a tensor-core plan, a team that is not a warpgroup or both,
    a ring of one streamed weight group (for one team or two), which would
    hold the group a warp still reads while it waits for the next."""
    x = torch.zeros((1, 4, 4, 4, 16)).movedim(-1, 1)
    plan = conv3.tile_plan(1, 16, 16, 4, 4, 4, torch.float32)
    y, _operands, args = conv3._kernel_args(x, torch.zeros((3, 3, 3, 16, 16)),
                                            torch.zeros(16), 0.2, False, plan)
    names = ["x", "w", "bias", "y", "B", "ci", "co", "D", "H", "W", "bf16", "has_act",
             "slope", "round_first", "f32_fma", "mf", "n", "tz", "ty", "txf", "hstages",
             "wstages", "team_warps", "blocks"]
    args = list(args)
    assert conv_kernel(*args, None) == 0
    for key, value in change.items():
        args[names.index(key)] = value
    assert conv_kernel(*args, None) != 0


@pytest.mark.parametrize("change", [dict(mf=16), dict(mf=0), dict(n=20), dict(ty=6),
                                    dict(tz=3), dict(ty=16, tz=4), dict(hstages=1),
                                    dict(hstages=5), dict(wstages=3), dict(txf=3),
                                    dict(txf=0), dict(mf=4, txf=1),
                                    dict(team_warps=8), dict(blocks=0),
                                    dict(n=16, ty=32, wstages=8, hstages=4)])
def test_conv_entry_point_refuses_what_the_cuda_cores_cannot_run(conv_kernel, change):
    """The float32 forward's CUDA-core route given a plan it has no kernel
    for: a warp of other than 8 or 4 output channels, a tile of channels
    that warps of 8 do not fill, rows that are not whole warps' (8 a warp)
    or planes not whole lanes' (2 at 8 channels), more than 8 consumer
    warps (32 channels in 2 x 2 slabs), a ring of one stage or of more than
    4, stages of 3 input channels (1, 2, 4 or 8: a lane's share of a warp's
    copies), tiles other than 32 or 16 wide (16 only at 8 channels a lane),
    a tensor-core plan's team, no blocks, and a ring larger
    than shared memory (4 stages of 8 channels of a 32 x 32 x 2 tile)."""
    x = torch.zeros((1, 4, 4, 4, 16)).movedim(-1, 1)
    kernel = torch.zeros((3, 3, 3, 16, 32))
    plan = (8, 32, 2, 8, 2, 2, 4, 0, 1)
    y, _operands, args = conv3._kernel_args(x, kernel, torch.zeros(32), 0.2, False, plan,
                                            f32_fma=True)
    names = ["x", "w", "bias", "y", "B", "ci", "co", "D", "H", "W", "bf16", "has_act",
             "slope", "round_first", "f32_fma", "mf", "n", "tz", "ty", "txf", "hstages",
             "wstages", "team_warps", "blocks"]
    args = list(args)
    assert conv_kernel(*args, None) == 0
    for key, value in change.items():
        args[names.index(key)] = value
    assert conv_kernel(*args, None) != 0
