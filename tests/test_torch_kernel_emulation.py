"""The port's CUDA kernels run on the CPU, against their plain versions.

``csrc/warp_bounded.cu`` and ``csrc/conv3.cu`` are compiled with the host's
C++ compiler against stand-ins for ``<cuda_runtime.h>``, ``<cuda_bf16.h>``,
``<cuda_pipeline_primitives.h>`` and the tensor-core helpers of
``csrc/tensor_core.cuh`` (``tests/cuda_emulation/``) that run each block's
threads as ``std::thread``s with a barrier for ``__syncthreads()``, give each
thread its lane's part of a tensor-core product, and make ``cp.async`` a
plain copy. The kernels then run through
their C entry points on CPU tensors, at shapes that leave ragged edge tiles
in every direction. The bounded-warp forward and backward must equal
``windowed_transform`` and ``warp_bounded_bwd_plain`` bit for bit: they add
the same terms in the same order with the same roundings. The conv kernel
sums its products in another order than the plain version's matrix product
(and in float32 splits them into TF32 parts), so it is held within
``conv3.kernel_tolerance``, at several of its tiles. This checks the
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
    lib = _compile(tmp_path_factory, "conv3", ["smem", "fsmem"], 2)
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


# (batch, ci, co, D, H, W, layout, tile, fma_tile): ragged tiles along x, y
# and z, ci and co not multiples of the staged chunk (16 bf16, 8 f32) or of
# an N fragment (16), the first conv's two input channels (element-wise
# staging), co of one to four N fragments (64: two groups of two),
# channels-last inputs and NCDHW ones (one layout copy). tile, the
# tensor-core tile: "auto" is tile_plan's choice; ("big", nwarps, tz, ty)
# the large warp tiles (4 rows a warp in bfloat16, 2 in float32, txf what
# remains); ("small", nwarps, tz, ty, txf) one row a warp. fma_tile, the
# float32 forward's CUDA-core tile (tz, ty), None for fma_tile_plan's. The
# first three cases keep the ids they had before the layout and tile
# columns existed.
CONV_CASES = [pytest.param(*case, id="-".join(map(str, case[:6])) + (
    "" if i < 3 else f"-{case[6]}")) for i, case in enumerate([
        (1, 10, 20, 5, 9, 33, "cl", "auto", None),
        (2, 3, 4, 6, 10, 35, "ncdhw", "auto", None),
        (1, 16, 10, 7, 9, 34, "cl", "auto", (1, 2)),
        (1, 2, 16, 5, 7, 37, "cl", ("big", 4, 2, 2), (2, 2)),
        (1, 24, 40, 3, 5, 40, "ncdhw", ("big", 8, 2, 4), (2, 4)),
        (2, 32, 17, 4, 3, 18, "cl", ("small", 4, 1, 2, 2), (1, 1)),
        (1, 48, 64, 3, 4, 16, "cl", ("big", 4, 2, 2), (2, 8)),
        (1, 12, 20, 9, 17, 40, "cl", "auto", (4, 8)),
        # SynthMorph's 64-wide U-Net, with the tiles tile_plan and
        # fma_tile_plan give its full-width shapes: the decoder's skip
        # concat (ci 128) and the first block (ci 2)
        (1, 128, 64, 5, 6, 9, "cl", ("big", 8, 4, 4), (4, 8)),
        (1, 2, 64, 6, 5, 11, "cl", ("big", 8, 2, 4), (4, 8))])]


def _plan(tile, fma_tile, batch, D, H, W, co, dtype, f32_fma):
    if f32_fma:
        return fma_tile or conv3.fma_tile_plan(batch, D, H, co)
    if tile == "auto":
        return conv3.tile_plan(batch, D, H, W, co, dtype)
    if tile[0] == "small":
        return (1, conv3._n_fragments(co), *tile[1:])
    nwarps, tz, ty = tile[1:]
    mf = conv3._MF_BIG[dtype]
    return (mf, conv3._n_fragments(co), nwarps, tz, ty, mf * nwarps // (tz * ty))


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
@pytest.mark.parametrize("batch,ci,co,D,H,W,layout,tile,fma_tile", CONV_CASES)
def test_conv_kernel_within_tolerance_of_plain(conv_kernel, batch, ci, co, D, H, W, layout,
                                               tile, fma_tile, orientation, dtype):
    """The forward (bias, LeakyReLU, each rounding order) and the dx
    orientation (taps flipped, ci and co swapped, no bias or activation);
    float32's forward is the CUDA-core kernel, its dx the 3xTF32 one."""
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
    plan = _plan(tile, fma_tile, batch, D, H, W, kernel.shape[-1], dtype, f32_fma)
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
        if dtype == torch.bfloat16:
            # the sums differ by ~1e-6 of the terms, which rarely flips a bf16
            # rounding; the other rounding order differs in about a third
            assert (y == plain).float().mean() >= 0.99, (act_slope, round_first)
        # two launches give the same bits
        assert torch.equal(y, _conv_launch(conv_kernel, x, kernel, kernel_bias, act_slope,
                                           round_first, plan, forward))


@pytest.mark.parametrize("change", [dict(nf=4), dict(tz=3), dict(nwarps=9, tz=9),
                                    dict(bf16=2), dict(ci=0), dict(mf=3, tz=3),
                                    dict(f32_fma=2), dict(f32_fma=1)])
def test_conv_entry_point_refuses_what_it_cannot_run(conv_kernel, change):
    """A tile whose rows do not match its warps, an unknown fragment count,
    too many warps, an unknown dtype, no channels."""
    x = torch.zeros((1, 4, 4, 4, 16)).movedim(-1, 1)
    y, _operands, args = conv3._kernel_args(x, torch.zeros((3, 3, 3, 16, 16)),
                                            torch.zeros(16), 0.2, False, (2, 1, 4, 2, 2, 2))
    names = ["x", "w", "bias", "y", "B", "ci", "co", "D", "H", "W", "bf16", "has_act",
             "slope", "round_first", "f32_fma", "mf", "nf", "nwarps", "tz", "ty", "txf"]
    args = list(args)
    assert conv_kernel(*args, None) == 0
    for key, value in change.items():
        args[names.index(key)] = value
    assert conv_kernel(*args, None) != 0
