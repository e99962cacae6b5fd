"""The port's CUDA kernels run on the CPU, against their plain versions.

``csrc/warp_bounded.cu`` and ``csrc/conv3.cu`` are compiled with the host's
C++ compiler against stand-ins for ``<cuda_runtime.h>`` and
``<cuda_bf16.h>`` (``tests/cuda_emulation/``) that run each block's threads
as ``std::thread``s with a barrier for ``__syncthreads()``. The kernels then
run through their C entry points on CPU tensors, at shapes that leave ragged
edge tiles in every direction. The bounded-warp forward and backward must
equal ``windowed_transform`` and ``warp_bounded_bwd_plain`` bit for bit: they
add the same terms in the same order with the same roundings. The conv
kernel sums its products in another order than the plain version's matrix
product, so it is held within ``conv3.kernel_tolerance``. This checks the
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
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded_bwd_plain, windowed_transform

SHIM = Path(__file__).resolve().parent / "cuda_emulation"
# (batch, spatial, channels, halo): several blocks along x, y and z, with
# partial tiles at the far edges
CASES = [(1, (5, 9, 40), 1, 1), (2, (6, 10, 35), 3, 1), (1, (7, 9, 33), 2, 2),
         (1, (6, 8, 34), 4, 3), (1, (9, 17, 20), 3, 4)]


def _compile(tmp_path_factory, name, shared, launches):
    """Build ``csrc/<name>.cu`` for the CPU: its dynamic shared array
    ``shared`` becomes the stand-in's buffer and its ``launches`` kernel
    launches calls of ``emu_launch``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CUDA source for the CPU")
    src = _build.SOURCES[name].read_text()
    src = src.replace(f"extern __shared__ float {shared}[];",
                      f"float* {shared} = emu_shared_memory;")
    src = re.sub(r"(\w+<\w+>)<<<grid, block, smem, stream>>>\(", r"emu_launch(grid, block, \1, ",
                 src)
    assert src.count("emu_launch(") == launches and "__shared__" not in src
    out = tmp_path_factory.mktemp("emulation")
    (out / f"{name}.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-I", str(SHIM), "-o", str(out / f"lib{name}.so"),
                    str(out / f"{name}.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(out / f"lib{name}.so"))


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    return _compile(tmp_path_factory, "warp_bounded", "tile", 2)


@pytest.fixture(scope="module")
def conv_kernel(tmp_path_factory):
    lib = _compile(tmp_path_factory, "conv3", "smem", 1)
    fn = lib.vxm_conv3_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float] + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(lib, name, *args):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (len(args) - 7) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(*args)


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


@pytest.mark.parametrize("nch,halo", [(5, 1), (4, 8), (0, 1)])
def test_entry_points_refuse_what_they_cannot_run(kernels, nch, halo):
    """Too many channels, or a halo whose tile overflows shared memory."""
    buf = torch.zeros(4096)
    p = buf.data_ptr()
    assert _call(kernels, "vxm_warp_bounded_fwd", p, p, p, 1, 4, 4, 4, nch, halo, None) != 0
    assert _call(kernels, "vxm_warp_bounded_bwd", p, p, p, p, p, 1, 4, 4, 4, nch, halo,
                 None) != 0


# (batch, ci, co, D, H, W): ragged tiles along x (32), y (8) and z (4), ci
# not a multiple of the staged chunk (8), co of the block (16)
CONV_CASES = [(1, 10, 20, 5, 9, 33), (2, 3, 4, 6, 10, 35), (1, 16, 10, 7, 9, 34)]


def _conv_launch(fn, x, kernel, bias, act_slope, round_conv_first):
    """The wrapper's launch of ``vxm_conv3_fwd`` (ops/conv3.py), on the CPU."""
    B, ci, D, H, W = x.shape
    co = kernel.shape[-1]
    cop = -(-co // 16) * 16
    w = torch.nn.functional.pad(
        kernel.to(x.dtype).float().permute(3, 0, 1, 2, 4).reshape(ci, 27, co),
        (0, cop - co)).contiguous()
    b = torch.nn.functional.pad(bias.to(x.dtype).float(), (0, cop - co)).contiguous()
    y = torch.full((B, co, D, H, W), float("nan"), dtype=x.dtype)
    slope = 0.0 if act_slope is None else torch.tensor(
        act_slope, dtype=x.dtype if round_conv_first else torch.float32).item()
    assert fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, ci, co, D, H, W,
              int(x.dtype == torch.bfloat16), int(act_slope is not None), slope,
              int(round_conv_first), cop, None) == 0
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("orientation", ["forward", "dx"])
@pytest.mark.parametrize("batch,ci,co,D,H,W", CONV_CASES)
def test_conv_kernel_within_tolerance_of_plain(conv_kernel, batch, ci, co, D, H, W,
                                               orientation, dtype):
    """The forward (bias, LeakyReLU, each rounding order) and the dx
    orientation (taps flipped, ci and co swapped, no bias or activation)."""
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
    for act_slope, round_first in settings:
        y = _conv_launch(conv_kernel, x, kernel, bias, act_slope, round_first)
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
