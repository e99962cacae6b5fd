"""The port's CUDA kernels run on the CPU, against their plain versions.

``csrc/warp_bounded.cu`` is compiled with the host's C++ compiler against a
stand-in for ``<cuda_runtime.h>`` (``tests/cuda_emulation/``) that runs each
block's threads as ``std::thread``s with a barrier for ``__syncthreads()``.
The forward and backward kernels then run through their C entry points on
CPU tensors, at shapes that leave ragged edge tiles in every direction, and
must equal ``windowed_transform`` and ``warp_bounded_bwd_plain`` bit for
bit: they add the same terms in the same order with the same roundings.
This checks the kernels' indexing and arithmetic where there is no GPU; the
GPU build and launch are checked by ``chip_smoke.py``.
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
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded_bwd_plain, windowed_transform

SHIM = Path(__file__).resolve().parent / "cuda_emulation"
# (batch, spatial, channels, halo): several blocks along x, y and z, with
# partial tiles at the far edges
CASES = [(1, (5, 9, 40), 1, 1), (2, (6, 10, 35), 3, 1), (1, (7, 9, 33), 2, 2),
         (1, (6, 8, 34), 4, 3), (1, (9, 17, 20), 3, 4)]


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CUDA source for the CPU")
    src = _build.SOURCES["warp_bounded"].read_text()
    src = src.replace("extern __shared__ float tile[];", "float* tile = emu_shared_memory;")
    src = re.sub(r"(\w+<C>)<<<grid, block, smem, stream>>>\(", r"emu_launch(grid, block, \1, ",
                 src)
    assert src.count("emu_launch(") == 2 and "__shared__" not in src
    out = tmp_path_factory.mktemp("emulation")
    (out / "warp_bounded.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-I", str(SHIM), "-o", str(out / "libwarp.so"),
                    str(out / "warp_bounded.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(out / "libwarp.so"))


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
