#!/usr/bin/env python3
"""Build and drive the PyTorch port (voxelmorph_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --profile  # also print a profiler breakdown of one call
    python3 chip_smoke.py --compare-warp-source OLD/warp_bounded.cu
        # also time another build of the warp kernels (an earlier commit's
        # csrc/warp_bounded.cu) on phases 2 and 2b's inputs

Phases:
  1. device and build: the card's name and power limit (nvidia-smi), then
     every CUDA kernel of the port built with nvcc from csrc/, all at once,
     and the conv kernel's tensor-core instructions (HMMA) counted in its
     machine code (cuobjdump), which must not be none;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it and at stress shapes, with times
     beside the bound (and bound_share, the bound over the time), the plain
     version, one PyTorch library call and, for the warp, one elementwise op
     that moves the same bytes; a kernel and the calls it is compared with
     are timed in turns;
  2b. the bounded-warp backward kernel against its plain version at phase
     2's shapes, bit-equal across two launches, with times beside the bound,
     the plain version and the backward of grid_sample, on the phase's
     random shifts and on a smooth field of the same bound;
  2c. gradients through warp_bounded and integrate_vec_batched on CUDA
     tensors (the backward kernel) against the same on the CPU;
  2d. the conv kernel against its plain version at the full-width U-Net's
     11 conv shapes, bfloat16 and float32, forward (both rounding orders)
     and the input-gradient orientation, on channels-last inputs as the
     U-Net feeds them, bit-equal across two launches, with times beside the
     bound, the plain version and cuDNN's conv3d on the same inputs;
  3. the serving path end to end: the committed full-width VxmDense
     checkpoint (160x192x224, bfloat16) registers a synthetic smooth pair
     through build_register_fn; the kernel launch counts of that call must
     be nonzero, and its outputs must agree with the port's own bfloat16
     CPU run; then the same in float32 (TF32 off) against the port's own
     CPU run, and the bfloat16 outputs against the float32 ones;
  3b. serving with the conv kernel (set_pallas_conv(True), the JAX
     package's VXM_PALLAS_CONV=1): 11 conv launches and no layout copy per
     register call, float32 kernel mode against float32 cuDNN mode, bfloat16
     against float32;
  3c. --fast-warp (enable_fast_warp) at full width: four halo-2 bounded
     warps by the integration root for the moved image, the warp unchanged;
     the card against the port's CPU run at 80x96x112;
  4. training at full width: the default recipe of scripts/train.py (MSE +
     Grad-l2, Adam 1e-4, float32) on VxmDense at 160x192x224 from seed 0:
     one step's loss and gradients through the kernels against the
     gather-only path, the card against the port's CPU run at 80x96x112,
     ten steps that lower the loss with the backward kernel launched in
     every step, the time per step and the peak memory; then three steps of
     the committed checkpoint's own recipe (use_probs, NCC, KL, bfloat16);
  4b. training with the conv kernel: one step's loss and gradients against
     cuDNN mode, then three steps that lower the loss, 21 conv launches per
     step (11 forward, 10 input gradients) and no layout copy.
It prints a JSON line of kernel results and, last, a JSON line with the
device. Any failure prints a traceback and exits non-zero without that line.
Nothing is written to the repository except the kernel build directory.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from voxelmorph_tpu_torch import _build, losses
from voxelmorph_tpu_torch.models.modelio import load_model
from voxelmorph_tpu_torch.models.unet import ConvBlock
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops import conv3
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.ops import warp_bounded as warp_bounded_ops
from voxelmorph_tpu_torch.ops.interp import ndgrid, resize
from voxelmorph_tpu_torch.ops.warp_bounded import (warp_bounded, warp_bounded_bwd,
                                                   warp_bounded_bwd_plain, windowed_transform)
from voxelmorph_tpu_torch.registration import (build_register_fn, enable_fast_warp,
                                               resolve_registration_model)
from voxelmorph_tpu_torch.training import LossTerm, Trainer

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "artifacts_r4" / "probs_ncc_0050.npz"
INSHAPE = (160, 192, 224)
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
TF32_TENSOR_FLOPS_PER_S = 494.7e12
# the faster route to float32 accuracy for a convolution: three TF32 passes
# on the tensor cores (the 3xTF32 split of csrc/conv3.cu), not the float32
# CUDA cores
F32_CONV_FLOPS_PER_S = TF32_TENSOR_FLOPS_PER_S / 3

# (batch, spatial, channels, halo) of the bounded-warp checks; the first is
# the serving and training shape (the squaring steps at half resolution)
WARP_CASES = [
    (1, (80, 96, 112), 3, 1),
    (2, (80, 96, 112), 3, 1),
    (2, (80, 96, 112), 3, 2),
    (1, INSHAPE, 1, 2),
    # the other channel counts and halos the wrapper accepts; halo 4 with
    # 4 channels needs more than 48 KB of shared memory per block
    (1, (80, 96, 112), 2, 3),
    (1, (80, 96, 112), 4, 4),
]

# kernel vs plain version: both compute the same f32 terms; they may differ
# only in the order of additions
KERNEL_TOL = 1e-5
# float32 GPU vs CPU at full width: conv sums in another order through the
# U-Net, and the GPU's early squaring steps take the kernel where the CPU
# takes the gather (same function, other rounding)
FLOW_TOL = 1e-3   # voxels
IMAGE_TOL = 1e-4  # intensities in [0, 1]
# bfloat16 GPU vs CPU at full width: both round every conv output and bias
# add to bfloat16, but cuDNN and the CPU's convolutions accumulate in other
# orders, so single roundings differ by one bf16 step and the difference
# grows through the U-Net and the seven squarings. Measured on an H100:
# 9.2e-3 voxels on pos_flow, 2.1e-4 on y_source. The bfloat16-vs-float32
# gap below is 0.15 and 4.6e-3, so these limits tell the dtypes apart.
BF16_FLOW_TOL = 3e-2   # voxels
BF16_IMAGE_TOL = 1e-3  # intensities in [0, 1]
# bfloat16 vs float32, both on the card: the cost of bfloat16 compute.
# Measured on an H100: 0.15 voxels on pos_flow, 4.6e-3 on y_source.
BF16_VS_F32_FLOW_TOL = 0.5    # voxels
BF16_VS_F32_IMAGE_TOL = 2e-2  # intensities in [0, 1]
# gradients through the bounded warp and the seven squarings, GPU vs CPU,
# relative to the largest gradient: the backward kernel and the plain
# version differ only in the order of additions. Measured on an H100: 0 for
# warp_bounded, 2.0e-7 for integrate_vec_batched.
GRAD_GPU_CPU_RTOL = 1e-5
# one float32 train step's loss and parameter gradients, each tensor
# relative to its largest entry. The kernel path and the gather-only path
# on the card differ in the warp of each squaring step: at the seed-0 init
# the flows (~1e-5 voxels) are below half a float step of most coordinates,
# so x + shift rounds to x and the displacement is exactly 0, where the
# bounded warp's backward (the Pallas kernel's formulation) takes the tent
# weight's derivative as 0 and the gather takes a one-sided difference.
# With the flow head redrawn as N(0, FLOW_STD), flows of about a voxel,
# the two agree to the order of their sums. The card and the CPU both take
# the bounded tiers and differ in the order of sums (cuDNN's and the CPU's
# convolutions, scatter-adds with atomics). Measured on an H100, largest
# over the loss and the 24 gradient tensors: 0.187 at the seed-0 init and
# 5.9e-6 with the redrawn head (kernel vs gather-only); 1.6e-4 and 1.4e-4
# (card vs CPU). A zero gradient differs by 1, a sign-flipped one by 2.
FLOW_STD = 0.05
TRAIN_INIT_KERNEL_VS_GATHER_RTOL = 0.5
TRAIN_KERNEL_VS_GATHER_RTOL = 1e-4
TRAIN_GPU_VS_CPU_RTOL = 2e-3
# one float32 train step (flow head redrawn), conv kernel mode against cuDNN
# mode on the card, TF32 off: both convolve in full float32 and differ in the
# order of sums and in the weight gradient (shifted matrix products against
# cuDNN's)
TRAIN_CONV_KERNEL_VS_CUDNN_RTOL = 1e-4

# the least share of bf16 conv outputs the kernel and its plain version agree
# on bit for bit in the same rounding order
BF16_EQUAL_SHARE = 0.99

# (D, H, W, ci, co) of the full-width U-Net's 11 conv blocks, in the order of
# the forward; the first block's input (the image pair) needs no gradient
UNET_CONVS = [(160, 192, 224, 2, 16), (80, 96, 112, 16, 32), (40, 48, 56, 32, 32),
              (20, 24, 28, 32, 32), (10, 12, 14, 32, 32), (20, 24, 28, 64, 32),
              (40, 48, 56, 64, 32), (80, 96, 112, 64, 32), (160, 192, 224, 48, 32),
              (160, 192, 224, 32, 16), (160, 192, 224, 16, 16)]


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def window_halo(value):
    """Run with VXM_WINDOW_HALO set: "1" sends the CPU through the bounded
    tiers as the card takes them, "0" sends every warp to the gather."""
    os.environ["VXM_WINDOW_HALO"] = value
    try:
        yield
    finally:
        os.environ.pop("VXM_WINDOW_HALO")


@contextlib.contextmanager
def conv_kernel_mode(enabled):
    """Run with the conv-kernel dispatch forced on or off."""
    conv3.set_pallas_conv(enabled)
    try:
        yield
    finally:
        conv3.set_pallas_conv(None)


@contextlib.contextmanager
def full_float32():
    """Run cuDNN's float32 convolutions and float32 matrix products in full
    float32 (cuDNN's default is TF32), then restore the settings."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def reset_launches():
    warp_bounded.launches = warp_bounded_bwd.launches = conv3.conv3_same_cf.launches = 0
    conv3.conv3_same_cf.layout_copies = 0


def read_launches():
    """Launches of each kernel since reset_launches, and the conv wrapper's
    layout copies."""
    return {"fwd": warp_bounded.launches, "bwd": warp_bounded_bwd.launches,
            "conv": conv3.conv3_same_cf.launches,
            "layout_copies": conv3.conv3_same_cf.layout_copies}


def tensor_core_instructions(name):
    """The number of tensor-core (HMMA) instructions in the machine code of
    the kernel library ``name``, from cuobjdump next to nvcc."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def phase(name):
    log(f"\n== {name}")
    return time.perf_counter()


def warm_device(seconds=0.5):
    """Keep the card busy for a while, so that the timings that follow do
    not start while its clocks are still rising from idle (the build leaves
    it idle for tens of seconds)."""
    a = torch.randn(4096, 4096, device="cuda")
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()


def time_cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms over ``reps`` runs, each with a
    cold L2 (see sample_cuda_ms)."""
    return float(np.median(sample_cuda_ms(fn, reps, warmup)))


def time_in_turns(fns, rounds=2, reps=10, warmup=3):
    """Median device time in ms of each of ``fns`` (a dict), timed in turns:
    ``rounds`` rounds, each timing every function ``reps`` times in order,
    so that a drift of the card's state does not favour one of them."""
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            samples[name] += sample_cuda_ms(fn, reps, warmup)
    return {name: float(np.median(t)) for name, t in samples.items()}


# Cycles the card spins before each timed run, about 1 ms: longer than the
# host takes to launch the run, so that the time from the start event to
# the end event is the device's alone.
SPIN_CYCLES = 2_000_000


def sample_cuda_ms(fn, reps, warmup):
    """Device times of ``reps`` runs of ``fn`` in ms, each with a cold L2 (a
    256 MB buffer is written before each run) and timed from a start event
    that the card reaches only after spinning SPIN_CYCLES: without that, a
    short kernel whose launch takes the host longer than the flush takes
    the card is timed with the card idle, waiting for it."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def warp_case(rng, batch, spatial, nch, halo):
    """Random volume and shifts within +-halo, with a band of voxels along
    every border pushed across it, so that clamping binds."""
    vol = rng.standard_normal((batch, *spatial, nch), dtype=np.float32)
    shift = rng.uniform(-halo, halo, size=(batch, *spatial, 3)).astype(np.float32)
    band = 3
    for axis in range(3):
        lo = [slice(None)] * 5
        hi = [slice(None)] * 5
        lo[axis + 1] = slice(0, band)
        hi[axis + 1] = slice(-band, None)
        lo[4] = hi[4] = axis
        shift[tuple(lo)] = -halo
        shift[tuple(hi)] = halo
    return (torch.from_numpy(vol).cuda(), torch.from_numpy(shift).cuda())


def build_compare_libraries(sources):
    """Build each other copy of csrc/warp_bounded.cu (an earlier commit's,
    unpacked outside the package) with the package's nvcc flags, all at
    once, into the build directory. Returns {label: ctypes library}."""
    out = _build.library_path("warp_bounded").parent / "compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        label = f"{i}:{src}"
        lib = out / f"libwarp_bounded_{i}.so"
        procs[label] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        for line in text.splitlines():
            if any(key in line for key in ("registers", "smem", "spill", "Compiling entry")):
                log(f"  {label}: {line.strip()}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def compare_launch(lib, name, tensors, halo):
    """Launch the entry point ``name`` of another build on the current
    stream, as ops/warp_bounded.py launches the package's own."""
    fn = getattr(lib, name)
    fn.argtypes = warp_bounded_ops._ARGTYPES[name]
    fn.restype = ctypes.c_int
    B, D, H, W, C = tensors[0].shape
    err = fn(*(t.data_ptr() for t in tensors), B, D, H, W, C, halo,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} of another build failed to launch: CUDA error {err}")


def compare_rows(libs, name, inputs, outputs, plain, halo):
    """Each other build's error against the plain version, and a function
    that launches it, by label."""
    errs, fns = {}, {}
    for label, lib in libs.items():
        compare_launch(lib, name, inputs + outputs, halo)
        torch.cuda.synchronize()
        errs[label] = max((o - p).abs().max().item() for o, p in zip(outputs, plain))
        fns[label] = lambda lib=lib: compare_launch(lib, name, inputs + outputs, halo)
    return errs, fns


def timed_row(row, fns, compare):
    """Time the kernel, the library call and the other builds in turns, and
    put their times into ``row`` (the other builds' under "compare")."""
    errs, other = compare
    times = time_in_turns({**fns, **{f"compare {k}": f for k, f in other.items()}})
    row.update({k: times[k] for k in fns})
    if errs:
        row["compare"] = {k: dict(max_abs_err=errs[k], ms=times[f"compare {k}"]) for k in errs}


def grid_sample_warp(vol_cf, grid):
    """The library comparator: trilinear grid_sample with border clamping."""
    return F.grid_sample(vol_cf, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def check_warp_bounded(rng, compare_libs):
    """Kernel vs plain version at the serving shape and stress shapes, and
    the other builds of ``compare_libs`` beside it."""
    rows = []
    for batch, spatial, nch, halo in WARP_CASES:
        vol, shift = warp_case(rng, batch, spatial, nch, halo)
        out = warp_bounded(vol, shift, halo)
        plain = windowed_transform(vol, shift, halo)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()

        # grid_sample takes channels-first volumes and (x, y, z) coordinates
        # normalised to [-1, 1]; the conversion is outside the timed call
        coords = ndgrid(spatial, device="cuda") + shift
        dims = torch.tensor([s - 1 for s in spatial], device="cuda", dtype=torch.float32)
        grid = (2.0 * coords / dims - 1.0).flip(-1).contiguous()
        vol_cf = vol.movedim(-1, 1).contiguous()
        lib_err = (grid_sample_warp(vol_cf, grid).movedim(1, -1) - plain).abs().max().item()

        vox = batch * int(np.prod(spatial))
        nbytes = (2 * nch + 3) * 4 * vox
        ops = (46 + 16 * nch) * vox
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        # the floor of this timing for the kernel's bytes: one elementwise
        # op that reads vol and shift (every sector of it) and writes a
        # tensor of vol's size
        same = shift[..., :nch] if nch <= 3 else None
        row = dict(
            shape=[batch, *spatial, nch], halo=halo, max_abs_err=err,
            grid_sample_err=lib_err,
            plain_ms=time_cuda_ms(lambda: windowed_transform(vol, shift, halo)),
            bound_ms=bound_ms, same_bytes_ms=None,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S else "operations")
        fns = dict(ms=lambda: warp_bounded(vol, shift, halo),
                   library_ms=lambda: grid_sample_warp(vol_cf, grid))
        if same is not None:
            fns["same_bytes_ms"] = lambda: vol + same
        timed_row(row, fns, compare_rows(compare_libs, "vxm_warp_bounded_fwd", [vol, shift],
                                         [torch.empty_like(vol)], [plain], halo))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        log(json.dumps(row))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp_bounded kernel differs from its plain version "
                                 f"by {err} > {KERNEL_TOL} at {row['shape']} halo {halo}")
        rows.append(row)
        del vol, shift, out, plain, coords, grid, vol_cf
    return rows


def smooth_pair(spatial, device):
    """A smooth synthetic pair: low-frequency noise upsampled to ``spatial``
    and scaled to [0, 1], and the same image warped by a smooth random
    displacement of a few voxels."""
    rng = np.random.default_rng(SEED)
    coarse = torch.from_numpy(
        rng.standard_normal((10, 12, 14, 1), dtype=np.float32)).to(device)
    img = resize(coarse, [s / c for s, c in zip(spatial, (10, 12, 14))], new_shape=spatial)
    img = (img - img.min()) / (img.max() - img.min())
    disp = torch.from_numpy(
        3.0 * rng.standard_normal((5, 6, 7, 3), dtype=np.float32)).to(device)
    disp = resize(disp, [s / c for s, c in zip(spatial, (5, 6, 7))], new_shape=spatial)
    fixed = warp_ops.transform(img, disp, window_halo=None)
    return img[None], fixed[None]


def max_and_mean_abs(a, b):
    d = (a.float().cpu() - b.float().cpu()).abs()
    return d.max().item(), d.mean().item()


def register_full_width(moving, fixed):
    """The serving path in the checkpoint's own dtype (bfloat16)."""
    model = load_model(str(CHECKPOINT), device="cuda")
    log(f"model: VxmDense {model.inshape} dtype {model.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} params")
    register = build_register_fn(model)

    reset_launches()
    t0 = time.perf_counter()
    moved, warp = register(moving, fixed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"first call {first_s:.3f} s; kernel launches {launches}")
    if launches["fwd"] == 0:
        raise AssertionError("the serving path launched no warp_bounded kernel")
    if tuple(moved.shape) != (1, *INSHAPE, 1) or tuple(warp.shape) != (1, *INSHAPE, 3):
        raise AssertionError(f"shapes: moved {tuple(moved.shape)}, warp {tuple(warp.shape)}")
    if not (torch.isfinite(moved).all() and torch.isfinite(warp).all()):
        raise AssertionError("non-finite output")
    log(f"max|warp| {warp.abs().max().item():.4f} voxels; "
        f"mean|moved - fixed| {(moved - fixed).abs().mean().item():.5f} "
        f"(before: {(moving - fixed).abs().mean().item():.5f})")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        register(moving, fixed)
    torch.cuda.synchronize()
    pairs_per_s = reps / (time.perf_counter() - t0)
    log(f"bs1 bfloat16: {pairs_per_s:.4f} pairs/s ({1e3 / pairs_per_s:.2f} ms per pair)")
    return model, launches, moved, warp


def bf16_vs_cpu(moved, warp, moving, fixed):
    """The bfloat16 card run against the port's bfloat16 CPU run."""
    t0 = time.perf_counter()
    cpu_moved, cpu_warp = build_register_fn(load_model(str(CHECKPOINT), device="cpu"))(
        moving.cpu(), fixed.cpu())
    flow_err, flow_mean = max_and_mean_abs(warp, cpu_warp)
    image_err, image_mean = max_and_mean_abs(moved, cpu_moved)
    log(f"bfloat16 on cpu: {time.perf_counter() - t0:.3f} s")
    log(f"GPU vs CPU bfloat16: pos_flow max abs err {flow_err:.4e} (mean {flow_mean:.4e}, "
        f"tol {BF16_FLOW_TOL}), y_source max abs err {image_err:.4e} "
        f"(mean {image_mean:.4e}, tol {BF16_IMAGE_TOL})")
    if not (flow_err <= BF16_FLOW_TOL and image_err <= BF16_IMAGE_TOL):
        raise AssertionError("bfloat16 GPU run disagrees with the bfloat16 CPU run")


def register_f32_vs_cpu(moving, fixed):
    """float32 on the card (TF32 off) against the port's CPU run."""
    with full_float32():
        return _register_f32_vs_cpu(moving, fixed)


def _register_f32_vs_cpu(moving, fixed):
    results = {}
    for device in ("cuda", "cpu"):
        model = load_model(str(CHECKPOINT), device=device, dtype=torch.float32)
        warp_bounded.launches = 0
        t0 = time.perf_counter()
        moved, warp = build_register_fn(model)(moving.to(device), fixed.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        log(f"float32 on {device}: {time.perf_counter() - t0:.3f} s, "
            f"warp_bounded launches {warp_bounded.launches}")
        results[device] = (moved.cpu(), warp.cpu())
    flow_err = (results["cuda"][1] - results["cpu"][1]).abs().max().item()
    image_err = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    log(f"GPU vs CPU float32: pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}), "
        f"y_source max abs err {image_err:.3e} (tol {IMAGE_TOL})")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("float32 GPU run disagrees with the CPU run")
    return results["cuda"]


def bf16_vs_f32(moved, warp, moved_f32, warp_f32):
    """The bfloat16 card run against the float32 card run."""
    flow_err, flow_mean = max_and_mean_abs(warp, warp_f32)
    image_err, image_mean = max_and_mean_abs(moved, moved_f32)
    log(f"bfloat16 vs float32 on the GPU: pos_flow max abs diff {flow_err:.4e} "
        f"(mean {flow_mean:.4e}, tol {BF16_VS_F32_FLOW_TOL}), y_source max abs diff "
        f"{image_err:.4e} (mean {image_mean:.4e}, tol {BF16_VS_F32_IMAGE_TOL})")
    if not (flow_err <= BF16_VS_F32_FLOW_TOL and image_err <= BF16_VS_F32_IMAGE_TOL):
        raise AssertionError("bfloat16 GPU run is too far from the float32 GPU run")


def register_conv_kernel(moving, fixed):
    """Phase 3b: the serving path with the conv kernel. Returns the launch
    counts of one bfloat16 register call and its ms per pair."""
    with conv_kernel_mode(True):
        register = build_register_fn(load_model(str(CHECKPOINT), device="cuda"))
        reset_launches()
        moved, warp = register(moving, fixed)
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"bfloat16 register call with the conv kernel: kernel launches {launches}")
        if launches["conv"] != len(UNET_CONVS) or launches["fwd"] == 0:
            raise AssertionError(f"expected {len(UNET_CONVS)} conv launches and warp launches, "
                                 f"got {launches}")
        if launches["layout_copies"] != 0:
            raise AssertionError(f"the register call copied conv inputs to channels-last "
                                 f"{launches['layout_copies']} times")
        if tuple(warp.shape) != (1, *INSHAPE, 3) or not (
                torch.isfinite(moved).all() and torch.isfinite(warp).all()):
            raise AssertionError("bad output of the conv-kernel register call")
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            register(moving, fixed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        log(f"bs1 bfloat16 with the conv kernel: {ms:.2f} ms per pair ({1e3 / ms:.4f} pairs/s)")

    f32, f32_launches = {}, {}
    for enabled in (True, False):
        with conv_kernel_mode(enabled), full_float32():
            model = load_model(str(CHECKPOINT), device="cuda", dtype=torch.float32)
            reset_launches()
            f32[enabled] = build_register_fn(model)(moving, fixed)
            torch.cuda.synchronize()
            f32_launches[enabled] = read_launches()["conv"]
    flow_err, _ = max_and_mean_abs(f32[True][1], f32[False][1])
    image_err, _ = max_and_mean_abs(f32[True][0], f32[False][0])
    log(f"float32, conv kernel ({f32_launches[True]} launches) vs cuDNN "
        f"({f32_launches[False]}): pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}), "
        f"y_source max abs err {image_err:.3e} (tol {IMAGE_TOL})")
    if f32_launches != {True: len(UNET_CONVS), False: 0}:
        raise AssertionError(f"float32 conv launches {f32_launches}")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("float32 conv-kernel run disagrees with the cuDNN run")
    bf16_vs_f32(moved, warp, *f32[True])
    return launches, ms


def fast_warp_check(moving, fixed):
    """Phase 3c: --fast-warp at full width (bfloat16), then float32 on the
    card against the port's CPU run at 80x96x112. Returns the launch counts
    of the full-width call and its ms per pair."""
    def calls(model, mv, fx):
        """Register with and without the phase warp; the launches of each."""
        out = {}
        for name, m in (("plain", model), ("fast", enable_fast_warp(model))):
            reset_launches()
            moved, warp = build_register_fn(m)(mv, fx)
            if mv.is_cuda:
                torch.cuda.synchronize()
            out[name] = (moved, warp, read_launches())
        return out

    def phase_launches(out):
        # the plain call's kernel launches: the squarings, and the final warp
        # where max|warp| <= 1 (the halo-1 tier); the fast call's: the same
        # squarings and 4 halo-2 phase warps
        squarings = out["plain"][2]["fwd"] - int(out["plain"][1].abs().max().item() <= 1.0)
        return out["fast"][2]["fwd"] - squarings

    model = load_model(str(CHECKPOINT), device="cuda")
    out = calls(model, moving, fixed)
    launches = out["fast"][2]
    n_phase = phase_launches(out)
    flow_err, _ = max_and_mean_abs(out["fast"][1], out["plain"][1])
    image_diff, image_mean = max_and_mean_abs(out["fast"][0], out["plain"][0])
    log(f"fast warp, bfloat16, {INSHAPE}: kernel launches {launches} ({n_phase} phase warps); "
        f"pos_flow vs the plain call {flow_err:.3e}; y_source vs the gather's {image_diff:.4e} "
        f"(mean {image_mean:.4e})")
    if n_phase != 4 or flow_err > FLOW_TOL:
        raise AssertionError("the fast-warp call did not take four halo-2 phase warps")
    ms = {}
    for name, m in (("plain", model), ("fast", enable_fast_warp(model))):
        register = build_register_fn(m)
        register(moving, fixed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            register(moving, fixed)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"bs1 bfloat16: fast warp {ms['fast']:.2f} ms per pair, gather {ms['plain']:.2f} ms")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    half = tuple(s // 2 for s in INSHAPE)
    mv_h, fx_h = smooth_pair(half, "cpu")
    results = {}
    for device in ("cuda", "cpu"):
        m = resolve_registration_model(
            load_model(str(CHECKPOINT), device=device, dtype=torch.float32), half)
        t0 = time.perf_counter()
        results[device] = calls(m, mv_h.to(device), fx_h.to(device))
        log(f"fast warp, float32, {half} on {device}: {time.perf_counter() - t0:.2f} s, "
            f"{phase_launches(results[device]) if device == 'cuda' else 0} phase warp launches")
    if phase_launches(results["cuda"]) != 4:
        raise AssertionError(f"the fast-warp call at {half} took no bounded phase warps")
    flow_err, _ = max_and_mean_abs(results["cuda"]["fast"][1], results["cpu"]["fast"][1])
    image_err, _ = max_and_mean_abs(results["cuda"]["fast"][0], results["cpu"]["fast"][0])
    log(f"fast warp GPU vs CPU float32 at {half}: pos_flow max abs err {flow_err:.3e} (tol "
        f"{FLOW_TOL}), y_source max abs err {image_err:.3e} (tol {IMAGE_TOL})")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("the fast-warp GPU run disagrees with the CPU run")
    return launches, ms["fast"]


def profile_device(label, fn, rows):
    """Device time by kernel over one run of ``fn``, and the share of its
    wall time in which the device ran no kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels only: operator events repeat the time of the kernels they launch
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    log(f"profiled {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}")
    log(events.table(sort_by="self_device_time_total", row_limit=rows))


def profile_call(model, moving, fixed):
    """The profile of one bfloat16 register call, after a warm-up call."""
    register = build_register_fn(model)
    register(moving, fixed)
    torch.cuda.synchronize()
    profile_device("call", lambda: register(moving, fixed), rows=25)


def bwd_bound(vox, nch):
    """The least time of the warp backward on the card: it reads vol, shift
    and g and writes dvol and dshift, (3C + 6) * 4 bytes per voxel; its
    operations, about (32 C + 224) per voxel (8 nonzero taps each for the
    dvol gather and for dshift), at the f32 rate. Returns (ms, bound_by)."""
    nbytes = (3 * nch + 6) * 4 * vox
    ops = (32 * nch + 224) * vox
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_warp_bounded_bwd(rng, compare_libs):
    """Backward kernel vs plain version at phase 2's shapes: within
    KERNEL_TOL, and bit-equal across two launches (no atomics); the other
    builds of ``compare_libs`` beside it."""
    rows = []
    for batch, spatial, nch, halo in WARP_CASES:
        vol, shift = warp_case(rng, batch, spatial, nch, halo)
        g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
        dvol, dshift = warp_bounded_bwd(vol, shift, g, halo)
        dvol2, dshift2 = warp_bounded_bwd(vol, shift, g, halo)
        pvol, pshift = warp_bounded_bwd_plain(vol, shift, g, halo)
        torch.cuda.synchronize()
        err = max((dvol - pvol).abs().max().item(), (dshift - pshift).abs().max().item())
        repeatable = torch.equal(dvol, dvol2) and torch.equal(dshift, dshift2)
        scale = max(pvol.abs().max().item(), pshift.abs().max().item())

        # the library comparator: the backward of grid_sample (border,
        # align_corners), for the volume and the sampling grid
        coords = ndgrid(spatial, device="cuda") + shift
        dims = torch.tensor([s - 1 for s in spatial], device="cuda", dtype=torch.float32)
        grid = (2.0 * coords / dims - 1.0).flip(-1).contiguous().requires_grad_()
        vol_cf = vol.movedim(-1, 1).contiguous().requires_grad_()
        out_cf = grid_sample_warp(vol_cf, grid)
        g_cf = g.movedim(-1, 1).contiguous()

        vox = batch * int(np.prod(spatial))
        bound_ms, bound_by = bwd_bound(vox, nch)
        row = dict(
            shape=[batch, *spatial, nch], halo=halo, max_abs_err=err, max_abs_grad=scale,
            repeatable=repeatable,
            # the plain version is slow at the large halos: fewer runs
            plain_ms=time_cuda_ms(lambda: warp_bounded_bwd_plain(vol, shift, g, halo),
                                  reps=5, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by)
        timed_row(row, dict(
            ms=lambda: warp_bounded_bwd(vol, shift, g, halo),
            library_ms=lambda: torch.autograd.grad(out_cf, (vol_cf, grid), g_cf,
                                                   retain_graph=True)),
            compare_rows(compare_libs, "vxm_warp_bounded_bwd", [vol, shift, g],
                         [torch.empty_like(vol), torch.empty_like(shift)], [pvol, pshift], halo))
        row["bound_share"] = bound_ms / row["ms"]
        # the same on a smooth shift of the same bound, as a velocity field
        # gives: the lanes of a warp then share the sources that reach them
        sshift = torch.stack([smooth_field(rng, spatial, (5, 6, 7), halo / 2, "cuda")
                              for _ in range(batch)]).clamp_(-halo, halo)
        sgrid = (2.0 * (ndgrid(spatial, device="cuda") + sshift) / dims - 1.0).flip(-1)
        sgrid = sgrid.contiguous().requires_grad_()
        sout_cf = grid_sample_warp(vol_cf, sgrid)
        smooth = time_in_turns(dict(
            ms=lambda: warp_bounded_bwd(vol, sshift, g, halo),
            library_ms=lambda: torch.autograd.grad(sout_cf, (vol_cf, sgrid), g_cf,
                                                   retain_graph=True)))
        row["smooth_ms"], row["smooth_library_ms"] = smooth["ms"], smooth["library_ms"]
        log(json.dumps(row))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp_bounded_bwd kernel differs from its plain version "
                                 f"by {err} > {KERNEL_TOL} at {row['shape']} halo {halo}")
        if not repeatable:
            raise AssertionError(f"two launches of warp_bounded_bwd differ at {row['shape']}")
        if not scale > 100 * KERNEL_TOL:
            raise AssertionError(f"gradients of {scale} cannot show a {KERNEL_TOL} error")
        rows.append(row)
        del vol, shift, g, dvol, dshift, dvol2, dshift2, pvol, pshift, out_cf, grid, vol_cf
        del sshift, sgrid, sout_cf
    return rows


def smooth_field(rng, spatial, coarse, scale, device):
    """A smooth random displacement of about ``scale`` voxels."""
    disp = torch.from_numpy(scale * rng.standard_normal((*coarse, 3), dtype=np.float32))
    return resize(disp.to(device), [s / c for s, c in zip(spatial, coarse)],
                  new_shape=spatial)


def check_grads_gpu_vs_cpu(rng):
    """Gradients through warp_bounded and integrate_vec_batched on CUDA
    tensors (the backward kernel) against the same on CPU tensors, where
    VXM_WINDOW_HALO=1 sends the CPU through the bounded tier too. Fails if a
    gradient is None or zero, as it was before the warp had a backward."""
    spatial = (40, 48, 56)
    vol = rng.standard_normal((1, *spatial, 3), dtype=np.float32)
    shift = rng.uniform(-1, 1, size=(1, *spatial, 3)).astype(np.float32)
    vec = smooth_field(rng, spatial, (5, 6, 7), 8.0, "cpu")[None].numpy()
    w_out = rng.standard_normal((1, *spatial, 3), dtype=np.float32)

    def grads(device):
        v, s, u = (torch.from_numpy(a).to(device).requires_grad_() for a in (vol, shift, vec))
        w = torch.from_numpy(w_out).to(device)
        warp_bounded_bwd.launches = 0
        g_warp = torch.autograd.grad((warp_bounded(v, s, 1) * w).sum(), (v, s),
                                     allow_unused=True)
        g_int = torch.autograd.grad((warp_ops.integrate_vec_batched(u, 7) * w).sum(), (u,),
                                    allow_unused=True)
        return [None if x is None else x.cpu() for x in (*g_warp, *g_int)], \
            warp_bounded_bwd.launches

    gpu, gpu_launches = grads("cuda")
    with window_halo("1"):
        cpu, cpu_launches = grads("cpu")
    log(f"max|vec| {np.abs(vec).max():.3f} voxels; warp_bounded_bwd launches: "
        f"GPU {gpu_launches}, CPU {cpu_launches}")
    if gpu_launches == 0 or cpu_launches != 0:
        raise AssertionError("the GPU gradients did not come from the backward kernel alone")
    for name, a, b in zip(("warp dvol", "warp dshift", "integrate dvec"), gpu, cpu):
        if a is None or b is None:
            raise AssertionError(f"{name}: no gradient")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        log(f"{name}: GPU vs CPU max abs err {err:.4e}, max|grad| {scale:.4e}, "
            f"rel {err / max(scale, 1e-30):.4e} (tol {GRAD_GPU_CPU_RTOL})")
        if not scale > 0:
            raise AssertionError(f"{name}: zero gradient")
        if not err <= GRAD_GPU_CPU_RTOL * scale:
            raise AssertionError(f"{name}: GPU and CPU gradients differ")


def conv_bound(ci, co, vox, dtype, f32_rate=F32_CONV_FLOPS_PER_S):
    """The least time of one conv on the card: its operations,
    2 * 27 * ci * co per voxel, at the dense bf16 tensor-core rate or, in
    float32, ``f32_rate`` (three TF32 passes), or its bytes, x read and y
    written once. Returns (ms, bound_by, seconds of the bytes, seconds of the
    operations)."""
    t_bytes = (ci + co) * vox * (2 if dtype == torch.bfloat16 else 4) / HBM_BYTES_PER_S
    rate = BF16_TENSOR_FLOPS_PER_S if dtype == torch.bfloat16 else f32_rate
    t_ops = 2 * 27 * ci * co * vox / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        t_bytes, t_ops


def check_conv3(seed):
    """The conv kernel against its plain version at the full-width U-Net's
    conv shapes: the forward in both rounding orders and the input-gradient
    orientation (taps flipped, ci and co swapped, no bias or activation),
    within conv3.kernel_tolerance and bit-equal across two launches; times of
    the rounding order the main path uses; cuDNN's float32 in full float32,
    as the kernel computes. Returns the rows and the totals by (dtype,
    orientation) over the convs a register call (forward) and a train step
    (input gradient: all but the first) run."""
    with full_float32():
        return _check_conv3(seed)


def _check_conv3(seed):
    rows, totals = [], {}
    gen = torch.Generator(device="cuda").manual_seed(seed)  # data made on the card
    cl = torch.channels_last_3d  # the layout the U-Net keeps in conv-kernel mode
    for dtype in (torch.bfloat16, torch.float32):
        elem = 2 if dtype == torch.bfloat16 else 4
        for index, (D, H, W, ci, co) in enumerate(UNET_CONVS):
            vox = D * H * W
            x = torch.randn((1, ci, D, H, W), generator=gen, device="cuda").to(dtype).contiguous(
                memory_format=cl)
            g = torch.randn((1, co, D, H, W), generator=gen, device="cuda").to(dtype).contiguous(
                memory_format=cl)
            kernel = torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda") * \
                (2.0 / (27 * ci)) ** 0.5
            bias = 0.1 * torch.randn(co, generator=gen, device="cuda")
            flipped = kernel.flip(0, 1, 2).transpose(3, 4)
            path_order = not conv3.jax_kernel_takes(ci, co, D, H, W, elem, elem)
            # the forward as the U-Net calls it; the input gradient as the
            # backward calls it (conv3_input_grad flips the taps itself), its
            # plain version and cuDNN with the flipped, transposed taps
            cases = {
                "fwd": (x, kernel, bias, 0.2, [path_order, not path_order], (ci, co),
                        lambda order, x=x, kernel=kernel, bias=bias: conv3.conv3_same_cf(
                            x, kernel, bias, act_slope=0.2, round_conv_first=order)),
                "dx": (g, flipped, torch.zeros(ci, device="cuda"), None, [False], (co, ci),
                       lambda order, g=g, kernel=kernel: conv3.conv3_input_grad(g, kernel)),
            }
            for orientation, (inp, k, b, slope, orders, (c_in, c_out), launch) in \
                    cases.items():
                err = ratio = 0.0
                equal_share = 1.0
                repeatable = True
                for order in orders:
                    y = launch(order)
                    y2 = launch(order)
                    plain = conv3.conv3_same_cf_plain(inp, k, b, slope, None, order)
                    torch.cuda.synchronize()
                    diff = (y.float() - plain.float()).abs()
                    err = max(err, diff.max().item())
                    ratio = max(ratio, (diff / conv3.kernel_tolerance(plain, b, order)).max().item())
                    equal_share = min(equal_share, (y == plain).float().mean().item())
                    repeatable = repeatable and torch.equal(y, y2)
                    del y, y2, plain, diff
                order = orders[0]
                w_lib = k.permute(4, 3, 0, 1, 2).to(dtype).contiguous()
                b_lib = b.to(dtype)
                bound_ms, bound_by, t_bytes, t_ops = conv_bound(c_in, c_out, vox, dtype)
                # float32's bound at the CUDA-core rate (the bound stated before
                # the tensor-core kernel), for comparison
                cuda_core_ms = conv_bound(c_in, c_out, vox, dtype, F32_FLOPS_PER_S)[0]
                row = dict(
                    conv=index, orientation=orientation, dtype=str(dtype).split(".")[1],
                    shape=[1, c_in, D, H, W], co=c_out, round_conv_first=order,
                    max_abs_err=err, max_err_over_tol=ratio, equal_share=equal_share,
                    repeatable=repeatable,
                    ms=time_cuda_ms(lambda: launch(order)),
                    plain_ms=time_cuda_ms(lambda: conv3.conv3_same_cf_plain(
                        inp, k, b, slope, None, order), reps=3, warmup=1),
                    library_ms=time_cuda_ms(lambda: F.conv3d(inp, w_lib, b_lib, padding=1)),
                    bound_ms=bound_ms, bound_by=bound_by)
                log(json.dumps(row))
                if not ratio <= 1.0:
                    raise AssertionError(f"conv3 kernel differs from its plain version by "
                                         f"{ratio:.3f} of its tolerance at {row}")
                if not repeatable:
                    raise AssertionError(f"two launches of the conv3 kernel differ at {row}")
                # in bfloat16 the sums' order rarely flips a rounding (the
                # other rounding order differs in about a third of outputs)
                if dtype == torch.bfloat16 and not equal_share >= BF16_EQUAL_SHARE:
                    raise AssertionError(f"conv3 kernel equals its plain version on only "
                                         f"{equal_share:.4f} of the outputs at {row}")
                rows.append(row)
                if orientation == "fwd" or index > 0:
                    t = totals.setdefault((row["dtype"], orientation), dict(
                        convs=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        t_bytes=0.0, t_ops=0.0, cuda_core_bound_ms=0.0))
                    t["convs"] += 1
                    t["cuda_core_bound_ms"] += cuda_core_ms
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        t[key] += row[key]
                    t["t_bytes"] += t_bytes
                    t["t_ops"] += t_ops
            del x, g, kernel, flipped
    for (dtype, orientation), t in totals.items():
        t["bound_by"] = "bytes" if t.pop("t_bytes") >= t.pop("t_ops") else "operations"
        f32_note = (f"; at the float32 CUDA-core rate the bound was "
                    f"{t['cuda_core_bound_ms']:.4f} ms" if dtype == "float32" else "")
        t.pop("cuda_core_bound_ms")
        log(f"conv3 {dtype} {orientation}, {t['convs']} convs: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}{f32_note}), plain {t['plain_ms']:.4f} "
            f"ms, cuDNN {t['library_ms']:.4f} ms")
    return rows, totals


def default_recipe(inshape, flow_std=None):
    """scripts/train.py's default: MSE + Grad('l2', loss_mult=2), weight 0.01,
    on a float32 VxmDense with default features, initialised from seed 0.
    ``flow_std`` redraws the flow head's kernel as N(0, flow_std) (seed 1),
    for flows of about a voxel instead of the init's ~1e-5."""
    model = VxmDense(inshape, int_steps=7, int_resolution=2,
                     generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.flow.weight.normal_(0.0, flow_std,
                                      generator=torch.Generator().manual_seed(SEED + 1))
    terms = [LossTerm("y_source", losses.MSE(1.0).loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                      target_index=1, name="grad")]
    return model, terms


def one_step_grads(inshape, device, moving, fixed, flow_std=None):
    """Loss and parameter gradients of one train step of the default recipe
    (no update, ``flow_std`` as in ``default_recipe``), with the kernel
    launch counts of the step."""
    model, terms = default_recipe(inshape, flow_std)
    trainer = Trainer(model, terms, device=device)
    trainer.model.train()
    zero = torch.zeros((1, *inshape, 3), device=device)
    reset_launches()
    loss, _ = trainer.loss_fn((moving.to(device), fixed.to(device)), (fixed.to(device), zero))
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}
    return loss.item(), grads, read_launches()


def compare_grads(label, loss_a, grads_a, loss_b, grads_b, rtol):
    """Hold each gradient tensor of run a to run b within ``rtol`` of the
    tensor's largest magnitude; returns the largest relative error."""
    worst = abs(loss_a - loss_b) / abs(loss_b)
    log(f"{label}: loss {loss_a:.8f} vs {loss_b:.8f} (rel {worst:.3e})")
    for name in grads_b:
        scale = grads_b[name].abs().max().item()
        rel = (grads_a[name] - grads_b[name]).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, rel)
        if not (scale > 0 and rel <= rtol):
            raise AssertionError(f"{label}: {name} differs by {rel:.3e} of its max "
                                 f"{scale:.3e} (tol {rtol})")
    log(f"{label}: largest relative difference over loss and {len(grads_b)} gradient "
        f"tensors {worst:.4e} (tol {rtol})")
    return worst


def train_full_width(profile):
    """Phase 4: the default recipe at full width on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")

    # (a) the kernel path against the gather-only path, both on the card:
    # from the seed-0 init, and with the flow head redrawn for real flows
    for flow_std, rtol in ((None, TRAIN_INIT_KERNEL_VS_GATHER_RTOL),
                           (FLOW_STD, TRAIN_KERNEL_VS_GATHER_RTOL)):
        label = "seed-0 init" if flow_std is None else f"flow head N(0, {flow_std})"
        loss_k, grads_k, launches = one_step_grads(INSHAPE, "cuda", moving, fixed, flow_std)
        with window_halo("0"):
            loss_g, grads_g, launches_g = one_step_grads(INSHAPE, "cuda", moving, fixed,
                                                         flow_std)
        log(f"{label}: kernel launches {launches}, gather-only path {launches_g}")
        if launches["fwd"] == 0 or launches["bwd"] == 0 or launches_g["bwd"] != 0:
            raise AssertionError(f"kernel launches {launches}, gather-only {launches_g}")
        compare_grads(f"kernel vs gather-only, {label}, {INSHAPE}", loss_k, grads_k,
                      loss_g, grads_g, rtol)
        if flow_std is None:
            train_launches = launches
        del grads_k, grads_g

    # (b) the card against the port's CPU run, at half width; the CPU takes
    # the bounded tiers too (VXM_WINDOW_HALO=1), through the plain backward
    half = tuple(s // 2 for s in INSHAPE)
    mv_h, fx_h = smooth_pair(half, "cpu")
    for flow_std in (None, FLOW_STD):
        label = "seed-0 init" if flow_std is None else f"flow head N(0, {flow_std})"
        t0 = time.perf_counter()
        loss_c, grads_c, _ = one_step_grads(half, "cuda", mv_h, fx_h, flow_std)
        with window_halo("1"):
            loss_cpu, grads_cpu, _ = one_step_grads(half, "cpu", mv_h, fx_h, flow_std)
        log(f"one step at {half} on the CPU and the card: {time.perf_counter() - t0:.2f} s")
        compare_grads(f"GPU vs CPU, {label}, {half}", loss_c, grads_c, loss_cpu, grads_cpu,
                      TRAIN_GPU_VS_CPU_RTOL)

    # (c)-(e) ten steps from seed 0
    model, terms = default_recipe(INSHAPE)
    trainer = Trainer(model, terms, lr=1e-4, device="cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_losses, step_s, per_step = [], [], []
    for step in range(11):
        warp_bounded.launches = warp_bounded_bwd.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.train_step((moving, fixed), (fixed, zero))
        step_losses.append(metrics["loss"].item())  # synchronises
        step_s.append(time.perf_counter() - t0)
        per_step.append((warp_bounded.launches, warp_bounded_bwd.launches))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log("step losses: " + ", ".join(f"{x:.8f}" for x in step_losses))
    log("kernel launches per step (fwd, bwd): " + ", ".join(f"{a},{b}" for a, b in per_step))
    median_s = float(np.median(step_s[1:]))
    log(f"float32 train step, bs1, {INSHAPE}: median {median_s:.4f} s/step over "
        f"{len(step_s) - 1} steps after one warm-up ({step_s[0]:.3f} s); peak memory "
        f"allocated {peak_gb:.3f} GiB")
    if not all(np.isfinite(step_losses)):
        raise AssertionError("non-finite training loss")
    if not step_losses[-1] < step_losses[0]:
        raise AssertionError(f"ten steps did not lower the loss: {step_losses}")
    if any(b == 0 for _, b in per_step):
        raise AssertionError("a train step launched no warp_bounded_bwd kernel")
    if profile:
        profile_device("train step", lambda: trainer.train_step(
            (moving, fixed), (fixed, zero))["loss"].item(), rows=30)
        conv_library_times(trainer.model)
    return train_launches


def train_checkpoint_recipe():
    """Three steps of the committed checkpoint's own recipe: use_probs, NCC
    and KL (prior lambda 10, weight 0.01), bfloat16, from its weights."""
    model = load_model(str(CHECKPOINT), device="cuda")
    terms = [LossTerm("y_source", losses.NCC().loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.KL(10.0, INSHAPE).loss, weight=0.01,
                      target_index=1, name="kl")]
    trainer = Trainer(model, terms, lr=1e-4, device="cuda")
    trainer.load(str(CHECKPOINT))
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    for step in range(3):
        warp_bounded_bwd.launches = 0
        metrics = {k: v.item() for k, v in trainer.train_step((moving, fixed),
                                                              (fixed, zero)).items()}
        log(f"checkpoint recipe step {step}: {json.dumps(metrics)}; "
            f"warp_bounded_bwd launches {warp_bounded_bwd.launches}")
        if not all(np.isfinite(list(metrics.values()))):
            raise AssertionError("non-finite loss in the checkpoint recipe")
        if warp_bounded_bwd.launches == 0:
            raise AssertionError("the checkpoint recipe launched no warp_bounded_bwd kernel")


def train_conv_kernel(moving, fixed, profile):
    """Phase 4b: the default recipe (float32, TF32 off, flow head redrawn
    N(0, FLOW_STD)) with the conv kernel: one step against cuDNN mode, then
    three steps. Returns the launch counts of a step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for enabled in (True, False):
        with conv_kernel_mode(enabled):
            runs[enabled] = one_step_grads(INSHAPE, "cuda", moving, fixed, FLOW_STD)
    log(f"one step, conv kernel launches {runs[True][2]}, cuDNN mode {runs[False][2]}")
    expected = 2 * len(UNET_CONVS) - 1
    if runs[True][2]["conv"] != expected or runs[False][2]["conv"] != 0 or \
            runs[True][2]["bwd"] == 0:
        raise AssertionError(f"expected {expected} conv launches and warp launches per step")
    if runs[True][2]["layout_copies"] != 0:
        raise AssertionError(f"a train step copied conv inputs or cotangents to channels-last "
                             f"{runs[True][2]['layout_copies']} times")
    compare_grads(f"conv kernel vs cuDNN, flow head N(0, {FLOW_STD}), {INSHAPE}",
                  runs[True][0], runs[True][1], runs[False][0], runs[False][1],
                  TRAIN_CONV_KERNEL_VS_CUDNN_RTOL)
    del runs

    with conv_kernel_mode(True):
        model, terms = default_recipe(INSHAPE, FLOW_STD)
        trainer = Trainer(model, terms, lr=1e-4, device="cuda")
        zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        step_losses, step_s, per_step = [], [], []
        for _ in range(3):
            reset_launches()
            t0 = time.perf_counter()
            step_losses.append(trainer.train_step((moving, fixed), (fixed, zero))["loss"].item())
            step_s.append(time.perf_counter() - t0)
            per_step.append(read_launches())
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log("conv kernel step losses: " + ", ".join(f"{x:.8f}" for x in step_losses))
        log(f"conv kernel launches per step: {per_step}")
        log(f"float32 train step with the conv kernel, bs1, {INSHAPE}: " + ", ".join(
            f"{x:.4f}" for x in step_s) + f" s/step; peak memory allocated {peak_gb:.3f} GiB")
        if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
            raise AssertionError(f"three steps did not lower the loss: {step_losses}")
        if any(p["conv"] != expected or p["fwd"] == 0 or p["bwd"] == 0 for p in per_step):
            raise AssertionError(f"a step missed a kernel: {per_step}")
        if any(p["layout_copies"] != 0 for p in per_step):
            raise AssertionError(f"a step copied conv inputs to channels-last: {per_step}")
        if profile:
            profile_device("train step, conv kernel", lambda: trainer.train_step(
                (moving, fixed), (fixed, zero))["loss"].item(), rows=30)
    return per_step[-1]


def conv_library_times(model):
    """cuDNN's time for each 3x3x3 conv of the U-Net (the convs the Pallas
    conv kernel computes) at full width in bfloat16, forward and backward,
    beside the bound of their FLOPs at the dense bf16 tensor-core rate."""
    shapes = []
    hooks = [m.register_forward_hook(lambda m, i, o: shapes.append(
        (m.conv.in_channels, m.conv.out_channels, tuple(i[0].shape))))
        for m in model.modules() if isinstance(m, ConvBlock)]
    with torch.no_grad():
        model.eval()
        moving, fixed = smooth_pair(INSHAPE, "cuda")
        model(moving, fixed)
    for h in hooks:
        h.remove()
    total = dict(flops=0, fwd_ms=0.0, bwd_ms=0.0)
    for ci, co, shape in shapes:
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16, requires_grad=True)
        w = torch.randn((co, ci, 3, 3, 3), device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        out = F.conv3d(x, w, padding=1)
        g = torch.randn_like(out)
        flops = 2 * 27 * ci * co * int(np.prod(shape[2:]))
        fwd = time_cuda_ms(lambda: F.conv3d(x, w, padding=1))
        bwd = time_cuda_ms(lambda: torch.autograd.grad(out, (x, w), g, retain_graph=True))
        log(f"conv {ci}->{co} at {shape[2:]}: cuDNN bf16 fwd {fwd:.4f} ms, bwd {bwd:.4f} ms; "
            f"bound {flops / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms fwd, "
            f"{2 * flops / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms bwd")
        total["flops"] += flops
        total["fwd_ms"] += fwd
        total["bwd_ms"] += bwd
    log(f"U-Net convs ({len(shapes)}): cuDNN bf16 fwd {total['fwd_ms']:.4f} ms, "
        f"bwd {total['bwd_ms']:.4f} ms; {total['flops'] / 1e9:.3f} GFLOP fwd, bound "
        f"{total['flops'] / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms fwd, "
        f"{2 * total['flops'] / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms bwd")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="print profiler breakdowns of a register call and a train "
                             "step, with and without the conv kernel")
    parser.add_argument("--compare-warp-source", nargs="+", default=[], metavar="CU",
                        help="other copies of csrc/warp_bounded.cu to build and time "
                             "beside the package's warp kernels in phases 2 and 2b")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    # the serving path's own halo rule and conv dispatch, whatever the
    # environment says
    for name in ("VXM_WINDOW_HALO", "VXM_PALLAS_CONV", "VXM_XLA_DW_EINSUM"):
        os.environ.pop(name, None)
    torch.manual_seed(SEED)
    t_all = time.perf_counter()

    t = phase("1. device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t_build = time.perf_counter()
    build_logs = _build.build(force=True)
    log(f"built {sorted(build_logs)} in {time.perf_counter() - t_build:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if any(key in line for key in ("registers", "smem", "spill", "Compiling entry")):
                log(f"  {name}: {line.strip()}")
    compare_libs = build_compare_libraries(args.compare_warp_source)
    hmma = tensor_core_instructions("conv3")
    log(f"conv3: {hmma} tensor-core instructions (HMMA) in libconv3.so")
    if hmma == 0:
        raise AssertionError("the conv kernel has no tensor-core instructions")
    log(f"phase 1: {time.perf_counter() - t:.2f} s")

    t = phase("2. warp_bounded kernel vs plain version")
    warm_device()
    rows = check_warp_bounded(np.random.default_rng(SEED), compare_libs)
    log(f"phase 2: {time.perf_counter() - t:.2f} s")

    t = phase("2b. warp_bounded backward kernel vs plain version")
    bwd_rows = check_warp_bounded_bwd(np.random.default_rng(SEED + 1), compare_libs)
    log(f"phase 2b: {time.perf_counter() - t:.2f} s")

    t = phase("2c. gradients through the bounded warp: GPU vs CPU")
    check_grads_gpu_vs_cpu(np.random.default_rng(SEED + 2))
    log(f"phase 2c: {time.perf_counter() - t:.2f} s")

    t = phase("2d. conv3 kernel vs plain version")
    conv_rows, conv_totals = check_conv3(SEED + 3)
    log(f"phase 2d: {time.perf_counter() - t:.2f} s")

    t = phase("3. VxmDense registration at full width")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model, launches, moved, warp = register_full_width(moving, fixed)
    if args.profile:
        profile_call(model, moving, fixed)
    del model
    bf16_vs_cpu(moved, warp, moving, fixed)
    bf16_vs_f32(moved, warp, *register_f32_vs_cpu(moving, fixed))
    log(f"phase 3: {time.perf_counter() - t:.2f} s")

    t = phase("3b. VxmDense registration with the conv kernel")
    conv_launches, conv_ms = register_conv_kernel(moving, fixed)
    if args.profile:
        with conv_kernel_mode(True):
            profile_call(load_model(str(CHECKPOINT), device="cuda"), moving, fixed)
    log(f"phase 3b: {time.perf_counter() - t:.2f} s")

    t = phase("3c. --fast-warp at full width")
    fast_launches, _ = fast_warp_check(moving, fixed)
    log(f"phase 3c: {time.perf_counter() - t:.2f} s")

    t = phase("4. VxmDense training at full width")
    train_launches = train_full_width(args.profile)
    train_checkpoint_recipe()
    log(f"phase 4: {time.perf_counter() - t:.2f} s")

    t = phase("4b. VxmDense training with the conv kernel")
    conv_train_launches = train_conv_kernel(moving, fixed, args.profile)
    log(f"phase 4b: {time.perf_counter() - t:.2f} s")

    paths = {"register": launches, "train_step": train_launches,
             "register_conv": conv_launches, "register_fast_warp": fast_launches,
             "train_step_conv": conv_train_launches}
    serving, serving_bwd = rows[0], bwd_rows[0]
    conv_serving = conv_totals[("bfloat16", "fwd")]
    conv_train = {key: conv_totals[("float32", "fwd")][key] + conv_totals[("float32", "dx")][key]
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [dict(
        name="warp_bounded_fwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:269",
        launches=train_launches["fwd"],
        launches_by_path={path: n["fwd"] for path, n in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], bound_share=serving["bound_share"],
        library_ms=serving["library_ms"]), dict(
        name="warp_bounded_bwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:952",
        launches=train_launches["bwd"],
        launches_by_path={path: n["bwd"] for path, n in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        ms=serving_bwd["ms"], plain_ms=serving_bwd["plain_ms"],
        bound_ms=serving_bwd["bound_ms"], bound_by=serving_bwd["bound_by"],
        bound_share=serving_bwd["bound_share"], library_ms=serving_bwd["library_ms"]), dict(
        # times: the 11 forward convs of a bfloat16 register call, summed;
        # train_step_conv: the 11 forward and 10 input-gradient convs of a
        # float32 train step
        name="conv3_fwd", route="cuda", source="voxelmorph_tpu_torch/csrc/conv3.cu",
        replaces="voxelmorph_tpu/ops/pallas_conv.py:124",
        launches=conv_train_launches["conv"],
        launches_by_path={path: n["conv"] for path, n in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in conv_rows),
        max_err_over_tol=max(r["max_err_over_tol"] for r in conv_rows),
        ms=conv_serving["ms"], plain_ms=conv_serving["plain_ms"],
        bound_ms=conv_serving["bound_ms"], bound_by=conv_serving["bound_by"],
        library_ms=conv_serving["library_ms"], register_conv_ms_per_pair=conv_ms,
        train_step_conv=conv_train, tensor_core_instructions=hmma)]
    log(f"\ntotal {time.perf_counter() - t_all:.2f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
