#!/usr/bin/env python3
"""Build and drive the PyTorch port (voxelmorph_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --profile  # also print a profiler breakdown of one call
    python3 chip_smoke.py --compare-warp-source OLD/warp_bounded.cu
        # also time another build of the warp kernels (an earlier commit's
        # csrc/warp_bounded.cu) on phases 2 and 2b's inputs
    python3 chip_smoke.py --compare-gather-source OLD/warp_gather.cu
        # also time an earlier commit's gather kernels on phase 2e's inputs

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
  2e. the tiered warp's predicated kernels at each tier of {1, 2} at the
     squaring shape, 1 to 4 channels: every branch launched with the
     device's tier word into its own NaN-filled buffer (the gather's dvol,
     which it adds into, zeroed where it is named), only the named one
     writing, equal to the unpredicated kernel or the torch gather
     (forward and dshift bit for bit, the gather's dvol within 1e-5);
     transform_batched forward and backward through them, with its device
     work counters; its time against the host-chosen call's, the time of a
     launch that returns at once, and the gather kernels against the torch
     gather and grid_sample, on a smooth field and a rough one, with the
     backward's atomic adds and the terms it merged into a neighbouring
     lane's add, and beside any --compare-gather-source build;
  2e(i). (after phase 3) the gather kernels at the serving warp's shape,
     160x192x224 with one channel, on a smooth field of the max|d| of
     phase 3's final warp and on that flow itself, as in 2e;
  3. the serving path end to end: the committed full-width VxmDense
     checkpoint (160x192x224, bfloat16) registers a synthetic smooth pair
     through build_register_fn; the work counters of that call must show a
     bounded kernel running and each tiered warp running exactly one of its
     branches (as in every path below that gates them), and its outputs
     must agree with the port's own bfloat16 CPU run; then the same in
     float32 (TF32 off) against the port's own CPU run, and the bfloat16
     outputs against the float32 ones;
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
     step (11 forward, 10 input gradients) and no layout copy;
  5. semi-supervised segmentation training at full width: the recipe of
     scripts/train_semisupervised_seg.py (MSE + Grad-l2 + Dice, Adam 1e-4,
     float32) on VxmDenseSemiSupervisedSeg from seed 0, with a synthetic
     30-label map (a Voronoi partition of the head mask) one-hot at half
     resolution as generators.semisupervised gives it: one step's loss and
     gradients on the card against the port's CPU run at 80x96x112; the
     segmentation warp (30 channels: the gather) launching no kernel; three
     steps in cuDNN mode and three with the conv kernel (flow head redrawn,
     as in 4b) that lower the loss, the first launching what phases 4 and
     4b's VxmDense step from the same weights launches, seconds per step and
     peak memory;
     then the warp of a 40-label one-hot at 80x96x112 (the wide-channel
     gather), value and flow gradient, against the CPU;
  5b. the warp ops on the card against the port's CPU run: transform with
     affine matrices, compose, integrate_vec (ss, quadrature, ode),
     jacobian_determinant, and cli/warp at full width with a dense warp and
     with an affine;
  6. point-cloud semi-supervised training at full width: the recipe of
     scripts/train_semisupervised_pointcloud.py with --surf-bidir (MSE both
     ways at 0.5, Grad-l2 at 0.01, the SDT terms at 0.25, Adam 1e-4,
     float32, 5000 surface points of 4 of phase 5's 30 labels a step) on
     VxmDenseSemiSupervisedPointCloud: generators.surf_semisupervised on the
     card against the CPU at 80x96x112 (8 labels), bit for bit; one step's
     loss and gradients on the card against the CPU there; the generator's
     seconds per draw at full width on the card; three steps in cuDNN mode
     and three with the conv kernel (flow head redrawn) that lower the loss,
     with their launches, seconds and peak memory; the checkpoint registered
     through cli/register via registration_model;
  6b. --cache-device and --steps-per-dispatch: Trainer.fit_cached_pairs on 4
     full-width volumes held on the card, one 4-step dispatch against 4
     single steps from the same weights on the same picks (params bit-equal
     with cudnn.deterministic, else within 1e-6 of their largest
     magnitude), 1 host fetch of metrics against 4, seconds per step; then
     phase 4's step with and without the rematerialised integration
     (gradients bit-equal; peak memory and seconds per step);
  6c. a 2-D VxmDense on the pair's middle slice (192x224): one step's
     gradients and three steps and a register call, card against CPU, no
     kernel launched; a 3-D VxmDense with do_res and a tanh final activation
     at full width, bfloat16 and float32, conv kernel against cuDNN mode,
     every conv launched with the activation off;
  6d. Trainer.fit with prefetch and without, of the point-cloud recipe
     from its generator on the card (on its own stream) and of cli/train's
     default from scan_to_scan over npz files: the parameters bit-equal,
     seconds per step of each, and the seconds of each part of one
     point-cloud draw (components, blur, EDT, x2 zoom, point draws);
  6e. the U-Net's per-block remat on and off in phase 4's step, cuDNN and
     conv-kernel mode: gradients bit-equal (cudnn.deterministic), conv
     launches, peak memory and seconds per step;
  7. a full-width register call and one float32 train step of the default
     recipe, the flow head redrawn until the warps take all three tiers
     (VXM_WINDOW_HALO=2; the tier of each warp read from the work counters
     around its launches), in cuDNN and conv-kernel mode, each under
     torch.cuda.set_sync_debug_mode("error"): any host synchronisation in
     them fails the run.
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
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from voxelmorph_tpu_torch import _build, generators, losses
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import warp as warp_cli
from voxelmorph_tpu_torch.models.modelio import load_model
from voxelmorph_tpu_torch.models.unet import ConvBlock
from voxelmorph_tpu_torch.models.vxm import (VxmDense, VxmDenseSemiSupervisedPointCloud,
                                             VxmDenseSemiSupervisedSeg)
from voxelmorph_tpu_torch.ops import conv3, interp
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.ops import warp_bounded as warp_bounded_ops
from voxelmorph_tpu_torch.ops import warp_gather as warp_gather_ops
from voxelmorph_tpu_torch.ops.interp import ndgrid, resize
from voxelmorph_tpu_torch.ops.warp_bounded import (warp_bounded, warp_bounded_bwd,
                                                   warp_bounded_bwd_plain, windowed_transform)
from voxelmorph_tpu_torch.ops.warp_gather import (launch_gather_bwd, launch_gather_fwd,
                                                  warp_gather_bwd_plain, warp_gather_plain)
from voxelmorph_tpu_torch.py.utils import load_volfile
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

# the semi-supervised recipe's labels: a 30-label map, as the repository's
# semi-supervised quality run used; the wide-channel check takes 40, the
# fewest whose one-hot corner table at 80x96x112 passes the gather's limit
SEMI_LABELS = 30
WIDE_LABELS = 40
# the warp ops, card against CPU, relative to the largest magnitude: the
# same float32 operations, whose sums (matrix products, the channel sum of
# the wide gather's coordinate gradient) run in other orders
WARP_OPS_RTOL = 1e-5

# the point-cloud recipe (scripts/train_semisupervised_pointcloud.py with
# --surf-bidir): 5000 surface points of 4 of the map's labels a step; its
# generator, card against CPU at half width, on the map's first 8 labels
# (the atlas's SDTs are computed for every label the run uses)
SURF_POINTS = 5000
POINT_LABELS_SAMPLED = 4
POINT_CPU_LABELS = 8
# K, the steps of one --steps-per-dispatch dispatch in phase 6b, and the
# largest difference of its params from single steps', relative to each
# tensor's largest magnitude, where the run is not bit-equal
DISPATCH_STEPS = 4
DISPATCH_RTOL = 1e-6
# the least share of bf16 conv outputs the kernel and its plain version agree
# on bit for bit in the same rounding order
BF16_EQUAL_SHARE = 0.99

# (D, H, W, ci, co) of the full-width U-Net's 11 conv blocks, in the order of
# the forward; the first block's input (the image pair) needs no gradient
UNET_CONVS = [(160, 192, 224, 2, 16), (80, 96, 112, 16, 32), (40, 48, 56, 32, 32),
              (20, 24, 28, 32, 32), (10, 12, 14, 32, 32), (20, 24, 28, 64, 32),
              (40, 48, 56, 64, 32), (80, 96, 112, 64, 32), (160, 192, 224, 48, 32),
              (160, 192, 224, 32, 16), (160, 192, 224, 16, 16)]


# conv launches of a train step in conv-kernel mode: the U-Net's 11 forward
# convs, their recomputation in the backward (the per-block remat), and the
# input gradients of all but the first
TRAIN_STEP_CONVS = 3 * len(UNET_CONVS) - 1
# the tiers {1, H} of the predicated-warp checks (phase 2e and phase 7):
# with H = 2 a warp has three branches, the halo-1 and halo-2 bounded
# kernels and the gather
TIER_HALO = 2
# the gather kernel's dvol against the torch gather's (index_put with
# atomics on the card): the same float32 terms summed in other orders,
# relative to the largest |dvol|
GATHER_DVOL_RTOL = 1e-5


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
    launch_gather_fwd.launches = launch_gather_bwd.launches = 0
    conv3.conv3_same_cf.layout_copies = 0
    warp_bounded_ops.reset_work()


def read_launches():
    """Launches of each kernel since reset_launches; of the warp kernels
    also the launches that ran past their tier word (the device counters,
    one fetch); and the conv wrapper's layout copies."""
    work = warp_bounded_ops.read_work()
    return {"fwd": warp_bounded.launches, "bwd": warp_bounded_bwd.launches,
            "gather_fwd": launch_gather_fwd.launches, "gather_bwd": launch_gather_bwd.launches,
            "fwd_ran": work["warp_bounded_fwd"], "bwd_ran": work["warp_bounded_bwd"],
            "gather_fwd_ran": work["warp_gather_fwd"],
            "gather_bwd_ran": work["warp_gather_bwd"],
            "conv": conv3.conv3_same_cf.launches,
            "layout_copies": conv3.conv3_same_cf.layout_copies}


def check_warp_work(counts, label, backward=True):
    """Fail unless ``counts`` (read_launches) show the tiered warps of a run
    doing their work: a bounded kernel ran past its tier word, and each
    tiered warp ran exactly one of its branches (a warp launches the gather
    kernel once, so the bounded and gather launches that ran add up to the
    gather's launches); with ``backward`` the backward kernels too. The
    launch counts alone cannot show this: every tiered warp launches every
    branch."""
    for bounded, gather in (("fwd", "gather_fwd"), ("bwd", "gather_bwd"))[:1 + backward]:
        ran = counts[f"{bounded}_ran"], counts[f"{gather}_ran"]
        if ran[0] == 0 or sum(ran) != counts[gather]:
            raise AssertionError(f"{label}: of {counts[gather]} tiered warps {ran[0]} ran a "
                                 f"bounded {bounded} kernel and {ran[1]} the gather: {counts}")


def no_warp_launches(counts):
    """True where ``counts`` (read_launches) hold no warp kernel launch."""
    return not any(v for k, v in counts.items() if k not in ("conv", "layout_copies"))


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


def build_compare_libraries(builds, stem):
    """Build other copies of a kernel source: ``builds`` lists (label,
    source, extra nvcc flags), an earlier commit's copy unpacked outside the
    package or the package's own with -D flags; each is built with the
    package's nvcc flags plus its own, all at once, into the build
    directory. Returns {label: ctypes library}."""
    out = _build.library_path(stem).parent / "compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, src, flags) in enumerate(builds):
        lib = out / f"lib{stem}_{i}.so"
        procs[label] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
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
    err = fn(*(t.data_ptr() for t in tensors), B, D, H, W, C, halo, None, 0, None,
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
    img, fixed, _ = smooth_pair_and_disp(spatial, device)
    return img, fixed


def smooth_pair_and_disp(spatial, device):
    """``smooth_pair`` and the displacement that warps one into the other."""
    rng = np.random.default_rng(SEED)
    coarse = torch.from_numpy(
        rng.standard_normal((10, 12, 14, 1), dtype=np.float32)).to(device)
    img = resize(coarse, [s / c for s, c in zip(spatial, (10, 12, 14))], new_shape=spatial)
    img = (img - img.min()) / (img.max() - img.min())
    disp = torch.from_numpy(
        3.0 * rng.standard_normal((5, 6, 7, 3), dtype=np.float32)).to(device)
    disp = resize(disp, [s / c for s, c in zip(spatial, (5, 6, 7))], new_shape=spatial)
    fixed = warp_ops.transform(img, disp, window_halo=None)
    return img[None], fixed[None], disp


def voronoi_labels(img, nb_labels, seed):
    """A label map of ``img`` ``(*S, 1)``: the head mask (intensity above
    0.3) split among ``nb_labels`` seeded centres inside it (each voxel
    takes its nearest centre's label, 1 to nb_labels), 0 outside.
    Returns int32 ``(*S,)`` on img's device."""
    spatial = img.shape[:-1]
    mask = img[..., 0] > 0.3
    flat = np.flatnonzero(mask.cpu().numpy())
    picks = np.random.default_rng(seed).choice(flat, nb_labels, replace=False)
    centres = torch.from_numpy(np.stack(np.unravel_index(picks, spatial), -1)).to(
        img.device, torch.float32)
    grid = ndgrid(spatial, device=img.device).reshape(-1, 3)
    nearest = torch.cdist(grid, centres, compute_mode="donot_use_mm_for_euclid_dist")
    nearest = nearest.argmin(dim=-1).reshape(spatial)
    return torch.where(mask, nearest + 1, 0).to(torch.int32)


def labelled_pair(spatial, device):
    """smooth_pair with SEMI_LABELS-label maps: the moving scan's Voronoi
    labels, and the fixed scan's, carried by the pair's displacement
    (nearest). Returns (moving, fixed, moving labels, fixed labels)."""
    moving, fixed, disp = smooth_pair_and_disp(spatial, device)
    src = voronoi_labels(moving[0], SEMI_LABELS, SEED + 5)
    trg = warp_ops.transform(src.float(), disp, interp_method="nearest",
                             window_halo=None).round().to(torch.int32)
    return moving, fixed, src, trg


def semi_batch(spatial, device):
    """The semi-supervised generator's batch on labelled_pair: (src, trg,
    src_seg), (trg, zero flow, trg_seg), the segs one-hot over SEMI_LABELS
    labels at half resolution (generators._one_hot_seg, downsize 2)."""
    moving, fixed, src, trg = labelled_pair(spatial, device)
    labels = np.arange(1, SEMI_LABELS + 1)
    segs = [torch.from_numpy(np.ascontiguousarray(generators._one_hot_seg(
        s.cpu().numpy()[None, ..., None], labels, downsize=2))).to(device) for s in (src, trg)]
    zero = torch.zeros((1, *spatial, 3), device=device)
    return (moving, fixed, segs[0]), (fixed, zero, segs[1])


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
    check_warp_work(launches, "the serving path", backward=False)
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
        reset_launches()
        t0 = time.perf_counter()
        moved, warp = build_register_fn(model)(moving.to(device), fixed.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_launches()
        log(f"float32 on {device}: {time.perf_counter() - t0:.3f} s, warp_bounded launches "
            f"{counts['fwd']}, of which {counts['fwd_ran']} ran")
        if device == "cuda":
            check_warp_work(counts, "the float32 register call", backward=False)
        elif not no_warp_launches(counts):
            raise AssertionError(f"the CPU run launched warp kernels: {counts}")
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
        if launches["conv"] != len(UNET_CONVS):
            raise AssertionError(f"expected {len(UNET_CONVS)} conv launches, got {launches}")
        check_warp_work(launches, "the conv-kernel register call", backward=False)
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
        # the bounded launches that ran: in the plain call, the kernel-tier
        # squarings and the final warp where max|warp| <= 1 (the halo-1
        # tier); in the fast call, the same squarings and 4 halo-2 phase
        # warps
        squarings = out["plain"][2]["fwd_ran"] - int(
            out["plain"][1].abs().max().item() <= 1.0)
        return out["fast"][2]["fwd_ran"] - squarings

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
        reset_launches()
        g_warp = torch.autograd.grad((warp_bounded(v, s, 1) * w).sum(), (v, s),
                                     allow_unused=True)
        g_int = torch.autograd.grad((warp_ops.integrate_vec_batched(u, 7) * w).sum(), (u,),
                                    allow_unused=True)
        counts = read_launches()
        return [None if x is None else x.cpu() for x in (*g_warp, *g_int)], \
            counts["bwd_ran" if device == "cuda" else "bwd"]

    gpu, gpu_launches = grads("cuda")
    with window_halo("1"):
        cpu, cpu_launches = grads("cpu")
    log(f"max|vec| {np.abs(vec).max():.3f} voxels; warp_bounded_bwd launches that ran on "
        f"the GPU {gpu_launches}, launches on the CPU {cpu_launches}")
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
    conv shapes: the forward in both rounding orders, the forward with the
    activation off and a non-zero bias (``do_res`` blocks), and the
    input-gradient orientation (taps flipped, ci and co swapped, no bias or
    activation),
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
                # the activation off with a bias: the mode of a do_res block
                # and of a block before a final activation
                "fwd_act_off": (x, kernel, bias, None, [path_order], (ci, co),
                                lambda order, x=x, kernel=kernel, bias=bias: conv3.conv3_same_cf(
                                    x, kernel, bias, act_slope=None, round_conv_first=order)),
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
                if orientation != "dx" or index > 0:
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
    zero = torch.zeros((1, *inshape, 3))
    return recipe_step_grads(default_recipe, inshape, device, ((moving, fixed), (fixed, zero)),
                             flow_std)


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
        check_warp_work(launches, f"the kernel path, {label}")
        if not no_warp_launches(launches_g):
            raise AssertionError(f"the gather-only path launched warp kernels: {launches_g}")
        compare_grads(f"kernel vs gather-only, {label}, {INSHAPE}", loss_k, grads_k,
                      loss_g, grads_g, rtol)
        if flow_std is None:
            train_launches = launches
        else:
            redrawn_launches = launches
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
        reset_launches()
        t0 = time.perf_counter()
        metrics = trainer.train_step((moving, fixed), (fixed, zero))
        step_losses.append(metrics["loss"].item())  # synchronises
        step_s.append(time.perf_counter() - t0)
        per_step.append(read_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log("step losses: " + ", ".join(f"{x:.8f}" for x in step_losses))
    log("bounded kernel launches per step, forward/ran and backward/ran: " + ", ".join(
        f"{p['fwd']}/{p['fwd_ran']} {p['bwd']}/{p['bwd_ran']}" for p in per_step))
    median_s = float(np.median(step_s[1:]))
    log(f"float32 train step, bs1, {INSHAPE}: median {median_s:.4f} s/step over "
        f"{len(step_s) - 1} steps after one warm-up ({step_s[0]:.3f} s); peak memory "
        f"allocated {peak_gb:.3f} GiB")
    if not all(np.isfinite(step_losses)):
        raise AssertionError("non-finite training loss")
    if not step_losses[-1] < step_losses[0]:
        raise AssertionError(f"ten steps did not lower the loss: {step_losses}")
    for step, counts in enumerate(per_step):
        check_warp_work(counts, f"train step {step}")
    if profile:
        profile_device("train step", lambda: trainer.train_step(
            (moving, fixed), (fixed, zero))["loss"].item(), rows=30)
        conv_library_times(trainer.model)
    return train_launches, redrawn_launches


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
        reset_launches()
        metrics = {k: v.item() for k, v in trainer.train_step((moving, fixed),
                                                              (fixed, zero)).items()}
        counts = read_launches()
        log(f"checkpoint recipe step {step}: {json.dumps(metrics)}; "
            f"warp_bounded_bwd launches {counts['bwd']}, of which {counts['bwd_ran']} ran")
        if not all(np.isfinite(list(metrics.values()))):
            raise AssertionError("non-finite loss in the checkpoint recipe")
        check_warp_work(counts, f"checkpoint recipe step {step}")


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
    expected = TRAIN_STEP_CONVS
    if runs[True][2]["conv"] != expected or runs[False][2]["conv"] != 0:
        raise AssertionError(f"expected {expected} conv launches per step")
    for enabled, run in runs.items():
        check_warp_work(run[2], f"one step, conv kernel {enabled}")
    if runs[True][2]["layout_copies"] != 0:
        raise AssertionError(f"a train step copied conv inputs or cotangents to channels-last "
                             f"{runs[True][2]['layout_copies']} times")
    compare_grads(f"conv kernel vs cuDNN, flow head N(0, {FLOW_STD}), {INSHAPE}",
                  runs[True][0], runs[True][1], runs[False][0], runs[False][1],
                  TRAIN_CONV_KERNEL_VS_CUDNN_RTOL)
    one_step_launches = runs[True][2]
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
        if any(p["conv"] != expected for p in per_step):
            raise AssertionError(f"a step missed a kernel: {per_step}")
        for counts in per_step:
            check_warp_work(counts, "a conv-kernel train step")
        if any(p["layout_copies"] != 0 for p in per_step):
            raise AssertionError(f"a step copied conv inputs to channels-last: {per_step}")
        if profile:
            profile_device("train step, conv kernel", lambda: trainer.train_step(
                (moving, fixed), (fixed, zero))["loss"].item(), rows=30)
    return per_step[-1], one_step_launches


def semi_recipe(inshape, flow_std=None):
    """scripts/train_semisupervised_seg.py's default: MSE + Grad('l2',
    loss_mult=2) at weight 0.01 + Dice at weight 0.01, on a float32
    VxmDenseSemiSupervisedSeg of SEMI_LABELS labels with default features,
    initialised from seed 0 (its VxmDense draws as default_recipe's);
    ``flow_std`` redraws the flow head as default_recipe does."""
    model = VxmDenseSemiSupervisedSeg(inshape, nb_labels=SEMI_LABELS, int_steps=7,
                                      int_resolution=2,
                                      generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    terms = [LossTerm("y_source", losses.MSE().loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                      target_index=1, name="grad"),
             LossTerm("y_seg_source", losses.Dice().loss, weight=0.01, target_index=2,
                      name="dice")]
    return model, terms


def recipe_step_grads(recipe, inshape, device, batch, flow_std=None):
    """Loss and parameter gradients of one train step of ``recipe`` (no
    update), with the kernel launch counts of the step."""
    model, terms = recipe(inshape, flow_std)
    trainer = Trainer(model, terms, device=device)
    trainer.model.train()
    inputs, targets = (tuple(a.to(device) for a in part) for part in batch)
    reset_launches()
    loss, _ = trainer.loss_fn(inputs, targets)
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}
    return loss.item(), grads, read_launches()


def find_node(tensor, name):
    """Whether the autograd graph of ``tensor`` holds a node called ``name``."""
    seen, todo = set(), [tensor.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            return True
        todo.extend(f for f, _ in node.next_functions)
    return False


def train_semisupervised(one_step_launches, smi):
    """Phase 5: the semi-supervised recipe at full width on the card.
    ``one_step_launches`` maps conv-kernel mode (False, True) to the
    launches of one VxmDense step of phases 4 and 4b from the same weights
    (seed 0, flow head redrawn N(0, FLOW_STD)) on the same pair. Returns the
    launch counts of a step in cuDNN mode and in conv-kernel mode."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # (a) the card against the port's CPU run at half width, flows of about
    # a voxel; the CPU takes the bounded tiers too (VXM_WINDOW_HALO=1)
    half = tuple(s // 2 for s in INSHAPE)
    batch_h = semi_batch(half, "cpu")
    t0 = time.perf_counter()
    loss_c, grads_c, _ = recipe_step_grads(semi_recipe, half, "cuda", batch_h, FLOW_STD)
    with window_halo("1"):
        loss_cpu, grads_cpu, _ = recipe_step_grads(semi_recipe, half, "cpu", batch_h, FLOW_STD)
    log(f"semi-supervised step at {half} on the CPU and the card: "
        f"{time.perf_counter() - t0:.2f} s")
    compare_grads(f"semi-supervised GPU vs CPU, flow head N(0, {FLOW_STD}), {half}",
                  loss_c, grads_c, loss_cpu, grads_cpu, TRAIN_GPU_VS_CPU_RTOL)
    del grads_c, grads_cpu, batch_h

    # (b) the segmentation warp alone, forward and backward, launches no
    # kernel: its 30 channels take the gather
    inputs, targets = semi_batch(INSHAPE, "cuda")
    log(f"segmentations {tuple(inputs[2].shape)} one-hot; labels present in the source: "
        f"{int((inputs[2].sum(dim=(0, 1, 2, 3)) > 0).sum().item())} of {SEMI_LABELS}")
    seg_flow = smooth_field(np.random.default_rng(SEED + 9), tuple(inputs[2].shape[1:4]),
                            (5, 6, 7), 1.0, "cuda")[None].requires_grad_()
    reset_launches()
    torch.autograd.grad(warp_ops.transform_batched(inputs[2], seg_flow).sum(), seg_flow)
    torch.cuda.synchronize()
    seg_warp_launches = read_launches()
    log(f"segmentation warp alone, forward and backward: launches {seg_warp_launches}")
    if any(seg_warp_launches.values()):
        raise AssertionError("the 30-channel segmentation warp launched a kernel")

    # (c) three steps (flow head redrawn, as phase 4b) in cuDNN mode and
    # with the conv kernel
    per_mode = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            model, terms = semi_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            step_losses, dices, step_s, per_step = [], [], [], []
            for _ in range(3):
                reset_launches()
                t0 = time.perf_counter()
                metrics = trainer.train_step(inputs, targets)
                step_losses.append(metrics["loss"].item())  # synchronises
                step_s.append(time.perf_counter() - t0)
                dices.append(metrics["dice"].item())
                per_step.append(read_launches())
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"semi-supervised, {mode}: step losses " + ", ".join(
            f"{x:.8f}" for x in step_losses) + "; dice " + ", ".join(f"{x:.6f}" for x in dices))
        log(f"semi-supervised, {mode}: launches per step {per_step}; a VxmDense step from "
            f"the same weights {one_step_launches[enabled]}")
        log(f"float32 semi-supervised train step, {mode}, bs1, {INSHAPE}, {SEMI_LABELS} labels: "
            + ", ".join(f"{x:.4f}" for x in step_s) + f" s/step (median of the last two "
            f"{float(np.median(step_s[1:])):.4f}); peak memory allocated {peak_gb:.3f} GiB; {smi}")
        if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
            raise AssertionError(f"three semi-supervised steps ({mode}) did not lower the "
                                 f"loss: {step_losses}")
        if not all(np.isfinite(d) and -1.0 <= d <= 0.0 for d in dices):
            raise AssertionError(f"the dice term left [-1, 0]: {dices}")
        # the first step launches what a VxmDense step from the same weights
        # launches (phases 4 and 4b); every step launches both warp kernels
        # and, in kernel mode, the U-Net's 21 convs
        convs = TRAIN_STEP_CONVS if enabled else 0
        if per_step[0] != {**one_step_launches[enabled], "conv": convs}:
            raise AssertionError(f"the first semi-supervised step launched {per_step[0]}, a "
                                 f"VxmDense step {one_step_launches[enabled]}")
        if any(p["conv"] != convs or p["layout_copies"] != 0 for p in per_step):
            raise AssertionError(f"a semi-supervised step missed a kernel: {per_step}")
        for counts in per_step:
            check_warp_work(counts, f"a semi-supervised step, {mode}")
        per_mode[enabled] = per_step[-1]
        del trainer, model
    return per_mode[False], per_mode[True]


def wide_seg_warp_check(rng):
    """Phase 5, last gate: the warp of a WIDE_LABELS-label one-hot at
    80x96x112 by a smooth flow (its corner table passes the gather's limit,
    so it takes the wide-channel path), value and flow gradient on the card
    against the CPU."""
    half = tuple(s // 2 for s in INSHAPE)
    moving = smooth_pair(half, "cpu")[0]
    seg = voronoi_labels(moving[0], WIDE_LABELS, SEED + 6)[None, ..., None].numpy()
    onehot = torch.from_numpy(np.ascontiguousarray(generators._one_hot_seg(
        seg, np.arange(1, WIDE_LABELS + 1))))
    table_bytes = int(np.prod(half)) * 8 * WIDE_LABELS * 4
    if not table_bytes > interp._CORNER_TABLE_BYTES_LIMIT:
        raise AssertionError(f"a corner table of {table_bytes} bytes takes the table path")
    flow = smooth_field(rng, half, (5, 6, 7), 3.0, "cpu")[None]
    w = torch.from_numpy(rng.standard_normal(onehot.shape, dtype=np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        f = flow.to(device).requires_grad_()
        t0 = time.perf_counter()
        out = warp_ops.transform_batched(onehot.to(device), f)
        if not find_node(out, "_LinearGatherWideBackward"):
            raise AssertionError(f"the {WIDE_LABELS}-label warp on {device} did not take the "
                                 "wide-channel gather")
        g, = torch.autograd.grad((out * w.to(device)).sum(), f)
        results[device] = (out.detach().cpu(), g.cpu())
        log(f"{WIDE_LABELS}-label one-hot warp at {half} on {device} (wide-channel gather, "
            f"corner table {table_bytes} B): {time.perf_counter() - t0:.3f} s")
    for name, a, b in zip(("value", "flow gradient"), results["cuda"], results["cpu"]):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        log(f"wide seg warp {name}: GPU vs CPU max abs err {err:.3e}, max {scale:.3e}, rel "
            f"{err / scale:.3e} (tol {WARP_OPS_RTOL})")
        if not (scale > 0 and err <= WARP_OPS_RTOL * scale):
            raise AssertionError(f"the wide seg warp's {name} differs on the card")


def card_vs_cpu(label, fn, *arrays):
    """``fn`` on CUDA copies of ``arrays`` against ``fn`` on the CPU, within
    WARP_OPS_RTOL of the CPU result's largest magnitude."""
    t0 = time.perf_counter()
    gpu = fn(*(a.cuda() for a in arrays)).cpu()
    cpu = fn(*arrays)
    scale = cpu.abs().max().item()
    err = (gpu - cpu).abs().max().item()
    log(f"{label}: shape {tuple(cpu.shape)}, GPU vs CPU max abs err {err:.3e}, max {scale:.3e}, "
        f"rel {err / max(scale, 1e-30):.3e} (tol {WARP_OPS_RTOL}); {time.perf_counter() - t0:.2f} s")
    if not (scale > 0 and err <= WARP_OPS_RTOL * scale and tuple(gpu.shape) == tuple(cpu.shape)):
        raise AssertionError(f"{label}: the card disagrees with the CPU")


def warp_ops_check(rng):
    """Phase 5b: transform with affines, compose, integrate_vec and
    jacobian_determinant at 80x96x112, and cli/warp at full width, on the
    card against the CPU."""
    half = tuple(s // 2 for s in INSHAPE)
    vol = smooth_pair(half, "cpu")[0][0]

    def near_identity(rows):
        mat = np.eye(4, dtype=np.float32)[:rows]
        mat[:3, :3] += 0.08 * rng.standard_normal((3, 3))
        mat[:3, 3] = 4.0 * rng.standard_normal(3)
        return torch.from_numpy(mat.astype(np.float32))

    dense = smooth_field(rng, half, (5, 6, 7), 3.0, "cpu")
    mats = {rows: near_identity(rows) for rows in (3, 4)}
    with full_float32():
        for rows, mat in mats.items():
            for shift_center in (True, False):
                card_vs_cpu(f"transform, {rows}x4 affine, shift_center={shift_center}",
                            lambda v, m: warp_ops.transform(v, m, shift_center=shift_center),
                            vol, mat)
            card_vs_cpu(f"transform, {rows}x4 affine, shape (64, 96, 128)",
                        lambda v, m: warp_ops.transform(v, m, shift_center=False,
                                                        shape=(64, 96, 128)), vol, mat)
        card_vs_cpu("compose [affine, dense]", lambda m, d: warp_ops.compose([m, d]),
                    mats[3], dense)
        card_vs_cpu("compose [dense, affine]", lambda d, m: warp_ops.compose([d, m]),
                    dense, mats[4])
        for method, steps in (("ss", 7), ("quadrature", 5), ("ode", 3)):
            card_vs_cpu(f"integrate_vec {method}, {steps} steps",
                        lambda d: warp_ops.integrate_vec(d, method=method, nb_steps=steps), dense)
        card_vs_cpu("jacobian_determinant", warp_ops.jacobian_determinant, dense)

        # cli/warp at full width, a dense warp and an affine
        with tempfile.TemporaryDirectory() as tmp:
            moving = smooth_pair(INSHAPE, "cpu")[0][0, ..., 0]
            np.save(f"{tmp}/moving.npy", moving.numpy())
            np.save(f"{tmp}/warp.npy", smooth_field(rng, INSHAPE, (5, 6, 7), 4.0, "cpu").numpy())
            np.save(f"{tmp}/affine.npy", mats[3].numpy())
            for warp_file in ("warp.npy", "affine.npy"):
                out = {}
                for device in ("cuda", "cpu"):
                    t0 = time.perf_counter()
                    warp_cli.main(["--moving", f"{tmp}/moving.npy", "--warp", f"{tmp}/{warp_file}",
                                   "--moved", f"{tmp}/moved_{device}.nii", "--device", device])
                    out[device] = load_volfile(f"{tmp}/moved_{device}.nii")
                    log(f"cli/warp {warp_file} on {device}: {time.perf_counter() - t0:.2f} s")
                scale = np.abs(out["cpu"]).max()
                err = np.abs(out["cuda"] - out["cpu"]).max()
                moved_by = np.abs(out["cuda"] - moving.numpy()).max()
                log(f"cli/warp {warp_file} at {INSHAPE}: GPU vs CPU max abs err {err:.3e}, max "
                    f"{scale:.3e} (tol {WARP_OPS_RTOL}); max change of the image {moved_by:.3f}")
                if not (out["cuda"].shape == INSHAPE and err <= WARP_OPS_RTOL * scale
                        and moved_by > 0.1):
                    raise AssertionError(f"cli/warp with {warp_file}: the card disagrees with "
                                         "the CPU or did not move the image")


@contextlib.contextmanager
def integration_remat(remat):
    """Run with the models' integration (``integrate_vec_batched``)
    rematerialised or not; the default is rematerialised, as in JAX."""
    original = warp_ops.integrate_vec_batched
    warp_ops.integrate_vec_batched = lambda *a, **kw: original(*a, remat=remat, **kw)
    try:
        yield
    finally:
        warp_ops.integrate_vec_batched = original


def pointcloud_files(tmp, spatial, device):
    """labelled_pair as the point-cloud trainer's files: the atlas (the
    moving scan and its labels) and one subject (the fixed scan and its
    labels), npz files with 'vol' and 'seg' in ``tmp``."""
    moving, fixed, src, trg = labelled_pair(spatial, device)
    os.makedirs(tmp, exist_ok=True)
    np.savez(f"{tmp}/atlas.npz", vol=moving[0, ..., 0].cpu().numpy(), seg=src.cpu().numpy())
    np.savez(f"{tmp}/subject.npz", vol=fixed[0, ..., 0].cpu().numpy(), seg=trg.cpu().numpy())
    return f"{tmp}/atlas.npz", f"{tmp}/subject.npz"


def pointcloud_generator(tmp, device, labels=None):
    """generators.surf_semisupervised as the point-cloud recipe runs it
    (--surf-bidir, SURF_POINTS points, POINT_LABELS_SAMPLED labels a step,
    smoothing 0.1, SDTs at full resolution) on ``pointcloud_files``, its
    draws from a numpy generator seeded SEED."""
    with np.load(f"{tmp}/atlas.npz") as d:
        vol, seg = d["vol"], d["seg"]
    return generators.surf_semisupervised(
        [f"{tmp}/subject.npz"], vol, seg, nb_surface_pts=SURF_POINTS, labels=labels,
        surf_bidir=True, smooth_seg_std=0.1, nb_labels_sample=POINT_LABELS_SAMPLED,
        sdt_vol_resize=1.0, device=device, rng=np.random.default_rng(SEED))


def pointcloud_recipe(inshape, flow_std=None):
    """The point-cloud recipe's model and losses: VxmDenseSemiSupervisedPointCloud
    (a bidirectional VxmDense with default features, from seed 0), MSE at 0.5
    both ways, Grad('l2', loss_mult=2) at 0.01 and the SDT terms at
    0.25 / dt_sigma^2 with dt_sigma 1; ``flow_std`` redraws the flow head as
    default_recipe does."""
    model = VxmDenseSemiSupervisedPointCloud(
        inshape, nb_surface_points=SURF_POINTS, nb_labels_sample=POINT_LABELS_SAMPLED,
        int_steps=7, int_resolution=2, generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    terms = [LossTerm("y_source", losses.MSE().loss, weight=0.5, target_index=0),
             LossTerm("y_target", losses.MSE().loss, weight=0.5, target_index=1),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=2,
                      name="grad"),
             LossTerm("subj_dt_value", losses.MSE().loss, weight=0.25, target_index=3,
                      name="subj_dt"),
             LossTerm("atl_dt_value", losses.MSE().loss, weight=0.25, target_index=4,
                      name="atl_dt")]
    return model, terms


def train_pointcloud(smi):
    """Phase 6: the point-cloud recipe at full width on the card. Returns
    the launch counts of a step in cuDNN mode and in conv-kernel mode."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    half = tuple(s // 2 for s in INSHAPE)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the generator at half width on the card and on the CPU, from
        # the same numpy seed: its images, SDT stacks and clouds bit-equal
        pointcloud_files(f"{tmp}/half", half, "cpu")
        labels = np.arange(1, POINT_CPU_LABELS + 1)
        batches = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            batches[device] = next(pointcloud_generator(f"{tmp}/half", device, labels))
            log(f"point-cloud generator at {half} on {device}, {POINT_CPU_LABELS} labels "
                f"(atlas SDTs and the first step): {time.perf_counter() - t0:.2f} s")
        names = ["moving", "fixed", "subject SDTs", "atlas SDTs", "subject cloud", "atlas cloud",
                 "target fixed", "target moving", "zero flow", "zero values", "zero values"]
        for name, a, b in zip(names, sum(batches["cuda"], []), sum(batches["cpu"], [])):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise AssertionError(f"the point-cloud generator's {name} differ on the card")
        log(f"point-cloud generator at {half}: the {len(names)} tensors bit-equal on the card "
            f"and the CPU (subject SDTs {tuple(batches['cpu'][0][2].shape)}, clouds "
            f"{tuple(batches['cpu'][0][4].shape)})")

        # (b) one step, the card against the port's CPU run at half width,
        # flows of about a voxel; the CPU takes the bounded tiers too
        batch_h = batches["cpu"]
        t0 = time.perf_counter()
        loss_c, grads_c, _ = recipe_step_grads(pointcloud_recipe, half, "cuda", batch_h,
                                               FLOW_STD)
        with window_halo("1"):
            loss_cpu, grads_cpu, _ = recipe_step_grads(pointcloud_recipe, half, "cpu", batch_h,
                                                       FLOW_STD)
        log(f"point-cloud step at {half} on the CPU and the card: "
            f"{time.perf_counter() - t0:.2f} s")
        compare_grads(f"point-cloud GPU vs CPU, flow head N(0, {FLOW_STD}), {half}",
                      loss_c, grads_c, loss_cpu, grads_cpu, TRAIN_GPU_VS_CPU_RTOL)
        del grads_c, grads_cpu, batches, batch_h

        # (c) the generator on the card at full width: the atlas's SDTs of
        # every label, then a step's subject SDTs and both clouds
        pointcloud_files(tmp, INSHAPE, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = pointcloud_generator(tmp, "cuda")
        draws, gen_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            draws.append(next(gen))
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
        gen_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        inputs, targets = draws[0]
        log(f"point-cloud generator on the card, {INSHAPE}, {SEMI_LABELS} labels, "
            f"{POINT_LABELS_SAMPLED} a step, {SURF_POINTS} points: first draw {gen_s[0]:.3f} s "
            f"(with the atlas's {SEMI_LABELS} SDTs), then " + ", ".join(
                f"{x:.3f}" for x in gen_s[1:]) + f" s per step; peak memory {gen_peak:.3f} "
            f"GiB; {smi}")
        if tuple(inputs[2].shape) != (1, *INSHAPE, POINT_LABELS_SAMPLED) or \
                tuple(inputs[4].shape) != (1, SURF_POINTS, 4) or \
                not all(a.device.type == "cuda" and torch.isfinite(a).all() for a in inputs):
            raise AssertionError("the point-cloud generator's tensors are not the recipe's")
        del draws, gen

        # (d) three steps (flow head redrawn, as phase 4b) on the first
        # draw, in cuDNN mode and with the conv kernel
        per_mode = {}
        for enabled in (False, True):
            mode = "conv kernel" if enabled else "cuDNN"
            with conv_kernel_mode(enabled):
                model, terms = pointcloud_recipe(INSHAPE, FLOW_STD)
                trainer = Trainer(model, terms, lr=1e-4, device="cuda")
                torch.cuda.reset_peak_memory_stats()
                step_losses, step_s, per_step, dts = [], [], [], []
                for _ in range(3):
                    reset_launches()
                    t0 = time.perf_counter()
                    metrics = trainer.train_step(inputs, targets)
                    step_losses.append(metrics["loss"].item())  # synchronises
                    step_s.append(time.perf_counter() - t0)
                    per_step.append(read_launches())
                    dts.append((metrics["subj_dt"].item(), metrics["atl_dt"].item()))
                peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"point-cloud, {mode}: step losses " + ", ".join(
                f"{x:.8f}" for x in step_losses) + "; SDT terms (subject, atlas) " + ", ".join(
                f"({a:.5f}, {b:.5f})" for a, b in dts))
            log(f"point-cloud, {mode}: launches per step {per_step}")
            log(f"float32 point-cloud train step, {mode}, bs1, {INSHAPE}: " + ", ".join(
                f"{x:.4f}" for x in step_s) + f" s/step (median of the last two "
                f"{float(np.median(step_s[1:])):.4f}); peak memory allocated {peak_gb:.3f} GiB; "
                f"{smi}")
            if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
                raise AssertionError(f"three point-cloud steps ({mode}) did not lower the "
                                     f"loss: {step_losses}")
            convs = TRAIN_STEP_CONVS if enabled else 0
            if any(p["conv"] != convs or p["layout_copies"] != 0 for p in per_step):
                raise AssertionError(f"a point-cloud step missed a kernel: {per_step}")
            for counts in per_step:
                check_warp_work(counts, f"a point-cloud step, {mode}")
            per_mode[enabled] = per_step[-1]
            if not enabled:
                trainer.save(f"{tmp}/pointcloud.npz")
            del trainer, model

        # (e) registration_model, then a pair registered through cli/register
        net = resolve_registration_model(load_model(f"{tmp}/pointcloud.npz", device="cuda"))
        log(f"registration_model of the point-cloud checkpoint: {type(net).__name__} "
            f"{net.inshape}, bidir {net.bidir}, {sum(p.numel() for p in net.parameters())} "
            f"params")
        reset_launches()
        t0 = time.perf_counter()
        register_cli.main(["--moving", f"{tmp}/subject.npz", "--fixed", f"{tmp}/atlas.npz",
                           "--model", f"{tmp}/pointcloud.npz", "--moved", f"{tmp}/moved.nii",
                           "--warp", f"{tmp}/warp.nii"])
        counts = read_launches()
        warp = load_volfile(f"{tmp}/warp.nii")
        moved = load_volfile(f"{tmp}/moved.nii")
        log(f"cli/register with the point-cloud checkpoint: {time.perf_counter() - t0:.2f} s, "
            f"launches {counts}, warp {warp.shape}, max|warp| "
            f"{np.abs(warp).max():.3f} voxels")
        if warp.shape != (*INSHAPE, 3) or moved.shape != INSHAPE or \
                not (np.isfinite(warp).all() and np.isfinite(moved).all()):
            raise AssertionError("cli/register of the point-cloud checkpoint failed")
        check_warp_work(counts, "cli/register of the point-cloud checkpoint", backward=False)
    return per_mode[False], per_mode[True]


def cached_dispatch_check(smi):
    """Phase 6b: fit_cached_pairs over DISPATCH_STEPS-step dispatches of
    the default recipe against single steps on the same picks, from the
    same weights, at full width; then phase 4's step with and without the
    rematerialised integration. Returns the launch counts of a dispatch's
    step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    data = torch.cat([moving, fixed, moving.flip(1), fixed.flip(2)])
    log(f"volume stack on the card: {tuple(data.shape)}, "
        f"{data.numel() * data.element_size() / 2 ** 20:.1f} MiB")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for k in (1, DISPATCH_STEPS, 1):  # the first run warms the card up
            model, terms = default_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.fit_cached_pairs(
                data, epochs=DISPATCH_STEPS // k, steps_per_epoch=k, steps_per_dispatch=k,
                seed=SEED, log_fn=lambda _: None)
            torch.cuda.synchronize()
            runs[k] = dict(s=(time.perf_counter() - t0) / DISPATCH_STEPS, metrics=metrics,
                           fetches=trainer.metric_fetches, launches=read_launches(),
                           params={n: p.detach().clone()
                                   for n, p in trainer.model.named_parameters()})
            del trainer, model
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    one, many = runs[1], runs[DISPATCH_STEPS]
    equal = all(torch.equal(one["params"][n], p) for n, p in many["params"].items())
    worst = max(((one["params"][n] - p).abs().max() / p.abs().max()).item()
                for n, p in many["params"].items())
    log(f"fit_cached_pairs, {DISPATCH_STEPS} steps from the same weights on the same picks: "
        f"K = {DISPATCH_STEPS} against K = 1 params bit-equal {equal} (cudnn.deterministic), "
        f"largest difference {worst:.3e} of a tensor's largest magnitude (tol {DISPATCH_RTOL})")
    log(f"host metric fetches: {many['fetches']} for one dispatch of {DISPATCH_STEPS} steps, "
        f"{one['fetches']} for {DISPATCH_STEPS} single steps; dispatch-mean metrics "
        f"{json.dumps(many['metrics'])}, the last single step's {json.dumps(one['metrics'])}")
    log(f"seconds per step, {INSHAPE}, float32, cuDNN: K = 1 {one['s']:.4f}, "
        f"K = {DISPATCH_STEPS} {many['s']:.4f} (launches per {DISPATCH_STEPS} steps "
        f"{many['launches']}); {smi}")
    if not (equal or worst <= DISPATCH_RTOL):
        raise AssertionError("the dispatched steps differ from single steps")
    if many["fetches"] != 1 or one["fetches"] != DISPATCH_STEPS:
        raise AssertionError(f"metric fetches {many['fetches']} and {one['fetches']}")
    check_warp_work(many["launches"], f"a dispatch of {DISPATCH_STEPS} steps")
    launches = {k: v // DISPATCH_STEPS for k, v in many["launches"].items()}

    # phase 4's step with and without the rematerialised integration: the
    # gradients bit-equal (cudnn.deterministic), memory and time per step
    results = {}
    for remat in (True, False):
        with integration_remat(remat):
            torch.backends.cudnn.deterministic = True
            try:
                loss, grads, step_launches = one_step_grads(INSHAPE, "cuda", moving, fixed,
                                                            FLOW_STD)
            finally:
                torch.backends.cudnn.deterministic = saved[0]
            model, terms = default_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
            trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()  # warm-up
            torch.cuda.reset_peak_memory_stats()
            step_s = []
            for _ in range(2):
                t0 = time.perf_counter()
                trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                step_s.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            results[remat] = (loss, grads)
            log(f"phase 4 step, integration remat={remat}: " + ", ".join(
                f"{x:.4f}" for x in step_s) + f" s/step, peak memory allocated {peak:.3f} GiB, "
                f"launches {step_launches}; {smi}")
            del trainer, model
    same = results[True][0] == results[False][0] and all(
        torch.equal(results[True][1][n], g) for n, g in results[False][1].items())
    log(f"remat against stored integration: loss and {len(results[True][1])} gradients "
        f"bit-equal {same}")
    if not same:
        raise AssertionError("the rematerialised integration changed the gradients")
    return launches


def nd_and_res_check(smi):
    """Phase 6c: a 2-D VxmDense on the pair's middle slice, card against
    CPU, and a 3-D do_res VxmDense with a tanh final activation through the
    conv kernel against cuDNN mode. Returns the launches of a 2-D step and
    of a do_res register call with the conv kernel."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cpu")
    mid = INSHAPE[0] // 2
    pair2 = (moving[:, mid].contiguous(), fixed[:, mid].contiguous())
    shape2 = INSHAPE[1:]

    def recipe2(inshape, flow_std=None):
        model = VxmDense(inshape, int_steps=7, int_resolution=2,
                         generator=torch.Generator().manual_seed(SEED))
        if flow_std is not None:
            with torch.no_grad():
                model.flow.weight.normal_(0.0, 3 ** 0.5 * flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
        terms = [LossTerm("y_source", losses.MSE(1.0).loss, weight=1.0, target_index=0),
                 LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                          target_index=1, name="grad")]
        return model, terms

    zero2 = torch.zeros((1, *shape2, 2))
    batch2 = ((pair2[0], pair2[1]), (pair2[1], zero2))
    loss_c, grads_c, launches2 = recipe_step_grads(recipe2, shape2, "cuda", batch2, FLOW_STD)
    loss_cpu, grads_cpu, _ = recipe_step_grads(recipe2, shape2, "cpu", batch2, FLOW_STD)
    log(f"2-D VxmDense {shape2}: one step's launches {launches2}")
    compare_grads(f"2-D GPU vs CPU, {shape2}", loss_c, grads_c, loss_cpu, grads_cpu,
                  TRAIN_GPU_VS_CPU_RTOL)
    if any(launches2.values()):
        raise AssertionError(f"the 2-D step launched a kernel: {launches2}")
    out = {}
    for device in ("cuda", "cpu"):
        model, terms = recipe2(shape2, FLOW_STD)
        trainer = Trainer(model, terms, lr=1e-4, device=device)
        inputs = tuple(a.to(device) for a in batch2[0])
        targets = tuple(a.to(device) for a in batch2[1])
        t0 = time.perf_counter()
        step_losses = [trainer.train_step(inputs, targets)["loss"].item() for _ in range(3)]
        step_s = time.perf_counter() - t0
        reset_launches()
        moved, warp = build_register_fn(trainer.model.eval())(*inputs)
        out[device] = (step_losses, moved.cpu(), warp.cpu(), read_launches())
        log(f"2-D VxmDense on {device}: 3 steps {step_s:.3f} s, losses " + ", ".join(
            f"{x:.8f}" for x in step_losses) + f"; register call launches {out[device][3]}")
    losses_c, losses_cpu = out["cuda"][0], out["cpu"][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_c, losses_cpu))
    flow_err, _ = max_and_mean_abs(out["cuda"][2], out["cpu"][2])
    image_err, _ = max_and_mean_abs(out["cuda"][1], out["cpu"][1])
    log(f"2-D after 3 steps, GPU vs CPU: losses rel {rel:.3e} (tol {TRAIN_GPU_VS_CPU_RTOL}), "
        f"pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}), y_source {image_err:.3e} "
        f"(tol {IMAGE_TOL}); max|warp| {out['cuda'][2].abs().max().item():.3f}")
    if not (losses_c[-1] < losses_c[0] and rel <= TRAIN_GPU_VS_CPU_RTOL
            and flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("the 2-D model disagrees on the card or did not learn")
    if any(out["cuda"][3].values()):
        raise AssertionError(f"the 2-D register call launched a kernel: {out['cuda'][3]}")

    # a do_res model with a tanh final activation at full width: every block
    # adds its residual, so the conv kernel runs with the activation off
    moving, fixed = moving.cuda(), fixed.cuda()
    act_off = []  # per conv kernel launch: whether its activation was off
    original = conv3._conv3_cuda

    def spy(x, kernel, bias, act_slope, *args):
        act_off.append(act_slope is None)
        return original(x, kernel, bias, act_slope, *args)

    results, res_launches = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        for enabled in (True, False):
            with conv_kernel_mode(enabled), full_float32():
                model = VxmDense(INSHAPE, do_res=True, final_activation_function="tanh",
                                 dtype=dtype, generator=torch.Generator().manual_seed(SEED))
                with torch.no_grad():
                    model.flow.weight.normal_(0.0, FLOW_STD,
                                              generator=torch.Generator().manual_seed(SEED + 1))
                register = build_register_fn(model.cuda().eval())
                act_off.clear()
                reset_launches()
                conv3._conv3_cuda = spy
                try:
                    t0 = time.perf_counter()
                    results[dtype, enabled] = register(moving, fixed)
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
                finally:
                    conv3._conv3_cuda = original
                launches = read_launches()
                log(f"do_res + tanh VxmDense, {str(dtype).split('.')[1]}, "
                    f"{'conv kernel' if enabled else 'cuDNN'}: {first_s:.3f} s, launches "
                    f"{launches}, conv launches with the activation off {sum(act_off)} of "
                    f"{len(act_off)}")
                expected = len(UNET_CONVS) if enabled else 0
                if launches["conv"] != expected or sum(act_off) != expected:
                    raise AssertionError(f"expected {expected} conv launches, all with the "
                                         f"activation off: {launches}, {act_off}")
                if dtype == torch.bfloat16 and enabled:
                    res_launches = launches
                del model, register
    # phase 3b's limits: float32, kernel against cuDNN; bfloat16, those of
    # bfloat16 against float32, since in bfloat16 the two modes round in
    # other places (the kernel once after the bias where the JAX package's
    # kernel takes a shape, cuDNN mode after the conv and again after the
    # bias, as XLA's conv does)
    for dtype, flow_tol, image_tol in ((torch.float32, FLOW_TOL, IMAGE_TOL),
                                       (torch.bfloat16, BF16_VS_F32_FLOW_TOL,
                                        BF16_VS_F32_IMAGE_TOL)):
        (moved_k, warp_k), (moved_c, warp_c) = results[dtype, True], results[dtype, False]
        flow_err, _ = max_and_mean_abs(warp_k, warp_c)
        image_err, _ = max_and_mean_abs(moved_k, moved_c)
        log(f"do_res + tanh, {str(dtype).split('.')[1]}, conv kernel vs cuDNN: pos_flow max abs "
            f"err {flow_err:.3e} (tol {flow_tol}), y_source {image_err:.3e} (tol {image_tol}); "
            f"max|warp| {warp_c.abs().max().item():.3f} voxels")
        if not (flow_err <= flow_tol and image_err <= image_tol
                and torch.isfinite(warp_k).all() and torch.isfinite(moved_k).all()):
            raise AssertionError("the do_res model's conv-kernel run disagrees with cuDNN mode")
    return launches2, res_launches



def tier_case(rng, spatial, nch, tier):
    """A volume and a random shift (batch 1) whose max|d| puts the warp on
    ``tier`` of the tiers {1, TIER_HALO}: bound 1, TIER_HALO or
    TIER_HALO + 2, with bands pushed across every edge (warp_case); on the
    gather tier also slabs of coordinates exactly on 0 and dim - 1."""
    vol, shift = warp_case(rng, 1, spatial, nch, {0: 1, 1: TIER_HALO, 2: TIER_HALO + 2}[tier])
    if tier == 2:
        for axis, dim in enumerate(spatial):
            idx = [slice(None)] * 5
            idx[1 + axis], idx[4] = 4, axis
            shift[tuple(idx)] = -4.0
            idx[1 + axis] = 1
            shift[tuple(idx)] = float(dim - 2)
    return vol, shift


def host_chosen_warp(vol, shift):
    """The warp as the port chose its tier before: max|d| read on the host,
    then the one branch (the bounded kernel or the torch gather)."""
    max_d = shift.abs().max().item()
    for h in (1, TIER_HALO):
        if max_d <= h:
            return warp_bounded(vol, shift, h)
    return warp_gather_plain(vol, shift)


def wall_ms(fn, reps=20):
    """Host wall-clock ms per call of ``fn`` over ``reps`` calls, from a
    synchronised card to a synchronised card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_tiered_warp(rng, gather_builds, counting):
    """Phase 2e: the predicated warp at each tier of {1, TIER_HALO} at the
    squaring shape, 1 to 4 channels (the gather's dshift adds the channels
    in the order of the card's torch reduction, which differs by channel
    count: csrc/warp_gather.cu channel_sum). Each branch's kernel writes its own
    NaN-filled buffer with the device's tier word: the branches not named
    must leave theirs untouched, the named one must equal the unpredicated
    kernel (bounded) or the torch gather (gather forward and dshift bit for
    bit, dvol within GATHER_DVOL_RTOL). Then the whole tiered warp
    (transform_batched, forward and backward) against the host-chosen path,
    its work counters, its time against the host-chosen call's, and the
    time of a launch that returns at once. Returns the gather kernel's rows
    for the kernels line."""
    spatial = WARP_CASES[0][1]
    halos = (1, TIER_HALO)
    skipped = {}
    for nch in (1, 2, 3, 4):
        for tier in (0, 1, 2):
            vol, shift = tier_case(rng, spatial, nch, tier)
            g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
            word = warp_ops.tier_index(shift, halos)
            # (a) every branch into its own buffer
            outs, grads = [], []
            for serve in range(3):
                out = torch.full_like(vol, float("nan"))
                # the gather adds into its dvol: zeroed where it is named
                dvol = torch.full_like(vol, 0.0 if serve == 2 == tier else float("nan"))
                dshift = torch.full_like(shift, float("nan"))
                if serve < 2:
                    warp_bounded_ops.launch_bounded_fwd(vol, shift, out, halos[serve], word, serve)
                    warp_bounded_ops.launch_bounded_bwd(vol, shift, g, dvol, dshift, halos[serve],
                                                        word, serve)
                else:
                    launch_gather_fwd(vol, shift, out, word, serve)
                    launch_gather_bwd(vol, shift, g, dvol, dshift, word, serve)
                outs.append(out)
                grads.append((dvol, dshift))
            torch.cuda.synchronize()
            for serve in range(3):
                if serve != tier and not (torch.isnan(outs[serve]).all() and all(
                        torch.isnan(x).all() for x in grads[serve])):
                    raise AssertionError(f"branch {serve} wrote at tier {tier}, C = {nch}")
            out, (dvol, dshift) = outs[tier], grads[tier]
            if tier < 2:
                ref = warp_bounded(vol, shift, halos[tier])
                ref_vol, ref_shift = warp_bounded_bwd(vol, shift, g, halos[tier])
                plain_err = (out - windowed_transform(vol, shift, halos[tier])).abs().max().item()
                equal = torch.equal(out, ref) and torch.equal(dvol, ref_vol) and \
                    torch.equal(dshift, ref_shift)
                dvol_rel = 0.0
            else:
                ref = warp_gather_plain(vol, shift)
                ref_vol, ref_shift = warp_gather_bwd_plain(vol, shift, g)
                plain_err = (out - ref).abs().max().item()
                equal = torch.equal(out, ref) and torch.equal(dshift, ref_shift)
                dvol_rel = ((dvol - ref_vol).abs().max() / ref_vol.abs().max()).item()
            log(f"tier {tier}, C = {nch}: max|d| {shift.abs().max().item():.3f}; the named "
                f"branch equals its reference {equal} (forward vs plain {plain_err:.3e}"
                f"{'' if tier < 2 else f', dvol rel {dvol_rel:.3e} (tol {GATHER_DVOL_RTOL})'}); "
                f"the others wrote nothing")
            if not equal or dvol_rel > GATHER_DVOL_RTOL or plain_err > KERNEL_TOL:
                raise AssertionError(f"the tier-{tier} branch differs from its reference")

            # (b) the whole tiered warp, forward and backward, and its counters
            v, s = vol.clone().requires_grad_(), shift.clone().requires_grad_()
            reset_launches()
            with window_halo(str(TIER_HALO)):
                got = warp_ops.transform_batched(v, s)
                got_vol, got_shift = torch.autograd.grad(got, (v, s), g)
            torch.cuda.synchronize()
            counts = read_launches()
            ran = (counts["fwd_ran"], counts["gather_fwd_ran"], counts["bwd_ran"],
                   counts["gather_bwd_ran"])
            want = (int(tier < 2), int(tier == 2), int(tier < 2), int(tier == 2))
            ok = torch.equal(got, out) and torch.equal(got_shift, dshift) and (
                torch.equal(got_vol, dvol) if tier < 2 else
                ((got_vol - ref_vol).abs().max() / ref_vol.abs().max()).item()
                <= GATHER_DVOL_RTOL)
            log(f"tier {tier}, C = {nch}: transform_batched (predicated) forward and backward "
                f"equal the branch {ok}; launches {counts['fwd']} + {counts['gather_fwd']} "
                f"forward, {counts['bwd']} + {counts['gather_bwd']} backward; ran "
                f"(bounded fwd, gather fwd, bounded bwd, gather bwd) {ran}")
            if not ok or ran != want:
                raise AssertionError(f"the tiered warp at tier {tier} took another branch")
            # the same where the volume needs no gradient (the image warp of
            # a train step): the gather's backward then takes no dvol
            s = shift.clone().requires_grad_()
            with window_halo(str(TIER_HALO)):
                (alone,) = torch.autograd.grad(warp_ops.transform_batched(vol, s), (s,), g)
            torch.cuda.synchronize()
            log(f"tier {tier}, C = {nch}: the shift's gradient with no volume gradient equals "
                f"it with one {torch.equal(alone, got_shift)}")
            if not torch.equal(alone, got_shift):
                raise AssertionError(f"the tiered warp at tier {tier}: the shift's gradient "
                                     f"differs where the volume needs no gradient")

            # (c) the predicated call against the host-chosen one, and the
            # device time of each launch that returns at once
            if nch not in (1, 3):  # the channel counts of the main paths
                continue
            with window_halo(str(TIER_HALO)):
                times = dict(predicated=wall_ms(lambda: warp_ops.transform_batched(vol, shift)),
                             host_chosen=wall_ms(lambda: host_chosen_warp(vol, shift)))
            log(f"tier {tier}, C = {nch}: forward warp {times['predicated']:.4f} ms predicated "
                f"(3 launches, no host sync), {times['host_chosen']:.4f} ms host-chosen (a host "
                f"read of max|d|, 1 launch); host wall clock, 20 calls")
            if nch == 3 and tier == 0:
                other = torch.empty_like(vol)
                # dvol_zero: the fill of the zeroed dvol that the tiered
                # warp's backward hands its branches (the gather adds into it)
                skipped = time_in_turns(dict(
                    bounded_fwd=lambda: warp_bounded_ops.launch_bounded_fwd(
                        vol, shift, other, TIER_HALO, word, 1),
                    bounded_bwd=lambda: warp_bounded_ops.launch_bounded_bwd(
                        vol, shift, g, other, torch.empty_like(shift), TIER_HALO, word, 1),
                    gather_fwd=lambda: launch_gather_fwd(vol, shift, other, word, 2),
                    gather_bwd=lambda: launch_gather_bwd(vol, shift, g, other,
                                                         torch.empty_like(shift), word, 2),
                    dvol_zero=lambda: other.zero_(),
                    **{f"{label} {d}": fn for label, lib in gather_builds.items()
                       for d, fn in (
                           ("fwd", lambda lib=lib: gather_compare_launch(
                               lib, "vxm_warp_gather_fwd", (vol, shift, other), word, 2)),
                           ("bwd", lambda lib=lib: gather_compare_launch(
                               lib, "vxm_warp_gather_bwd",
                               (vol, shift, g, other, torch.empty_like(shift)), word, 2)))}))
                log(f"device ms of a launch that returns at once, {spatial}, C = 3: "
                    + json.dumps(skipped))
            del vol, shift, g, outs, grads, v, s, got, got_vol, got_shift, ref, ref_vol, ref_shift
            del alone

    # (d) the phase warp (--fast-warp's lax.cond) forward and backward at
    # each branch against the host-chosen composition
    check_phase_warp(rng, spatial)

    # (e) the gather kernels at the squaring shape on a smooth field of up to
    # TIER_HALO + 2 voxels (a late squaring's), and on a rough field of up
    # to 12 voxels, whose lanes share few corners (few merged adds)
    nch = WARP_CASES[0][2]
    vol = torch.from_numpy(rng.standard_normal((1, *spatial, nch), dtype=np.float32)).cuda()
    shift = smooth_field(rng, spatial, (5, 6, 7), 1.0, "cuda")[None]
    shift = (shift * ((TIER_HALO + 2) / shift.abs().max())).contiguous()
    g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
    fwd_row, bwd_row = gather_case("squaring shape, smooth", vol, shift, g, gather_builds,
                                   counting)
    rough = torch.from_numpy(rng.uniform(-12, 12, size=shift.shape).astype(np.float32)).cuda()
    rough_rows = gather_case("squaring shape, rough", vol, rough, g, gather_builds, counting)
    fwd_row["rough"], bwd_row["rough"] = ({k: r[k] for k in (
        "ms", "kernel_ms", "library_ms", "bound_share", "adds", "merged", "max_abs_err")
        if k in r}
        for r in rough_rows)
    return fwd_row, bwd_row, skipped


def gather_serving_shape(rng, warp, builds, counting):
    """The gather kernels at the serving warp's shape (1, 160, 192, 224, 1):
    on a smooth field scaled to the max|d| of the register call's final
    warp (``warp``, phase 3's flow), and on that flow itself. Returns
    {"smooth": (forward row, backward row), "flow": (...)}."""
    max_d = warp.abs().max().item()
    log(f"the register call's final warp (phase 3): max|d| {max_d:.4f} voxels")
    vol = torch.from_numpy(rng.standard_normal((1, *INSHAPE, 1), dtype=np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
    shift = smooth_field(rng, INSHAPE, (5, 6, 7), 1.0, "cuda")[None]
    shift = (shift * (max_d / shift.abs().max())).contiguous()
    return {"smooth": gather_case(f"serving shape, smooth, max|d| {max_d:.4f}", vol, shift, g,
                                  builds, counting),
            "flow": gather_case("serving shape, phase 3's flow", vol,
                                warp.float().clone(memory_format=torch.contiguous_format), g,
                                builds, counting)}


def gather_summary(row):
    """The numbers of a gather_case row that the kernels line carries."""
    return {k: row[k] for k in ("shape", "max_abs_shift", "ms", "kernel_ms", "ms_no_dvol",
                                "plain_ms", "library_ms", "bound_ms", "bound_share", "adds",
                                "merged") if k in row}


def gather_compare_launch(lib, name, tensors, tier=None, serve=0):
    """Launch the entry point ``name`` of another build of
    csrc/warp_gather.cu on the current stream, as ops/warp_gather.py
    launches the package's own, counting nothing."""
    fn = getattr(lib, name)
    fn.argtypes = warp_gather_ops._ARGTYPES[name]
    fn.restype = ctypes.c_int
    B, D, H, W, C = tensors[0].shape
    err = fn(*(t.data_ptr() for t in tensors), B, D, H, W, C,
             int(warp_gather_ops.is_wide((D, H, W), C)),
             None if tier is None else tier.data_ptr(), serve, None,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} of another build failed to launch: CUDA error {err}")


def gather_case(label, vol, shift, g, builds, counting):
    """The gather kernels on one input: forward and dshift bit-equal to the
    torch gather (warp_gather_plain and its autograd VJP) and dvol within
    GATHER_DVOL_RTOL of its largest magnitude, for the package's build and
    each other build of ``builds`` ({label: library}); the backward's
    atomic adds and merged terms (from ``counting``, the package's source
    built with VXM_GATHER_COUNT: the 8 corner terms of every output added
    once); then times in turns: the forward kernel; the backward into a
    zeroed dvol (ms: the fill of the dvol that the kernel adds into, then
    the kernel, as the tiered warp's backward runs them; kernel_ms: the
    kernel alone) and with no dvol (ms_no_dvol: the image warp of a train
    step); grid_sample and its backward; and the other builds, each
    backward into a zeroed dvol too (the fill timed with it unless the
    build zeroes dvol itself, as an earlier one did). Returns the
    forward's and the backward's rows."""
    nch = vol.shape[-1]
    spatial = tuple(vol.shape[1:-1])
    shift = shift.contiguous()
    out, dshift = torch.empty_like(vol), torch.empty_like(shift)
    dvol = torch.zeros_like(vol)
    launch_gather_fwd(vol, shift, out)
    launch_gather_bwd(vol, shift, g, dvol, dshift)
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fn = counting.vxm_warp_gather_bwd
    fn.argtypes = warp_gather_ops._ARGTYPES["vxm_warp_gather_bwd"]
    B, D, H, W, _ = vol.shape
    if fn(vol.data_ptr(), shift.data_ptr(), g.data_ptr(), torch.zeros_like(vol).data_ptr(),
          torch.empty_like(shift).data_ptr(), B, D, H, W, nch,
          int(warp_gather_ops.is_wide((D, H, W), nch)), None, 0, counts.data_ptr(),
          torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("the counting build of the gather backward failed to launch")
    adds, merged = counts[1:].tolist()
    ref = warp_gather_plain(vol, shift)
    ref_vol, ref_shift = warp_gather_bwd_plain(vol, shift, g)
    torch.cuda.synchronize()

    def errors(out, dvol, dshift):
        return dict(
            max_abs_err=(out - ref).abs().max().item(),
            bit_equal=torch.equal(out, ref), dshift_bit_equal=torch.equal(dshift, ref_shift),
            dshift_max_abs_err=(dshift - ref_shift).abs().max().item(),
            dvol_rel=((dvol - ref_vol).abs().max() / ref_vol.abs().max()).item())

    own = errors(out, dvol, dshift)
    others, zeroes = {}, {}
    for name, lib in builds.items():
        o, dv, ds = torch.empty_like(vol), torch.full_like(vol, float("nan")), \
            torch.empty_like(shift)
        gather_compare_launch(lib, "vxm_warp_gather_fwd", (vol, shift, o))
        gather_compare_launch(lib, "vxm_warp_gather_bwd", (vol, shift, g, dv, ds))
        # a build that adds into dvol leaves the NaN; one that zeroes it
        # first leaves none
        zeroes[name] = not dv.isnan().any().item()
        if not zeroes[name]:
            dv.zero_()
            gather_compare_launch(lib, "vxm_warp_gather_bwd", (vol, shift, g, dv, ds))
        torch.cuda.synchronize()
        others[name] = dict(errors(o, dv, ds), zeroes_dvol=zeroes[name])
    coords = ndgrid(spatial, device="cuda") + shift
    dims = torch.tensor([s - 1 for s in spatial], device="cuda", dtype=torch.float32)
    grid = (2.0 * coords / dims - 1.0).flip(-1).contiguous().requires_grad_()
    vol_cf = vol.movedim(-1, 1).contiguous().requires_grad_()
    out_cf = grid_sample_warp(vol_cf, grid)
    g_cf = g.movedim(-1, 1).contiguous()
    vox = vol.shape[0] * int(np.prod(spatial))
    fwd_bytes, bwd_bytes = (2 * nch + 3) * 4 * vox, (3 * nch + 6) * 4 * vox
    fwd_row = dict(shape=list(vol.shape), max_abs_err=own["max_abs_err"],
                   bit_equal=own["bit_equal"], max_abs_shift=shift.abs().max().item(),
                   plain_ms=time_cuda_ms(lambda: warp_gather_plain(vol, shift), reps=5, warmup=1),
                   bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    bwd_row = dict(shape=list(vol.shape), max_abs_err=max(own["dshift_max_abs_err"],
                                                          (dvol - ref_vol).abs().max().item()),
                   dshift_bit_equal=own["dshift_bit_equal"], dvol_rel=own["dvol_rel"],
                   adds=adds, merged=merged,
                   plain_ms=time_cuda_ms(lambda: warp_gather_bwd_plain(vol, shift, g), reps=5,
                                         warmup=1),
                   bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    scratch = torch.zeros_like(vol)  # the timed backward adds into it
    fwd_fns = dict(ms=lambda: launch_gather_fwd(vol, shift, out),
                   library_ms=lambda: grid_sample_warp(vol_cf, grid))
    bwd_fns = dict(ms=lambda: (scratch.zero_(),
                               launch_gather_bwd(vol, shift, g, scratch, dshift)),
                   kernel_ms=lambda: launch_gather_bwd(vol, shift, g, scratch, dshift),
                   ms_no_dvol=lambda: launch_gather_bwd(vol, shift, g, None, dshift),
                   library_ms=lambda: torch.autograd.grad(out_cf, (vol_cf, grid), g_cf,
                                                          retain_graph=True))
    for name, lib in builds.items():
        fwd_fns[name] = lambda lib=lib: gather_compare_launch(
            lib, "vxm_warp_gather_fwd", (vol, shift, out))
        bwd_fns[name] = lambda lib=lib, zeroes=zeroes[name]: (
            None if zeroes else scratch.zero_(),
            gather_compare_launch(lib, "vxm_warp_gather_bwd", (vol, shift, g, scratch, dshift)))
    for row, fns in ((fwd_row, fwd_fns), (bwd_row, bwd_fns)):
        times = time_in_turns(fns)
        row.update({k: times[k] for k in fns if k not in builds})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if builds:
            row["compare"] = {k: dict(ms=times[k], **others[k]) for k in builds}
    log(f"gather forward, {label}: " + json.dumps(fwd_row))
    log(f"gather backward, {label} (ms: the fill of the zeroed dvol and the kernel; "
        f"kernel_ms: the kernel alone): " + json.dumps(bwd_row))
    for name, e in {"package": own, **others}.items():
        if not (e["bit_equal"] and e["dshift_bit_equal"]) or not e["dvol_rel"] <= GATHER_DVOL_RTOL:
            raise AssertionError(f"the gather kernels ({name}) differ from the torch gather "
                                 f"on the {label} field: {e}")
    if adds + merged != 8 * vox:
        raise AssertionError(f"the gather backward added {adds} times and merged {merged} "
                             f"of the 8 corner terms of {vox} outputs")
    return fwd_row, bwd_row


def check_phase_warp(rng, spatial, n_apps=4, halo=TIER_HALO):
    """phase_warp_batched on the card (the branch chosen on the device)
    against the host-chosen branch (n_apps warp_bounded calls by root, or
    the torch gather by full_flow), forward and backward, where max|root|
    <= halo (the fast branch) and where it exceeds it (the slow one): the
    forward, dfull_flow and the fast branch's dvols and droot bit-equal,
    the slow branch's dvols within GATHER_DVOL_RTOL and its droot zero."""
    for branch, bound in ((0, halo), (1, halo + 1)):
        vols = torch.from_numpy(rng.standard_normal((1, *spatial, 1), dtype=np.float32)).cuda()
        root = warp_case(rng, 1, spatial, 3, bound)[1]
        full = smooth_field(rng, spatial, (5, 6, 7), 2.0 * n_apps, "cuda")[None].contiguous()
        g = torch.from_numpy(rng.standard_normal(vols.shape, dtype=np.float32)).cuda()
        grads = {}
        for name in ("card", "host"):
            v, r, f = (t.clone().requires_grad_() for t in (vols, root, full))
            if name == "card":
                out = warp_ops.phase_warp_batched(v, r, f, n_apps, halo)
            elif branch == 0:
                out = v
                for _ in range(n_apps):
                    out = warp_bounded(out, r, halo)
            else:
                out = warp_gather_plain(v, f)
            grads[name] = (out.detach(), *torch.autograd.grad(out, (v, r, f), g,
                                                              allow_unused=True))
        (out, dv, dr, df), (rout, rdv, rdr, rdf) = grads["card"], grads["host"]
        zero_if_none = (lambda x, like: torch.zeros_like(like) if x is None else x)
        rdr, rdf = zero_if_none(rdr, root), zero_if_none(rdf, full)
        dv_ok = torch.equal(dv, rdv) if branch == 0 else \
            ((dv - rdv).abs().max() / rdv.abs().max()).item() <= GATHER_DVOL_RTOL
        ok = torch.equal(out, rout) and dv_ok and torch.equal(dr, rdr) and torch.equal(df, rdf)
        log(f"phase warp, {'fast' if branch == 0 else 'slow'} branch (max|root| "
            f"{root.abs().max().item():.2f}, halo {halo}): forward and gradients equal the "
            f"host-chosen branch's {ok}")
        if not ok:
            raise AssertionError("the phase warp on the card differs from the host-chosen one")


def redraw_until_all_tiers(label, moving, fixed):
    """The default recipe with its flow head redrawn N(0, flow_std), from
    FLOW_STD and 4 times larger (up to 3 draws), until a register call
    takes the halo-1, the halo-TIER_HALO and the gather tier (under
    VXM_WINDOW_HALO=TIER_HALO). Returns (model on the card, terms,
    flow_std, the tiers of the call's warps)."""
    flow_std = FLOW_STD
    for _ in range(3):
        model, terms = default_recipe(INSHAPE, flow_std)
        model = model.to("cuda").eval()
        register = build_register_fn(model)
        tiers = tiers_taken(lambda: register(moving, fixed))
        log(f"{label}, flow head N(0, {flow_std}): tiers of the register call's warps {tiers}")
        if set(tiers) == {0, 1, 2}:
            return model, terms, flow_std, tiers
        flow_std *= 4
    raise AssertionError(f"{label}: no flow head drawn took every tier")


def tiers_taken(model_fn):
    """The tier each tiered warp of one call of ``model_fn`` took, read from
    the work counters: they are fetched around each of a warp's predicated
    forward launches (host reads: diagnostics only, outside the timed and
    sync-checked runs), and the warp's tier is the branch whose launch did
    work. Fails unless exactly one branch of each warp did, the one its
    tier index names."""
    taken, ran = [], []
    forward = warp_ops._TieredWarp.forward
    bounded, gather = warp_bounded_ops.launch_bounded_fwd, warp_ops.launch_gather_fwd

    def counted(launch, slot):
        def run(*args):  # the last argument is the branch the launch serves
            before = warp_bounded_ops.read_work()[slot]
            launch(*args)
            if warp_bounded_ops.read_work()[slot] != before:
                ran.append(args[-1])
        return run

    def tiered(ctx, vol, shift, halos):
        ran.clear()
        out = forward(ctx, vol, shift, halos)
        named = int(warp_ops.tier_index(shift, halos).item())
        if ran != [named]:
            raise AssertionError(f"a tiered warp ran the branches {ran}; its tier index "
                                 f"names {named}")
        taken.append(named)
        return out

    warp_ops._TieredWarp.forward = staticmethod(tiered)
    warp_bounded_ops.launch_bounded_fwd = counted(bounded, "warp_bounded_fwd")
    warp_ops.launch_gather_fwd = counted(gather, "warp_gather_fwd")
    try:
        model_fn()
    finally:
        warp_ops._TieredWarp.forward = staticmethod(forward)
        warp_bounded_ops.launch_bounded_fwd = bounded
        warp_ops.launch_gather_fwd = gather
    return taken


def sync_free_check(smi):
    """Phase 7: the full-width register call and one float32 train step of
    the default recipe, flow head redrawn so that every tier runs, in cuDNN
    and conv-kernel mode, each under torch.cuda.set_sync_debug_mode("error")
    after a warm-up: any host synchronisation inside raises. Also the time
    of each path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    results = {}
    with window_halo(str(TIER_HALO)):
        for enabled in (False, True):
            mode = "conv kernel" if enabled else "cuDNN"
            with conv_kernel_mode(enabled):
                model, terms, flow_std, tiers = redraw_until_all_tiers(
                    f"register call, {mode}", moving, fixed)
                register = build_register_fn(model)
                register(moving, fixed)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    moved, warp = register(moving, fixed)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                if not (torch.isfinite(moved).all() and torch.isfinite(warp).all()):
                    raise AssertionError(f"non-finite register output ({mode})")
                ms = wall_ms(lambda: register(moving, fixed), reps=5)

                trainer = Trainer(model.train(), terms, lr=1e-4, device="cuda")
                trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()  # warm-up
                step_tiers = tiers_taken(lambda: trainer.train_step((moving, fixed),
                                                                    (fixed, zero)))
                torch.cuda.synchronize()
                reset_launches()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    metrics = trainer.train_step((moving, fixed), (fixed, zero))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                counts = read_launches()
                check_warp_work(counts, f"the sync-free train step, {mode}")
                loss = metrics["loss"].item()
                step_s = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                    step_s.append(time.perf_counter() - t0)
                log(f"{mode}, VXM_WINDOW_HALO={TIER_HALO}, flow head N(0, {flow_std}): register "
                    f"call and train step ran under set_sync_debug_mode('error') with no host "
                    f"sync; tiers of the register call's warps {tiers}, of a step's forward "
                    f"warps {step_tiers}; the step's launches {counts}; loss {loss:.8f}; "
                    f"register {ms:.2f} ms per pair (float32), step " + ", ".join(
                        f"{x:.4f}" for x in step_s) + f" s; {smi}")
                if not np.isfinite(loss) or sorted(set(tiers + step_tiers)) != [0, 1, 2]:
                    raise AssertionError(f"the sync-free runs ({mode}) did not take every tier")
                results[enabled] = dict(register_ms=ms, step_s=float(np.median(step_s)),
                                        tiers=sorted(set(tiers + step_tiers)), launches=counts)
                del trainer, model, register
    return results


def unet_remat_check(smi):
    """Phase 6e: the U-Net's per-block remat on and off in phase 4's step
    (flow head redrawn), cuDNN and conv-kernel mode: gradients bit-equal
    (cudnn.deterministic), peak memory and seconds per step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    out = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        runs = {}
        with conv_kernel_mode(enabled):
            for remat in (True, False):
                def recipe(inshape, flow_std, remat=remat):
                    model, terms = default_recipe(inshape, flow_std)
                    model.unet.remat = remat
                    return model, terms

                saved = torch.backends.cudnn.deterministic
                torch.backends.cudnn.deterministic = True
                try:
                    loss, grads, launches = recipe_step_grads(
                        recipe, INSHAPE, "cuda", ((moving, fixed), (fixed, zero)), FLOW_STD)
                finally:
                    torch.backends.cudnn.deterministic = saved
                model, terms = recipe(INSHAPE, FLOW_STD)
                trainer = Trainer(model, terms, lr=1e-4, device="cuda")
                trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step_s = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                    step_s.append(time.perf_counter() - t0)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                runs[remat] = dict(loss=loss, grads=grads, peak=peak,
                                   s=float(np.median(step_s)), conv=launches["conv"])
                log(f"U-Net remat={remat}, {mode}: " + ", ".join(f"{x:.4f}" for x in step_s)
                    + f" s/step, peak memory allocated {peak:.3f} GiB, conv launches "
                    f"{launches['conv']}; {smi}")
                del trainer, model
        same = runs[True]["loss"] == runs[False]["loss"] and all(
            torch.equal(runs[True]["grads"][n], gr) for n, gr in runs[False]["grads"].items())
        log(f"U-Net remat against stored, {mode}: loss and {len(runs[True]['grads'])} "
            f"gradients bit-equal {same}")
        want = (TRAIN_STEP_CONVS, 2 * len(UNET_CONVS) - 1) if enabled else (0, 0)
        if not same or (runs[True]["conv"], runs[False]["conv"]) != want:
            raise AssertionError(f"the U-Net remat changed the gradients or the conv launches "
                                 f"({mode})")
        out[enabled] = {k: {r: runs[r][k] for r in (True, False)} for k in ("peak", "s")}
    return out


def draw_parts(tmp):
    """Seconds of each part of one point-cloud draw on the card, at full
    width: for each of POINT_LABELS_SAMPLED subject labels the components
    (largest island and hole fill), the blur, the threshold (the k-th
    largest blurred value) and the EDT; for
    the subject's and the atlas's SDT of each the x2 zoom and the point
    draws (as generators.surf_semisupervised computes them)."""
    from voxelmorph_tpu_torch.py import ndimage as ndi
    from voxelmorph_tpu_torch.py import utils as pu

    with np.load(f"{tmp}/subject.npz") as d:
        seg = torch.as_tensor(d["seg"], device="cuda")
    labels = np.unique(seg.cpu().numpy())[1:POINT_LABELS_SAMPLED + 1]
    parts = dict(components=0.0, blur=0.0, threshold=0.0, edt=0.0, zoom=0.0, points=0.0)
    rng = np.random.default_rng(SEED)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        parts[name] += time.perf_counter() - t0
        return result

    per = SURF_POINTS // (2 * POINT_LABELS_SAMPLED)
    for label in labels:
        mask = seg == int(label)
        island = timed("components", lambda: pu.extract_largest_vol(mask))
        filled = timed("components", lambda: ~pu.extract_largest_vol(~island))
        smooth = timed("blur", lambda: ndi.gaussian_filter(filled, 0.1))
        size = int(filled.sum().item())
        clean = timed("threshold", lambda: smooth > -torch.sort(-smooth.reshape(-1)).values[size])
        sdt = timed("edt", lambda: pu.signed_dist_trf(clean.to(torch.float64)))
        for _ in range(2):  # the subject's and the atlas's SDT of the label
            fine = timed("zoom", lambda: ndi.zoom(sdt, [2] * 3, order=1))
            timed("points", lambda: pu.edge_to_surface_pts(fine.abs() < 0.50001, per, rng=rng))
    return parts


def prefetch_check(smi):
    """Phase 6d: Trainer.fit with prefetch 2 and without (cuDNN mode, flow
    head redrawn), of the point-cloud recipe from its generator on the card
    (the producer on its own stream) and of cli/train's default fit from
    scan_to_scan over npz files (a draw is host work: two volumes read from
    disk). The batches are the same, so the parameters after the same steps
    must be bit-equal (cudnn.deterministic); seconds per step of each, and
    the parts of one point-cloud draw."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        pointcloud_files(tmp, INSHAPE, "cuda")
        return _prefetch_check(tmp, smi)


def fits_with_and_without_prefetch(label, make_generator, recipe, steps=4):
    """Trainer.fit of ``steps`` steps of ``recipe()`` (model, terms) from
    ``make_generator()``, inline and with prefetch 2, from the same weights
    (cudnn.deterministic). Each generator is drawn once on this thread
    before the fit, as the point-cloud CLI draws (the point-cloud atlas's
    SDTs are made then, on this thread's stream), then once for a warm-up
    step. Fails unless the parameters after both fits are bit-equal.
    Returns the seconds per step, {0: inline, 2: prefetch}."""
    runs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for prefetch in (0, 2):
            gen = make_generator()
            next(gen)
            model, terms = recipe()
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            trainer.train_step(*next(gen))["loss"].item()  # warm-up step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.fit(gen, epochs=1, steps_per_epoch=steps, log_fn=lambda _: None,
                                  prefetch_size=prefetch)
            torch.cuda.synchronize()
            runs[prefetch] = dict(s=(time.perf_counter() - t0) / steps, loss=metrics["loss"],
                                  params={n: p.detach().clone()
                                          for n, p in trainer.model.named_parameters()})
            del trainer, model, gen
    finally:
        torch.backends.cudnn.deterministic = saved
    equal = all(torch.equal(runs[0]["params"][n], p) for n, p in runs[2]["params"].items())
    log(f"{label} fit, {steps} steps, cuDNN: {runs[0]['s']:.4f} s/step inline, "
        f"{runs[2]['s']:.4f} s/step with prefetch 2; params bit-equal {equal}; losses "
        f"{runs[0]['loss']:.8f}, {runs[2]['loss']:.8f}")
    if not equal:
        raise AssertionError(f"prefetch changed the batches or their order ({label})")
    return {k: run["s"] for k, run in runs.items()}


def _prefetch_check(tmp, smi):
    point = fits_with_and_without_prefetch(
        "point-cloud (the generator on the card, its own stream)",
        lambda: pointcloud_generator(tmp, "cuda"), lambda: pointcloud_recipe(INSHAPE, FLOW_STD))
    # cli/train's default: scan_to_scan over four npz volumes (the pair and
    # its mirror images), the default recipe
    moving, fixed = smooth_pair(INSHAPE, "cpu")
    files = []
    for i, vol in enumerate((moving, fixed, moving.flip(1), fixed.flip(2))):
        files.append(f"{tmp}/scan{i}.npz")
        np.savez(files[-1], vol=vol[0, ..., 0].numpy())
    host = fits_with_and_without_prefetch(
        "cli/train default (scan_to_scan, volumes read from disk)",
        lambda: generators.scan_to_scan(files, rng=np.random.default_rng(SEED)),
        lambda: default_recipe(INSHAPE, FLOW_STD))
    parts = draw_parts(tmp)
    # how much of a draw is device work, which a second stream cannot hide
    # behind a step that keeps the card busy
    gen = pointcloud_generator(tmp, "cuda")
    next(gen)
    profile_device("one point-cloud draw at full width", lambda: next(gen), rows=8)
    del gen
    log("one point-cloud draw's parts on the card, s: " + json.dumps(parts) + f"; {smi}")
    return dict(inline_s=point[0], prefetch_s=point[2], host_inline_s=host[0],
                host_prefetch_s=host[2], parts=parts)


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
    parser.add_argument("--compare-gather-source", nargs="+", default=[], metavar="CU",
                        help="other copies of csrc/warp_gather.cu (an earlier commit's) "
                             "to build and time beside the package's gather kernels in "
                             "phase 2e")
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
    compare_libs = build_compare_libraries(
        [(f"{i}:{src}", src, []) for i, src in enumerate(args.compare_warp_source)],
        "warp_bounded")
    gather_builds = build_compare_libraries(
        [("counting", _build.SOURCES["warp_gather"], ["-DVXM_GATHER_COUNT=1"])]
        + [(f"source {i}:{src}", src, []) for i, src in enumerate(args.compare_gather_source)],
        "warp_gather")
    # the package's kernels built to count the backward's atomic adds and
    # merged terms (phase 2e's logs; not timed)
    counting = gather_builds.pop("counting")
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

    t = phase("2e. the predicated tiered warp at each tier; the gather kernel")
    gather_fwd_row, gather_bwd_row, skipped = check_tiered_warp(np.random.default_rng(SEED + 9),
                                                                gather_builds, counting)
    log(f"phase 2e: {time.perf_counter() - t:.2f} s")

    t = phase("3. VxmDense registration at full width")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model, launches, moved, warp = register_full_width(moving, fixed)
    if args.profile:
        profile_call(model, moving, fixed)
    del model
    bf16_vs_cpu(moved, warp, moving, fixed)
    bf16_vs_f32(moved, warp, *register_f32_vs_cpu(moving, fixed))
    log(f"phase 3: {time.perf_counter() - t:.2f} s")

    t = phase("2e(i). the gather kernels at the serving shape, by phase 3's final flow")
    serving_gather = gather_serving_shape(np.random.default_rng(SEED + 10), warp, gather_builds,
                                          counting)
    log(f"phase 2e(i): {time.perf_counter() - t:.2f} s")

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
    train_launches, redrawn_launches = train_full_width(args.profile)
    train_checkpoint_recipe()
    log(f"phase 4: {time.perf_counter() - t:.2f} s")

    t = phase("4b. VxmDense training with the conv kernel")
    conv_train_launches, conv_redrawn_launches = train_conv_kernel(moving, fixed, args.profile)
    log(f"phase 4b: {time.perf_counter() - t:.2f} s")

    t = phase("5. semi-supervised segmentation training at full width")
    semi_launches, semi_conv_launches = train_semisupervised(
        {False: redrawn_launches, True: conv_redrawn_launches}, smi)
    wide_seg_warp_check(np.random.default_rng(SEED + 7))
    log(f"phase 5: {time.perf_counter() - t:.2f} s")

    t = phase("5b. warp ops on the card")
    warp_ops_check(np.random.default_rng(SEED + 8))
    log(f"phase 5b: {time.perf_counter() - t:.2f} s")

    t = phase("6. point-cloud semi-supervised training at full width")
    point_launches, point_conv_launches = train_pointcloud(smi)
    log(f"phase 6: {time.perf_counter() - t:.2f} s")

    t = phase("6b. --cache-device and --steps-per-dispatch at full width; remat")
    cached_launches = cached_dispatch_check(smi)
    log(f"phase 6b: {time.perf_counter() - t:.2f} s")

    t = phase("6d. point-cloud fit with and without prefetch; the parts of a draw")
    prefetch = prefetch_check(smi)
    log(f"phase 6d: {time.perf_counter() - t:.2f} s")

    t = phase("6e. the U-Net's per-block remat on and off")
    unet_remat = unet_remat_check(smi)
    log(f"phase 6e: {time.perf_counter() - t:.2f} s")

    t = phase("6c. 2-D VxmDense; do_res with a final activation")
    nd_launches, res_launches = nd_and_res_check(smi)
    log(f"phase 6c: {time.perf_counter() - t:.2f} s")

    t = phase("7. register call and train step with no host sync, every tier")
    sync_free = sync_free_check(smi)
    log(f"phase 7: {time.perf_counter() - t:.2f} s")

    paths = {"register": launches, "train_step": train_launches,
             "register_conv": conv_launches, "register_fast_warp": fast_launches,
             "train_step_conv": conv_train_launches,
             "train_step_semisupervised": semi_launches,
             "train_step_semisupervised_conv": semi_conv_launches,
             "train_step_pointcloud": point_launches,
             "train_step_pointcloud_conv": point_conv_launches,
             "train_step_cached_dispatch": cached_launches,
             "train_step_2d": nd_launches, "register_do_res_conv": res_launches}
    serving, serving_bwd = rows[0], bwd_rows[0]
    conv_serving = conv_totals[("bfloat16", "fwd")]
    conv_train = {key: conv_totals[("float32", "fwd")][key] + conv_totals[("float32", "dx")][key]
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [dict(
        name="warp_bounded_fwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:269",
        launches=point_launches["fwd"], launches_ran=point_launches["fwd_ran"],
        launches_by_path={path: [n["fwd"], n["fwd_ran"]] for path, n in paths.items()},
        skipped_launch_ms=skipped["bounded_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], bound_share=serving["bound_share"],
        library_ms=serving["library_ms"]), dict(
        name="warp_bounded_bwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:952",
        launches=point_launches["bwd"], launches_ran=point_launches["bwd_ran"],
        launches_by_path={path: [n["bwd"], n["bwd_ran"]] for path, n in paths.items()},
        skipped_launch_ms=skipped["bounded_bwd"],
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        ms=serving_bwd["ms"], plain_ms=serving_bwd["plain_ms"],
        bound_ms=serving_bwd["bound_ms"], bound_by=serving_bwd["bound_by"],
        bound_share=serving_bwd["bound_share"], library_ms=serving_bwd["library_ms"]), dict(
        # the gather branch of the tiered warp: no Pallas kernel computes
        # it (the JAX package's XLA gather, interpn); times at the squaring
        # shape on a smooth field of up to TIER_HALO + 2 voxels
        name="warp_gather_fwd", route="cuda", source="voxelmorph_tpu_torch/csrc/warp_gather.cu",
        replaces="voxelmorph_tpu/ops/interp.py:301", pallas_counterpart=False,
        launches=point_launches["gather_fwd"], launches_ran=point_launches["gather_fwd_ran"],
        launches_by_path={path: [n["gather_fwd"], n["gather_fwd_ran"]]
                          for path, n in paths.items()},
        skipped_launch_ms=skipped["gather_fwd"], max_abs_err=gather_fwd_row["max_abs_err"],
        ms=gather_fwd_row["ms"], plain_ms=gather_fwd_row["plain_ms"],
        bound_ms=gather_fwd_row["bound_ms"], bound_by=gather_fwd_row["bound_by"],
        bound_share=gather_fwd_row["bound_share"], library_ms=gather_fwd_row["library_ms"],
        rough=gather_fwd_row["rough"],
        serving={case: gather_summary(rows[0]) for case, rows in serving_gather.items()}),
        dict(
        name="warp_gather_bwd", route="cuda", source="voxelmorph_tpu_torch/csrc/warp_gather.cu",
        replaces="voxelmorph_tpu/ops/interp.py:301", pallas_counterpart=False,
        launches=point_launches["gather_bwd"], launches_ran=point_launches["gather_bwd_ran"],
        launches_by_path={path: [n["gather_bwd"], n["gather_bwd_ran"]]
                          for path, n in paths.items()},
        skipped_launch_ms=skipped["gather_bwd"], dvol_zero_ms=skipped["dvol_zero"],
        max_abs_err=gather_bwd_row["max_abs_err"],
        ms=gather_bwd_row["ms"], kernel_ms=gather_bwd_row["kernel_ms"],
        plain_ms=gather_bwd_row["plain_ms"],
        bound_ms=gather_bwd_row["bound_ms"], bound_by=gather_bwd_row["bound_by"],
        bound_share=gather_bwd_row["bound_share"], library_ms=gather_bwd_row["library_ms"],
        adds=gather_bwd_row["adds"], merged=gather_bwd_row["merged"],
        rough=gather_bwd_row["rough"],
        serving={case: gather_summary(rows[1]) for case, rows in serving_gather.items()}),
        dict(
        # times: the 11 forward convs of a bfloat16 register call, summed;
        # train_step_conv: the 11 forward and 10 input-gradient convs of a
        # float32 train step
        name="conv3_fwd", route="cuda", source="voxelmorph_tpu_torch/csrc/conv3.cu",
        replaces="voxelmorph_tpu/ops/pallas_conv.py:124",
        launches=point_conv_launches["conv"],
        launches_by_path={path: n["conv"] for path, n in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in conv_rows),
        max_err_over_tol=max(r["max_err_over_tol"] for r in conv_rows),
        ms=conv_serving["ms"], plain_ms=conv_serving["plain_ms"],
        bound_ms=conv_serving["bound_ms"], bound_by=conv_serving["bound_by"],
        library_ms=conv_serving["library_ms"], register_conv_ms_per_pair=conv_ms,
        train_step_conv=conv_train, tensor_core_instructions=hmma)]
    log("summary: " + json.dumps(dict(
        sync_free={("conv_kernel" if k else "cudnn"): v for k, v in sync_free.items()},
        prefetch=prefetch,
        unet_remat={("conv_kernel" if k else "cudnn"): {
            key: {("on" if r else "off"): x for r, x in val.items()} for key, val in v.items()}
            for k, v in unet_remat.items()})))
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
