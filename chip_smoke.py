#!/usr/bin/env python3
"""Build and drive the PyTorch port (voxelmorph_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --profile  # also print a profiler breakdown of one call

Phases:
  1. device and build: the card's name and power limit (nvidia-smi), then
     every CUDA kernel of the port built with nvcc from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it and at stress shapes, with times
     beside the bound, the plain version and one PyTorch library call;
  3. the serving path end to end: the committed full-width VxmDense
     checkpoint (160x192x224, bfloat16) registers a synthetic smooth pair
     through build_register_fn; the kernel launch counts of that call must
     be nonzero, and its outputs must agree with the port's own bfloat16
     CPU run; then the same in float32 (TF32 off) against the port's own
     CPU run, and the bfloat16 outputs against the float32 ones;
  2b. the bounded-warp backward kernel against its plain version at phase
     2's shapes, bit-equal across two launches, with times beside the bound,
     the plain version and the backward of grid_sample;
  2c. gradients through warp_bounded and integrate_vec_batched on CUDA
     tensors (the backward kernel) against the same on the CPU;
  4. training at full width: the default recipe of scripts/train.py (MSE +
     Grad-l2, Adam 1e-4, float32) on VxmDense at 160x192x224 from seed 0:
     one step's loss and gradients through the kernels against the
     gather-only path, the card against the port's CPU run at 80x96x112,
     ten steps that lower the loss with the backward kernel launched in
     every step, the time per step and the peak memory; then three steps of
     the committed checkpoint's own recipe (use_probs, NCC, KL, bfloat16).
It prints a JSON line of kernel results and, last, a JSON line with the
device. Any failure prints a traceback and exits non-zero without that line.
Nothing is written to the repository except the kernel build directory.
"""

from __future__ import annotations

import argparse
import contextlib
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
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.ops.interp import ndgrid, resize
from voxelmorph_tpu_torch.ops.warp_bounded import (warp_bounded, warp_bounded_bwd,
                                                   warp_bounded_bwd_plain, windowed_transform)
from voxelmorph_tpu_torch.registration import build_register_fn
from voxelmorph_tpu_torch.training import LossTerm, Trainer

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "artifacts_r4" / "probs_ncc_0050.npz"
INSHAPE = (160, 192, 224)
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12

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


def phase(name):
    log(f"\n== {name}")
    return time.perf_counter()


def time_cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms over ``reps`` runs, each with a
    cold L2 (a 256 MB buffer is written before each run)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def grid_sample_warp(vol_cf, grid):
    """The library comparator: trilinear grid_sample with border clamping."""
    return F.grid_sample(vol_cf, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def check_warp_bounded(rng):
    """Kernel vs plain version at the serving shape and stress shapes."""
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
        row = dict(
            shape=[batch, *spatial, nch], halo=halo, max_abs_err=err,
            grid_sample_err=lib_err,
            ms=time_cuda_ms(lambda: warp_bounded(vol, shift, halo)),
            plain_ms=time_cuda_ms(lambda: windowed_transform(vol, shift, halo)),
            library_ms=time_cuda_ms(lambda: grid_sample_warp(vol_cf, grid)),
            bound_ms=bound_ms,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S else "operations")
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

    warp_bounded.launches = warp_bounded_bwd.launches = 0
    t0 = time.perf_counter()
    moved, warp = register(moving, fixed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"fwd": warp_bounded.launches, "bwd": warp_bounded_bwd.launches}
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def check_warp_bounded_bwd(rng):
    """Backward kernel vs plain version at phase 2's shapes: within
    KERNEL_TOL, and bit-equal across two launches (no atomics)."""
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
            ms=time_cuda_ms(lambda: warp_bounded_bwd(vol, shift, g, halo)),
            # the plain version is slow at the large halos: fewer runs
            plain_ms=time_cuda_ms(lambda: warp_bounded_bwd_plain(vol, shift, g, halo),
                                  reps=5, warmup=1),
            library_ms=time_cuda_ms(lambda: torch.autograd.grad(
                out_cf, (vol_cf, grid), g_cf, retain_graph=True)),
            bound_ms=bound_ms, bound_by=bound_by)
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


def default_recipe(inshape):
    """scripts/train.py's default: MSE + Grad('l2', loss_mult=2), weight 0.01,
    on a float32 VxmDense with default features, initialised from seed 0."""
    model = VxmDense(inshape, int_steps=7, int_resolution=2,
                     generator=torch.Generator().manual_seed(SEED))
    terms = [LossTerm("y_source", losses.MSE(1.0).loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                      target_index=1, name="grad")]
    return model, terms


def one_step_grads(inshape, device, moving, fixed, flow_std=None):
    """Loss and parameter gradients of one train step of the default recipe
    (no update), with the kernel launch counts of the step. ``flow_std``
    redraws the flow head's kernel as N(0, flow_std) (seed 1), for flows of
    about a voxel instead of the init's ~1e-5."""
    model, terms = default_recipe(inshape)
    if flow_std is not None:
        with torch.no_grad():
            model.flow.weight.normal_(0.0, flow_std,
                                      generator=torch.Generator().manual_seed(SEED + 1))
    trainer = Trainer(model, terms, device=device)
    trainer.model.train()
    zero = torch.zeros((1, *inshape, 3), device=device)
    warp_bounded.launches = warp_bounded_bwd.launches = 0
    loss, _ = trainer.loss_fn((moving.to(device), fixed.to(device)), (fixed.to(device), zero))
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}
    return loss.item(), grads, {"fwd": warp_bounded.launches, "bwd": warp_bounded_bwd.launches}


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
                        help="print a profiler breakdown of one bfloat16 register call")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    # the serving path's own halo rule, whatever the environment says
    os.environ.pop("VXM_WINDOW_HALO", None)
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
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"phase 1: {time.perf_counter() - t:.2f} s")

    t = phase("2. warp_bounded kernel vs plain version")
    rows = check_warp_bounded(np.random.default_rng(SEED))
    log(f"phase 2: {time.perf_counter() - t:.2f} s")

    t = phase("2b. warp_bounded backward kernel vs plain version")
    bwd_rows = check_warp_bounded_bwd(np.random.default_rng(SEED + 1))
    log(f"phase 2b: {time.perf_counter() - t:.2f} s")

    t = phase("2c. gradients through the bounded warp: GPU vs CPU")
    check_grads_gpu_vs_cpu(np.random.default_rng(SEED + 2))
    log(f"phase 2c: {time.perf_counter() - t:.2f} s")

    t = phase("3. VxmDense registration at full width")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model, launches, moved, warp = register_full_width(moving, fixed)
    if args.profile:
        profile_call(model, moving, fixed)
    del model
    bf16_vs_cpu(moved, warp, moving, fixed)
    bf16_vs_f32(moved, warp, *register_f32_vs_cpu(moving, fixed))
    log(f"phase 3: {time.perf_counter() - t:.2f} s")

    t = phase("4. VxmDense training at full width")
    train_launches = train_full_width(args.profile)
    train_checkpoint_recipe()
    log(f"phase 4: {time.perf_counter() - t:.2f} s")

    serving, serving_bwd = rows[0], bwd_rows[0]
    kernels = [dict(
        name="warp_bounded_fwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:269",
        launches=train_launches["fwd"],
        launches_by_path={"register": launches["fwd"], "train_step": train_launches["fwd"]},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], library_ms=serving["library_ms"]), dict(
        name="warp_bounded_bwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:952",
        launches=train_launches["bwd"],
        launches_by_path={"register": launches["bwd"], "train_step": train_launches["bwd"]},
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        ms=serving_bwd["ms"], plain_ms=serving_bwd["plain_ms"],
        bound_ms=serving_bwd["bound_ms"], bound_by=serving_bwd["bound_by"],
        library_ms=serving_bwd["library_ms"])]
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
