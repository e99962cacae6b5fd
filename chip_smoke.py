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
     CPU run, and the bfloat16 outputs against the float32 ones.
It prints a JSON line of kernel results and, last, a JSON line with the
device. Any failure prints a traceback and exits non-zero without that line.
Nothing is written to the repository except the kernel build directory.
"""

from __future__ import annotations

import argparse
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

from voxelmorph_tpu_torch import _build
from voxelmorph_tpu_torch.models.modelio import load_model
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.ops.interp import ndgrid, resize
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded, windowed_transform
from voxelmorph_tpu_torch.registration import build_register_fn

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "artifacts_r4" / "probs_ncc_0050.npz"
INSHAPE = (160, 192, 224)
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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


def log(*args):
    print(*args, flush=True)


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
    cases = [  # (batch, spatial, channels, halo); the first is the serving shape
        (1, (80, 96, 112), 3, 1),
        (2, (80, 96, 112), 3, 1),
        (2, (80, 96, 112), 3, 2),
        (1, INSHAPE, 1, 2),
        # the other channel counts and halos the wrapper accepts; halo 4 with
        # 4 channels needs more than 48 KB of shared memory per block
        (1, (80, 96, 112), 2, 3),
        (1, (80, 96, 112), 4, 4),
    ]
    rows = []
    for batch, spatial, nch, halo in cases:
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

    warp_bounded.launches = 0
    t0 = time.perf_counter()
    moved, warp = register(moving, fixed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = warp_bounded.launches
    log(f"first call {first_s:.3f} s; warp_bounded launches {launches}")
    if launches == 0:
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


def profile_call(model, moving, fixed):
    """Device time by kernel over one bfloat16 register call, and the share
    of the call's wall time in which the device ran no kernel."""
    register = build_register_fn(model)
    register(moving, fixed)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        register(moving, fixed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels only: operator events repeat the time of the kernels they launch
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    log(f"profiled call: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}")
    log(events.table(sort_by="self_device_time_total", row_limit=25))


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

    t = phase("3. VxmDense registration at full width")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model, launches, moved, warp = register_full_width(moving, fixed)
    if args.profile:
        profile_call(model, moving, fixed)
    del model
    bf16_vs_cpu(moved, warp, moving, fixed)
    bf16_vs_f32(moved, warp, *register_f32_vs_cpu(moving, fixed))
    log(f"phase 3: {time.perf_counter() - t:.2f} s")

    serving = rows[0]
    kernels = [dict(
        name="warp_bounded_fwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:269",
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], library_ms=serving["library_ms"])]
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
