"""Runner: scan-to-atlas batch registration (``registration.build_register_fn``)
in a closed loop with one client: each call registers B moving scans drawn
from a stack on the device to the atlas, and the next call is dispatched
once the previous call's moved images and warps are ready (a synchronise).

Set-up loads the checkpoint in the traffic's dtype and makes two calls,
which build or load every kernel and warm each shape. A call's latency runs
from its dispatch to its outputs ready; the rate counts the pairs of every
call of the window. The outputs of a sample of calls, drawn from the seed,
are kept (no copy) and compared with the reference's after the window.

A traced run first runs the window untraced, for the host's time to enqueue
a call (``dispatch_s``: the profiler's events would add to it), then the
traced window, whose outputs are compared.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from h100_bench import compare, data, harness, trace
from h100_bench.reference import common as ref_common
from h100_bench.reference import vxm as ref_vxm

MAX_CALLS = 1 << 15


def run(ctx) -> dict:
    from voxelmorph_tpu_torch.models.modelio import load_model
    from voxelmorph_tpu_torch.ops import conv3
    from voxelmorph_tpu_torch.registration import build_register_fn

    cfg = ctx.cell.config
    traffic = dict(ctx.cell.traffic, **ctx.overrides.get("traffic", {}))
    model_cfg = dict(cfg["model"])
    model_cfg.update(ctx.overrides.get("model", {}))
    device = torch.device(ctx.device)
    torch.backends.cudnn.allow_tf32 = traffic["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = traffic["tf32"]["matmul"]
    conv3.set_pallas_conv(cfg["conv_mode"] == "kernel")
    batch = int(traffic["batch"])
    inshape = tuple(model_cfg["inshape"])
    stack_n = int(traffic["stack"])

    harness.mark(ctx.t_start, "imported")
    stack, atlas = data.volume_stack(stack_n, inshape, ctx.seeds.data, device)
    harness.mark(ctx.t_start, "volumes made")
    fixed = atlas.expand(batch, *atlas.shape[1:])
    rng = np.random.default_rng(ctx.seeds.picks)
    picks_host = rng.integers(stack_n, size=(MAX_CALLS, batch))
    picks = torch.as_tensor(picks_host, device=device)
    sample = set(np.random.default_rng(ctx.seeds.sample).choice(
        int(traffic["sample_from"]), int(traffic["sample_calls"]), replace=False).tolist())
    ckpt = str(harness.ROOT / cfg["weights"]["checkpoint"])
    model = load_model(ckpt, device=device, dtype=getattr(torch, traffic["dtype"]),
                       inshape=inshape)
    register = ctx.fault_hook(build_register_fn(model))
    harness.mark(ctx.t_start, "model loaded")
    for i in (MAX_CALLS - 1, MAX_CALLS - 2):
        register(stack.index_select(0, picks[i]), fixed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_start
    harness.mark(ctx.t_start, "warmed up")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def window(first=0):
        latencies, dispatch, kept = [], [], {}
        t0 = time.perf_counter()
        for i in range(first, MAX_CALLS - 2):
            moving = stack.index_select(0, picks[i])
            a = time.perf_counter()
            moved, warp = register(moving, fixed)
            b = time.perf_counter()
            sync()
            c = time.perf_counter()
            latencies.append(c - a)
            dispatch.append(b - a)
            if i - first in sample:
                kept[i] = (moved, warp)
            if c - t0 >= ctx.seconds:
                break
        return latencies, dispatch, kept, time.perf_counter() - t0

    tr = None
    if ctx.trace:
        _, dispatch, _, _ = window()
        first = len(dispatch)
        with trace.spans():
            (latencies, _, kept, window_s), tr = trace.record(lambda: window(first))
    else:
        first = 0
        latencies, dispatch, kept, window_s = window()
    calls = len(latencies)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = harness.RunData(trace=tr, calls=calls, pairs=calls * batch, window_s=window_s,
                          dtype=traffic["dtype"], config=cfg, traffic=traffic, model=model_cfg,
                          dispatch_s=dispatch)
    gathered = ctx.gather(run, peak)
    del model, register
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # every sampled call is due in the window; one the window did not reach
    # never came, and fails
    harness.mark(ctx.t_start, "window closed")
    missing = sorted(i for i in sample if i >= calls)
    warp_err = moved_err = 0.0
    with ref_common.precision(None):
        w = ref_common.weights_from_npz(ckpt, device)
        for i, (moved, warp) in sorted(kept.items()):
            moving = stack[torch.as_tensor(picks_host[i], device=device)]
            ref_moved, ref_warp = ref_vxm.register(w, model_cfg, moving, fixed)
            warp_err = max(warp_err, compare.relative_rms(warp.float(), ref_warp))
            moved_err = max(moved_err, compare.relative_rms(moved.float(), ref_moved))
    harness.mark(ctx.t_start, "reference done")
    if missing:
        warp_err = moved_err = float("inf")
    harness.log(f"sampled calls {sorted(kept)}, missing {missing}; worst relative RMS: warp "
                f"{warp_err:.6g}, moved {moved_err:.6g}")
    q = statistics.quantiles(latencies, n=20, method="inclusive") if calls > 1 else latencies
    return {"setup_s": setup_s,
            "rate": {"pairs_per_s": calls * batch / window_s, "p95_ms": q[-1] * 1e3},
            "attempted": calls, "gaps": {"warp_err": warp_err, "moved_err": moved_err},
            "failed_calls": len(missing), "gathered": gathered}


def control(cell, seeds, device, model, lowp, faults=()) -> list:
    """The control's numbers (``control.py``): the reference computed in
    ``lowp`` in the program's place, against the sound reference, over two
    calls of this cell's inputs from ``seeds``."""
    traffic = cell.traffic
    batch, stack_n = int(traffic["batch"]), int(traffic["stack"])
    stack, atlas = data.volume_stack(stack_n, model["inshape"], seeds.data, device)
    fixed = atlas.expand(batch, *atlas.shape[1:])
    picks = np.random.default_rng(seeds.picks).integers(stack_n, size=(2, batch))
    w = ref_common.weights_from_npz(str(harness.ROOT / cell.config["weights"]["checkpoint"]),
                                    device)
    warp_err = moved_err = 0.0
    for pk in picks:
        moving = stack[torch.as_tensor(pk, device=device)]
        with ref_common.precision(None):
            ref_moved, ref_warp = ref_vxm.register(w, model, moving, fixed)
            moved, warp = ref_vxm.register(w, model, moving, fixed, lowp)
        warp_err = max(warp_err, compare.relative_rms(warp, ref_warp))
        moved_err = max(moved_err, compare.relative_rms(moved, ref_moved))
    return [{"warp_err": warp_err, "moved_err": moved_err}]
