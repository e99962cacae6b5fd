"""Runner: unsupervised VxmDense training on scan-to-scan pairs drawn on the
device (``Trainer.fit_cached_pairs``, as ``cli/train --cache-device
--steps-per-dispatch K`` runs it), on one card or data-parallel over a
process group of one rank a card (``parallel.mesh``, DDP).

Set-up builds the Trainer from the checkpoint's weights in the traffic's
dtype and runs its first three steps through ``fit_cached_pairs`` one at a
time (the window's own call, on the stream's steps 0-2), which also warms
every shape, then ``WARMUP_DISPATCHES`` dispatches of K steps. The window
then calls it a dispatch of K steps at a time until ``--seconds`` have
passed; the rate counts every pair of every step completed, over the
window, which ends at the dispatch's host fetch. After the window the
reference repeats the three steps.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from h100_bench import compare, data, harness, trace
from h100_bench.reference import common as ref_common
from h100_bench.reference import vxm as ref_vxm

COMPARED_STEPS = 3
# dispatches of K steps run before the window, in set-up: over a process
# group of four ranks the first two run 2-10% slower than the later ones
WARMUP_DISPATCHES = 2


def _picks(seed: int, n: int, batch: int, step: int) -> np.ndarray:
    """The pairs' stream (the rule of ``device_cached_pair_indices``, kept
    here for the reference): step ``step`` draws 2B indices from
    ``default_rng((seed, step))``, sources then targets."""
    return np.random.default_rng((seed, step)).integers(n, size=2 * batch).astype(np.int32)


def run(ctx) -> dict:
    from voxelmorph_tpu_torch import losses
    from voxelmorph_tpu_torch.models.modelio import load_model
    from voxelmorph_tpu_torch.ops import conv3
    from voxelmorph_tpu_torch.parallel.mesh import initialize_distributed
    from voxelmorph_tpu_torch.training import LossTerm, Trainer

    cfg = ctx.cell.config
    traffic = dict(ctx.cell.traffic, **ctx.overrides.get("traffic", {}))
    model_cfg, recipe = dict(cfg["model"]), cfg["recipe"]
    model_cfg.update(ctx.overrides.get("model", {}))
    world, rank = ctx.world, ctx.rank
    if world > 1:
        initialize_distributed(f"localhost:{ctx.port}", world, rank, ctx.device)
    device = torch.device(ctx.device, torch.cuda.current_device()) \
        if ctx.device == "cuda" else torch.device(ctx.device)
    torch.backends.cudnn.allow_tf32 = traffic["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = traffic["tf32"]["matmul"]
    conv3.set_pallas_conv(cfg["conv_mode"] == "kernel")
    batch = int(traffic["batch"])
    per_dispatch = int(traffic["steps_per_dispatch"])
    inshape = tuple(model_cfg["inshape"])
    stack_n = int(traffic["stack"])

    harness.mark(ctx.t_start, "imported, process group joined")
    stack, _ = data.volume_stack(stack_n, inshape, ctx.seeds.data, device)
    harness.mark(ctx.t_start, "volumes made")
    ckpt = str(harness.ROOT / cfg["weights"]["checkpoint"])
    model = load_model(ckpt, device=device, dtype=getattr(torch, traffic["dtype"]),
                       inshape=inshape)
    terms = [LossTerm("y_source", losses.NCC().loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.KL(recipe["kl_prior_lambda"], inshape).loss,
                      weight=recipe["kl_weight"], target_index=1, name="kl")]
    trainer = Trainer(model, terms, lr=recipe["lr"], seed=ctx.seeds.trainer, device=device)
    trainer.init(sample_inputs=(stack[:batch], stack[:batch]))
    ctx.fault_hook(trainer)
    harness.mark(ctx.t_start, "model loaded")

    def fit(start, steps):
        return trainer.fit_cached_pairs(stack, epochs=1, steps_per_epoch=steps,
                                        steps_per_dispatch=steps, batch_size=batch,
                                        seed=ctx.seeds.picks, start_step=start,
                                        log_fn=lambda _: None)

    start = compare.params(model)
    step_losses, grads = [], None
    for step in range(COMPARED_STEPS):
        step_losses.append(fit(step, 1)["loss"])
        harness.mark(ctx.t_start, f"compared step {step}")
        if step == 0:
            grads = compare.first_gradient(model, trainer.optimizer)
    end = compare.params(model)
    first = COMPARED_STEPS
    for _ in range(WARMUP_DISPATCHES):
        fit(first, per_dispatch)
        first += per_dispatch
    if world > 1:
        dist.barrier()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_start

    def window():
        t0 = time.perf_counter()
        step, done, ends = first, 0, [t0]
        while True:
            fit(step, per_dispatch)
            step += per_dispatch
            done += per_dispatch
            ends.append(time.perf_counter())
            stop = torch.tensor([time.perf_counter() - t0 >= ctx.seconds], device=device)
            if world > 1:
                dist.broadcast(stop, 0)
            if bool(stop.item()):
                break
        harness.log("dispatch seconds " + " ".join(f"{b - a:.4f}" for a, b in zip(ends, ends[1:])))
        return done, time.perf_counter() - t0

    tr = None
    if ctx.trace:
        with trace.spans():
            (steps, window_s), tr = trace.record(window)
    else:
        steps, window_s = window()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = harness.RunData(trace=tr, steps=steps, pairs=steps * batch, window_s=window_s,
                          world=world, rank=rank, dtype=traffic["dtype"], config=cfg,
                          traffic=traffic, model=model_cfg)
    gathered = ctx.gather(run, peak)
    if rank:
        return {}
    del trainer, model, terms
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    harness.mark(ctx.t_start, "window closed")
    with ref_common.precision(None):
        w = ref_common.weights_from_npz(ckpt, device)
        ref_start = {k: v.clone() for k, v in w.items()}
        g = torch.Generator(device=device)
        g.manual_seed(ctx.seeds.trainer)
        picks = [_picks(ctx.seeds.picks, stack_n, batch, s) for s in range(COMPARED_STEPS)]
        reference = ref_vxm.train_steps(w, model_cfg, recipe, stack, picks, g)
    gaps = compare.training_gaps(step_losses, grads, start, end, reference, ref_start)
    harness.mark(ctx.t_start, "reference done")
    harness.log(f"training gaps {gaps}; program losses {step_losses}, reference losses "
                f"{reference['losses']}")
    return {"setup_s": setup_s, "rate": {"pairs_per_s": steps * batch / window_s},
            "attempted": steps, "gaps": gaps, "gathered": gathered}


def control(cell, seeds, device, model, lowp, faults=()) -> list:
    """The control's numbers (``control.py``): the reference computed in
    ``lowp`` in the program's place, then the sound reference with each
    fault of ``faults`` planted (``half_batch``, ``no_exchange``: faults of
    a step over ranks), each against the sound reference, on this cell's
    inputs from ``seeds``."""
    cfg, traffic = cell.config, cell.traffic
    batch, stack_n = int(traffic["batch"]), int(traffic["stack"])
    stack, _ = data.volume_stack(stack_n, model["inshape"], seeds.data, device)
    ckpt = str(harness.ROOT / cfg["weights"]["checkpoint"])
    picks = [_picks(seeds.picks, stack_n, batch, s) for s in range(COMPARED_STEPS)]

    def steps_of(lowp, fault):
        w = ref_common.weights_from_npz(ckpt, device)
        start = {k: v.clone() for k, v in w.items()}
        g = torch.Generator(device=device)
        g.manual_seed(seeds.trainer)
        with ref_common.precision(lowp):
            return ref_vxm.train_steps(w, model, cfg["recipe"], stack, picks, g, lowp,
                                       fault), start

    sound, start = steps_of(None, None)
    out = []
    for lowp_, fault in [(lowp, None)] + [(None, f) for f in faults]:
        got, _ = steps_of(lowp_, fault)
        out.append(compare.training_gaps(got["losses"], got["first_grads"], start,
                                         got["params"], sound, start))
    return out
