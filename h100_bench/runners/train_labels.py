"""Runner: SynthMorph training on label-map pairs held on the device
(``Trainer.fit_cached_labels``, as ``cli/train_synthmorph --cache-device
--steps-per-dispatch K`` runs it): each step synthesizes two images and
their soft one-hots on the device from the Trainer's generator, registers
them and takes an Adam step on Dice + Grad-l2.

Set-up loads the configuration's checkpoint (its weights; a fresh Adam),
runs the first three steps through ``fit_cached_labels`` one at a time (the
stream's steps 0-2), then starts one long call from step 3 whose first
``WARMUP_DISPATCHES`` dispatches of K steps close set-up
(``fit_cached_labels`` copies the maps to the device as it starts). The
window runs from the last warm-up dispatch's host fetch to the first fetch
at least ``--seconds`` later, and counts the steps between.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from h100_bench import compare, data, harness, trace
from h100_bench.reference import common as ref_common
from h100_bench.reference import synth as ref_synth

COMPARED_STEPS = 3
# dispatches of K steps run before the window, in set-up
WARMUP_DISPATCHES = 1


class _Closed(Exception):
    """Raised from the epoch callback to end the window."""


def _stream(seed: int, n: int, nd: int, batch: int, step: int):
    """The label pairs' stream (the rule of ``device_cached_label_indices``,
    kept here for the reference): (picks (2B,), flip flags (nd,))."""
    rng = np.random.default_rng((seed, step))
    picks = rng.integers(n, size=2 * batch).astype(np.int32)
    flags = np.zeros(nd, bool)
    axes = rng.choice(nd, size=int(rng.integers(nd + 1)), replace=False, shuffle=False)
    flags[np.asarray(axes, int)] = True
    return picks, flags


def run(ctx) -> dict:
    from voxelmorph_tpu_torch.cli.train_synthmorph import synthmorph_terms
    from voxelmorph_tpu_torch.models.modelio import load_model
    from voxelmorph_tpu_torch.models.synthmorph import LabelsToImageConfig
    from voxelmorph_tpu_torch.ops import conv3
    from voxelmorph_tpu_torch.training import Trainer

    cfg = ctx.cell.config
    traffic = dict(ctx.cell.traffic, **ctx.overrides.get("traffic", {}))
    model_cfg, recipe = dict(cfg["model"]), cfg["recipe"]
    model_cfg.update(ctx.overrides.get("model", {}))
    synth = dict(cfg["synthesis"], in_shape=list(model_cfg["inshape"]))
    synth["out_label_list"] = synth["in_label_list"][:synth["nb_out_labels"]]
    device = torch.device(ctx.device)
    torch.backends.cudnn.allow_tf32 = traffic["tf32"]["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = traffic["tf32"]["matmul"]
    conv3.set_pallas_conv(cfg["conv_mode"] == "kernel")
    batch = int(traffic["batch"])
    per_dispatch = int(traffic["steps_per_dispatch"])
    inshape = tuple(model_cfg["inshape"])
    n_maps = int(traffic["stack"])

    harness.mark(ctx.t_start, "imported")
    volumes, _ = data.volume_stack(n_maps, inshape, ctx.seeds.data, device)
    maps = data.label_maps(volumes, synth["in_label_list"], ctx.seeds.data)
    del volumes
    host_maps = list(maps.cpu().numpy())
    harness.mark(ctx.t_start, "label maps made")
    lcfg = LabelsToImageConfig(
        in_shape=inshape, in_label_list=synth["in_label_list"],
        out_label_list=synth["out_label_list"], warp_std=synth["warp_std"],
        warp_res=synth["warp_res"], blur_std=synth["blur_std"], bias_std=synth["bias_std"],
        bias_res=synth["bias_res"], gamma_std=synth["gamma_std"])
    ckpt = str(harness.ROOT / cfg["weights"]["checkpoint"])
    model = load_model(ckpt, device=device, dtype=getattr(torch, traffic["dtype"]), cfg=lcfg,
                       shared_contrast=recipe["shared_contrast"])
    trainer = Trainer(model, synthmorph_terms(recipe["reg_param"]), lr=recipe["lr"],
                      seed=ctx.seeds.trainer, device=device)
    trainer.init()
    ctx.fault_hook(trainer)
    harness.mark(ctx.t_start, "model made")

    def fit(start, steps, epochs=1, log_fn=lambda _: None):
        return trainer.fit_cached_labels(host_maps, epochs=epochs, steps_per_epoch=steps,
                                         steps_per_dispatch=steps, batch_size=batch,
                                         seed=ctx.seeds.picks, start_step=start, log_fn=log_fn)

    start = compare.params(model)
    step_losses, grads = [], None
    for step in range(COMPARED_STEPS):
        step_losses.append(fit(step, 1)["loss"])
        harness.mark(ctx.t_start, f"compared step {step}")
        if step == 0:
            grads = compare.first_gradient(model, trainer.optimizer)
    end = compare.params(model)

    marks, rec, out = [], trace.Recorder() if ctx.trace else None, {}

    def epoch_done(_):
        marks.append(time.perf_counter())
        if len(marks) == WARMUP_DISPATCHES:
            out["setup_s"] = marks[-1] - ctx.t_start
            if rec is not None:
                rec.start()
        elif len(marks) > WARMUP_DISPATCHES and marks[-1] - marks[WARMUP_DISPATCHES - 1] \
                >= ctx.seconds:
            raise _Closed

    with trace.spans() if ctx.trace else contextlib.nullcontext():
        try:
            fit(COMPARED_STEPS, per_dispatch, epochs=1 << 30, log_fn=epoch_done)
        except _Closed:
            pass
        tr = rec.stop() if rec is not None else None
    marks = marks[WARMUP_DISPATCHES - 1:]
    steps, window_s = per_dispatch * (len(marks) - 1), marks[-1] - marks[0]
    harness.log("dispatch seconds " + " ".join(f"{b - a:.4f}" for a, b in zip(marks, marks[1:])))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = harness.RunData(trace=tr, steps=steps, pairs=steps * batch, window_s=window_s,
                          dtype=traffic["dtype"], config=cfg, traffic=traffic, model=model_cfg)
    gathered = ctx.gather(run, peak)
    del trainer, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    harness.mark(ctx.t_start, "window closed")
    with ref_common.precision(None):
        weights = ref_common.weights_from_npz(ckpt, device)
        ref_start = {k: v.clone() for k, v in weights.items()}
        g = torch.Generator(device=device)
        g.manual_seed(ctx.seeds.trainer)
        stream = [_stream(ctx.seeds.picks, n_maps, len(inshape), batch, s)
                  for s in range(COMPARED_STEPS)]
        reference = ref_synth.train_steps(weights, model_cfg, recipe, synth, maps, stream, g)
    gaps = compare.training_gaps(step_losses, grads, start, end, reference, ref_start)
    harness.mark(ctx.t_start, "reference done")
    harness.log(f"training gaps {gaps}; program losses {step_losses}, reference losses "
                f"{reference['losses']}")
    return {"setup_s": out["setup_s"], "rate": {"pairs_per_s": steps * batch / window_s},
            "attempted": steps, "gaps": gaps, "gathered": gathered}



def control(cell, seeds, device, model, lowp, faults=()) -> list:
    """The control's numbers (``control.py``): the reference computed in
    ``lowp`` in the program's place, against the sound reference, on this
    cell's inputs from ``seeds``. SynthMorph has no fault of its own here."""
    cfg, traffic = cell.config, cell.traffic
    batch, n = int(traffic["batch"]), int(traffic["stack"])
    synth = dict(cfg["synthesis"], in_shape=list(model["inshape"]))
    synth["out_label_list"] = synth["in_label_list"][:synth["nb_out_labels"]]
    volumes, _ = data.volume_stack(n, model["inshape"], seeds.data, device)
    maps = data.label_maps(volumes, synth["in_label_list"], seeds.data)
    del volumes
    weights = ref_common.weights_from_npz(str(harness.ROOT / cfg["weights"]["checkpoint"]),
                                          device)
    nd = len(model["inshape"])
    stream = [_stream(seeds.picks, n, nd, batch, s) for s in range(COMPARED_STEPS)]
    runs = {}
    for name, p in (("reference", None), ("control", lowp)):
        w = {k: v.clone() for k, v in weights.items()}
        g = torch.Generator(device=device)
        g.manual_seed(seeds.trainer)
        with ref_common.precision(p):
            runs[name] = ref_synth.train_steps(w, model, cfg["recipe"], synth, maps, stream, g, p)
    ctl = runs["control"]
    return [compare.training_gaps(ctl["losses"], ctl["first_grads"], weights, ctl["params"],
                                  runs["reference"], weights)]
