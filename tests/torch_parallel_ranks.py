"""The data-parallel scenarios of ``tests/test_torch_parallel.py``.

Each scenario takes the case (the inputs, made with numpy in the test
process) and returns numpy results. The test runs every scenario in one
process (a world of one rank) and in each rank of a gloo world of two,
started as

    python tests/torch_parallel_ranks.py RANK WORLD STORE DIR

which joins the world through the ``file://`` store ``STORE``, reads the
case from ``DIR/case.pkl`` and writes its results to ``DIR/rank{RANK}.pkl``.
The module imports torch, numpy and the port only.
"""

import os
import pickle
import sys
import warnings

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from voxelmorph_tpu_torch import losses  # noqa: E402
from voxelmorph_tpu_torch.cli.train_template import template_terms  # noqa: E402
from voxelmorph_tpu_torch.models import modelio, synthmorph  # noqa: E402
from voxelmorph_tpu_torch.models.atlas import TemplateCreation  # noqa: E402
from voxelmorph_tpu_torch.models.vxm import VxmDense  # noqa: E402
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from voxelmorph_tpu_torch.registration import build_register_fn  # noqa: E402
from voxelmorph_tpu_torch.training import LossTerm, Trainer, init_or_resume  # noqa: E402

SHAPE = (8, 8, 8)
FEATS = [[4], [4, 4]]
LR = 1e-3
# the JAX models of the DP steps, by int_steps (int_resolution 1 without
# integration, as tests/test_sharding.py's DP-vs-single test has it)
CONFIGS = {0: dict(int_steps=0, int_resolution=1), 1: dict(int_steps=1, int_resolution=2)}


def dp_terms():
    """tests/test_sharding.py's loss terms: MSE, and Grad-l2 at 0.01."""
    return [LossTerm("y_source", losses.MSE().loss, weight=1.0, target_index=0),
            LossTerm("reg", losses.Grad("l2").loss, weight=0.01, target_index=1, name="grad")]


def vxm(case, int_steps):
    """The VxmDense of ``CONFIGS[int_steps]`` with the case's (JAX) params."""
    model = VxmDense(SHAPE, nb_unet_features=FEATS, **CONFIGS[int_steps])
    model.load_state_dict(modelio.params_from_jax(case["params"][int_steps]))
    return model


def state(model):
    """Parameters and buffers as numpy, by state-dict name."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def steps(trainer, inputs, targets, n=2):
    return [float(trainer.train_step(inputs, targets)["loss"]) for _ in range(n)]


def dp(case, int_steps):
    """Two steps at batch 8 (tests/test_sharding.py's DP step)."""
    model = vxm(case, int_steps)
    trainer = Trainer(model, dp_terms(), lr=LR, device="cpu")
    losses_ = steps(trainer, *case["batch8"])
    return dict(params=state(model), losses=losses_, data=trainer.mesh.shape["data"])


def probs(case):
    """use_probs (the noise drawn at the global batch's shape): two steps
    of MSE + KL at batch 4."""
    model = VxmDense(SHAPE, nb_unet_features=FEATS, int_steps=1, use_probs=True,
                     generator=torch.Generator().manual_seed(0))
    terms = [LossTerm("y_source", losses.MSE().loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.KL(10.0, SHAPE).loss, weight=0.01, target_index=1,
                      name="kl")]
    trainer = Trainer(model, terms, lr=LR, device="cpu")
    (src, trg), (_, zero) = case["batch8"]
    losses_ = steps(trainer, (src[:4], trg[:4]), (trg[:4], zero[:4]))
    return dict(params=state(model), losses=losses_)


def template(case):
    """TemplateCreation (MeanStream folding in the global batch, its cap
    that of one batch, so that its loss weighs): two steps at batch 4,
    buffers included."""
    model = TemplateCreation(SHAPE, nb_unet_features=FEATS, int_steps=1, mean_cap=4,
                             generator=torch.Generator().manual_seed(0))
    model.set_atlas(case["atlas"])
    trainer = Trainer(model, template_terms("mse", 0.5, 1.0, 0.01), lr=LR, device="cpu")
    scans = case["batch8"][0][0][:4]
    zero = np.zeros((4, *SHAPE, 3), np.float32)
    losses_ = steps(trainer, (scans,), (scans, zero, zero, zero))
    return dict(params=state(model), losses=losses_)


def cached_pairs(case):
    """Trainer.fit_cached_pairs: one 3-step dispatch at batch 2."""
    model = vxm(case, 1)
    trainer = Trainer(model, dp_terms(), lr=LR, device="cpu")
    metrics = trainer.fit_cached_pairs(case["stack"], epochs=1, steps_per_epoch=3,
                                       batch_size=2, log_fn=lambda msg: None)
    return dict(params=state(model), metrics=metrics)


def cached_labels(case):
    """Trainer.fit_cached_labels of a narrow SynthMorphDense (the synthesis
    drawn at the global batch's shape): one 2-step dispatch at batch 2."""
    cfg = synthmorph.LabelsToImageConfig(SHAPE, [0, 1, 2, 3], warp_std=2.0, warp_res=[4])
    model = synthmorph.SynthMorphDense(cfg, nb_unet_features=FEATS, int_steps=1,
                                       shared_contrast=0.5,
                                       generator=torch.Generator().manual_seed(0))
    terms = [LossTerm("pred_map", lambda t, p: losses.Dice().loss(t, p) + 1.0,
                      target_output_key="map_2", name="dice"),
             LossTerm("pos_flow", losses.Grad("l2").loss, weight=1.0, target_index=1,
                      name="grad")]
    trainer = Trainer(model, terms, lr=LR, device="cpu")
    metrics = trainer.fit_cached_labels(case["labels"], epochs=1, steps_per_epoch=2,
                                        batch_size=2, log_fn=lambda msg: None)
    return dict(params=state(model), metrics=metrics)


def idle(case):
    """Batch 3: the JAX mesh's warning about idle devices, and two steps."""
    model = vxm(case, 1)
    trainer = Trainer(model, dp_terms(), lr=LR, device="cpu")
    (src, trg), (_, zero) = case["batch8"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses_ = steps(trainer, (src[:3], trg[:3]), (trg[:3], zero[:3]))
    return dict(params=state(model), losses=losses_,
                warnings=[str(w.message) for w in caught if "make_mesh_for_batch" in
                          str(w.message)])


def checkpoints(case, tmp):
    """One step at batch 8 saved in the background (the files each rank
    wrote counted), then the case's JAX checkpoint resumed for two steps."""
    written = []
    save_model = modelio.save_model

    def counting(path, *args, **kwargs):
        written.append(os.path.basename(path))
        return save_model(path, *args, **kwargs)

    modelio.save_model = counting
    try:
        model = vxm(case, 1)
        trainer = Trainer(model, dp_terms(), lr=LR, device="cpu")
        steps(trainer, *case["batch8"], n=1)
        path = os.path.join(tmp, f"port_{mesh_lib.world()[1]}.npz")
        trainer.save(path, wait=False)
        trainer.wait_for_saves()
        saved = state(model)
    finally:
        modelio.save_model = save_model
    resumed = Trainer(vxm(case, 1), dp_terms(), lr=LR, device="cpu")
    init_or_resume(resumed, case["jax_checkpoint"], tmp, sample_inputs=case["batch8"][0])
    losses_ = steps(resumed, *case["batch8"])
    return dict(written=written, path=path, saved=saved, params=state(resumed.model),
                losses=losses_, step=resumed.global_step)


def serving(case):
    """build_register_fn on this rank's rows of a batch of 4, gathered."""
    model = vxm(case, 1).eval()
    mesh = mesh_lib.make_mesh_for_batch(4)
    (src, trg), _ = case["batch8"]
    src_r, trg_r = mesh_lib.shard_batch(mesh, (src[:4], trg[:4]), device="cpu")
    moved, warp = mesh_lib.gather_batch(mesh, build_register_fn(model)(src_r, trg_r))
    return dict(rows=int(src_r.shape[0]), moved=moved.numpy(), warp=warp.numpy())


def space_axis(case):
    """A mesh whose 'space' axis takes every rank, and --spatial-shard at
    batch 1 (the rank left over goes to 'space'), each one step of a
    VxmDense on slabs of the first spatial dim; --spatial-shard at a batch
    that leaves no rank over is data-parallel; a model without the slab
    protocol (a user's module) raises."""
    out = {}
    world = mesh_lib.world()[1]
    (src, trg), (_, zero) = case["batch8"]
    one = ((src[:1], trg[:1]), (trg[:1], zero[:1]))
    trainer = Trainer(vxm(case, 1), dp_terms(), lr=LR, device="cpu",
                      mesh=mesh_lib.make_mesh(shape=(1, world)))
    out["mesh_losses"] = steps(trainer, *one, n=1)
    out["mesh_params"] = state(trainer.model)
    trainer = Trainer(vxm(case, 1), dp_terms(), lr=LR, device="cpu", spatial_shard=True)
    out["spatial_shard"] = steps(trainer, *one, n=1)
    out["spatial_shard_params"] = state(trainer.model)
    out["spatial_shard_mesh_1"] = dict(trainer.mesh.shape)
    trainer = Trainer(vxm(case, 1), dp_terms(), lr=LR, device="cpu", spatial_shard=True)
    out["spatial_shard_dp"] = steps(trainer, (src[:world], trg[:world]),
                                    (trg[:world], zero[:world]), n=1)
    out["spatial_shard_mesh"] = dict(trainer.mesh.shape)
    try:
        Trainer(_UsersModule(), [], device="cpu", mesh=mesh_lib.make_mesh(shape=(1, world)))
    except NotImplementedError as e:
        out["refused"] = str(e)
    return out


class _UsersModule(torch.nn.Module):
    """A model of the user's own, with no slab protocol."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(2, 3, 3, padding=1)


def run(case, tmp):
    """Every scenario, in one order on every rank."""
    return {"dp0": dp(case, 0), "dp1": dp(case, 1), "probs": probs(case),
            "template": template(case), "cached_pairs": cached_pairs(case),
            "cached_labels": cached_labels(case), "idle": idle(case),
            "checkpoints": checkpoints(case, tmp), "serving": serving(case),
            "space_axis": space_axis(case)}


def main(rank, world, store, tmp):
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed("file://" + store, world, rank, "cpu")
    with open(os.path.join(tmp, "case.pkl"), "rb") as f:
        case = pickle.load(f)
    out = run(case, tmp)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
