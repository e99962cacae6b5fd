"""What ``tests/test_torch_spatial_models.py`` and
``tests/test_torch_spatial_models_atlas.py`` share: the case of a group of
``tests/torch_spatial_models_ranks.py``'s scenarios, its run in one process
and on four gloo ranks, JAX's spatially sharded Trainer, and the
tolerances.

The JAX package runs ``Trainer(spatial_shard=True)`` on
``make_mesh(shape, devices=jax.devices()[:4])`` of its 8 virtual CPU
devices (``tests/conftest.py``), from the case's params; SynthMorph's
synthesis draws come from its keys (``fold_in(PRNGKey(0), step)``, split
for the 'synth' stream and then for the two images), replayed for the port
(``synth_parity.jax_draws``). The tolerances are VxmDense's
(``tests/test_torch_spatial.py``, JAX's own sharded-vs-single bounds in
``tests/test_sharding.py``): the loss within rtol 2e-5; the params after two
steps within rtol 1e-4, atol 1e-6, the steps moving them by ten times that;
a forward's outputs within 1e-5 of their largest magnitude. A parameter
used whole on every rank (``whole_parameters``) must have the reduced
gradient of one process within GRAD_RTOL of its largest entry, where a sum
over 'space' would make it four times that.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_spatial_models_ranks as ranks
from synth_parity import jax_draws, label_maps
from torch_parity import flatten, unflatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import models as jax_models
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import synthmorph as jax_synth
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu.parallel import mesh as jax_mesh
from voxelmorph_tpu.training import LossTerm as JaxLossTerm
from voxelmorph_tpu.training import Trainer as JaxTrainer
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
RTOL, ATOL = 1e-4, 1e-6
LOSS_RTOL = 2e-5
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
SHAPE = ranks.SHAPE
FLOW_STD = 0.1  # the flow head's redraw: flows of about a voxel


def _smooth(rng, batch, channels=1, shape=SHAPE):
    """Smooth images in [0, 1]: a blob and noise, blurred by a box of 3."""
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij"), -1)
    out = []
    for _ in range(batch):
        c = np.asarray(shape) / 2 + rng.uniform(-2, 2, size=len(shape))
        blob = np.exp(-((g - c) ** 2).sum(-1) / 18)[..., None]
        noise = rng.uniform(size=(*shape, channels))
        for axis in range(len(shape)):
            noise = (np.roll(noise, 1, axis) + noise + np.roll(noise, -1, axis)) / 3
        out.append(0.7 * blob + 0.3 * noise)
    return np.stack(out).astype(np.float32)


def _one_hot(rng, batch, shape):
    labels = rng.integers(0, ranks.LABELS, size=(batch, *shape))
    return np.eye(ranks.LABELS, dtype=np.float32)[labels]


def _batch(name, rng):
    """The global batch of two of model ``name``: (inputs, targets)."""
    zero = np.zeros((2, *SHAPE, 3), np.float32)
    src, trg = _smooth(rng, 2), _smooth(rng, 2)
    if name == "semi_seg":
        half = tuple(s // 2 for s in SHAPE)
        segs = _one_hot(rng, 2, half), _one_hot(rng, 2, half)
        return (src, trg, *segs), (trg, zero, segs[1], segs[0])
    if name == "pointcloud":
        dts = [rng.normal(size=(2, *SHAPE, 2)).astype(np.float32) * 3 for _ in range(2)]
        pts = []
        for _ in range(2):
            p = rng.uniform(1, np.asarray([*SHAPE, 3]) - 2,
                            size=(2, ranks.POINTS, 4)).astype(np.float32)
            p[..., -1] = rng.integers(0, 2, ranks.POINTS)
            pts.append(p)
        void = np.zeros((2, ranks.POINTS, 1), np.float32)
        return (src, trg, *dts, *pts), (trg, src, zero, void, void)
    if name == "synthmorph":
        maps = [label_maps(seed, 2, SHAPE, ranks.SYNTH_LABELS).astype(np.float32)
                for seed in (1, 2)]
        return tuple(maps), (zero,)
    if name == "hyper":
        return (src, trg, np.asarray([[0.3], [0.7]], np.float32)), (trg, zero)
    if name == "template":
        return (src,), (src, zero, zero, zero)
    if name == "cond_template":
        pheno = rng.normal(size=(2, 2)).astype(np.float32)
        return (pheno, trg, src), (src, zero, zero)
    if name == "instance":
        return (src,), (trg, zero)
    if name.startswith("prob_atlas"):
        image = src.copy()
        image[:, :, :2] = 0  # a background that the loss's mask leaves out
        logits = rng.normal(size=(2, *SHAPE, ranks.LABELS)) * 2
        atlas = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        return (image, atlas.astype(np.float32)), (atlas.astype(np.float32), zero)
    if name == "joint":
        return (np.asarray([[0.3], [0.7]], np.float32), src, trg), (trg, zero)
    raise KeyError(name)


def make_case(group):
    """The params (the port's seeded init in the JAX layout, every flow
    head redrawn N(0, FLOW_STD), a smooth template atlas, an instance flow
    of about a voxel), batches and SynthMorph draws of ``group``."""
    names = sorted({s[1] for s in ranks.GROUPS[group] + ranks.SERVE[group]})
    rng = np.random.default_rng(19)
    case = dict(params={}, state={}, batch={}, draws=None, eval_draws=None)
    for k, name in enumerate(names):
        net = ranks.build(name, torch.Generator().manual_seed(k))
        flat = modelio.params_to_jax(dict(net.named_parameters()))
        for key in sorted(flat):
            if key.endswith("flow||kernel") and not key.startswith("def_"):
                flat[key] = rng.normal(0.0, FLOW_STD, flat[key].shape).astype(np.float32)
        if name == "template":
            flat["atlas"] = _smooth(rng, 1)
        if name == "instance":
            flat["flow"] = rng.normal(0.0, 1e-3, flat["flow"].shape).astype(np.float32)
        case["params"][name] = flat
        case["batch"][name] = _batch(name, rng)
    if "synthmorph" in names:
        case["draws"], case["eval_draws"] = _synth_draws(case)
    return case


def _synth_draws(case):
    """SynthMorph's draws in the port's format: those of each of JAX's
    Trainer steps (its two labels_to_image keys, recorded from the step's
    loss run eagerly: the keys depend on the step alone), and of the eval
    forward (PRNGKey(0), split for the two images). JAX splits a key per
    sample of the batch: the scenarios' batch of 1."""
    cfg = ranks.synth_config(jax_synth)
    inputs, targets = (tuple(a[:1] for a in part) for part in case["batch"]["synthmorph"])
    loss_fn = jax_training.make_loss_fn(
        jax_model("synthmorph"), ranks.terms("synthmorph", jax_losses, JaxLossTerm),
        rng_names=["synth"])
    keys, original = [], jax_synth.labels_to_image

    def record(key, *args, **kwargs):
        keys.append(np.asarray(key))
        return original(key, *args, **kwargs)

    jax_synth.labels_to_image = record
    try:
        for step in range(ranks.STEPS):
            loss_fn(unflatten(case["params"]["synthmorph"]), {}, inputs, targets,
                    jax.random.fold_in(jax.random.PRNGKey(0), step))
    finally:
        jax_synth.labels_to_image = original
    steps = [{"share": None, "src": jax_draws(keys[2 * i], cfg, 1),
              "trg": jax_draws(keys[2 * i + 1], cfg, 1)} for i in range(ranks.STEPS)]
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    return steps, {"share": None, "src": jax_draws(k1, cfg, 1), "trg": jax_draws(k2, cfg, 1)}


def launch(group, tmp):
    """Every scenario of ``group`` in one process (here) and on four gloo
    ranks: ``{1: results, 4: rank 0's, "ranks": every rank's, "case":
    case}``."""
    case = make_case(group)
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(Path(ranks.__file__)), group, str(r),
                               str(WORLD), str(tmp / "store"), str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        one = ranks.run(case, group)  # meanwhile, one process here
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    every = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            every.append(pickle.load(f))
    return {1: one, 4: every[0], "ranks": every, "case": case}


def jax_model(name):
    cls_name, fields = ranks.MODELS[name]
    if name == "synthmorph":
        fields = dict(fields, cfg=ranks.synth_config(jax_synth))
    return getattr(jax_models, cls_name)(**fields)


def jax_train(case, name, mesh_shape, batch):
    """JAX's spatially sharded Trainer on ``mesh_shape`` of 4 devices from
    the case's params and zero stream state: STEPS steps; the losses, the
    params by the port's names and the state."""
    trainer = JaxTrainer(jax_model(name), ranks.terms(name, jax_losses, JaxLossTerm),
                         lr=ranks.lr(name), spatial_shard=True,
                         rng_names=["synth"] if name == "synthmorph" else (),
                         mesh=jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:4]))
    inputs, targets = (tuple(a[:batch] for a in part) for part in case["batch"][name])
    try:
        trainer.init(inputs, params=jax.tree_util.tree_map(
            jnp.asarray, unflatten(case["params"][name])))
        assert dict(trainer.mesh.shape) == dict(zip(("data", "space"), mesh_shape))
        state = modelio.state_to_jax(ranks.build(name))
        if state:
            trainer.state = jax_mesh.replicate(trainer.mesh, jax.tree_util.tree_map(
                jnp.asarray, unflatten(state)))
        losses_ = [float(trainer.train_step(inputs, targets)["loss"])
                   for _ in range(ranks.STEPS)]
    finally:
        jax_warp.set_pallas_dispatch(True)  # the Trainer's guard turned it off
    params = {k: v.numpy() for k, v in modelio.params_from_jax(
        flatten(jax.device_get(trainer.params))).items()}
    return losses_, params, flatten(jax.device_get(trainer.state))


def jax_grads(case, name, mesh_shape, batch):
    """The loss and gradients of JAX's first spatially sharded step: its
    loss function's value_and_grad, jitted on ``mesh_shape`` of 4 devices
    with the params replicated and the arrays sharded as its Trainer puts
    them (the gradient that the Trainer's step hands to Adam)."""
    model = jax_model(name)
    loss_fn = jax_training.make_loss_fn(model, ranks.terms(name, jax_losses, JaxLossTerm))
    mesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:4])
    inputs, targets = (tuple(a[:batch] for a in part) for part in case["batch"][name])
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(case["params"][name]))
    jax_warp.set_pallas_dispatch(False)  # as the Trainer's guard does on a 'space' axis
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax_mesh.replicate(mesh, params), {}, jax_mesh.shard_batch(mesh, inputs, True),
            jax_mesh.shard_batch(mesh, targets, True), jax.random.PRNGKey(0))
    finally:
        jax_warp.set_pallas_dispatch(True)
    return float(loss), {k: v.numpy() for k, v in modelio.params_from_jax(
        flatten(jax.device_get(grads))).items()}


def start(case, name):
    return {k: v.numpy() for k, v in modelio.params_from_jax(case["params"][name]).items()}


def assert_params(actual, expected, begin=None, label=""):
    """Each parameter of ``expected`` within RTOL/ATOL in ``actual`` (the
    port's state, buffers too); with ``begin``, the run must have moved some
    param by 10 x ATOL."""
    assert set(expected) <= set(actual), label
    for k in expected:
        np.testing.assert_allclose(actual[k], expected[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}: {k}")
    if begin is not None:
        moved = max(np.abs(expected[k] - begin[k]).max() for k in begin)
        assert moved >= 10 * ATOL, f"{label}: the steps moved the params by {moved}"


def hold_serving(runs, group, train_kwarg=True):
    """Each sharded eval forward of ``group``, gathered, against JAX's
    forward on arrays sharded over its mesh and against one process; every
    rank's alike; the slab length of the first input where the model takes
    slabs."""
    case = runs["case"]
    for scenario, name, mesh_shape, batch, key in ranks.SERVE[group]:
        got, one = runs[4][scenario], runs[1][scenario]
        inputs = tuple(a[:batch] for a in case["batch"][name][0])
        mesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:4])
        model = jax_model(name)
        params = jax.tree_util.tree_map(jnp.asarray, unflatten(case["params"][name]))
        kwargs = {"train": False} if train_kwarg else {}
        try:
            ref = jax.jit(lambda p, *x: model.apply({"params": p}, *x, **kwargs)[key])(
                jax_mesh.replicate(mesh, params), *jax_mesh.shard_batch(mesh, inputs,
                                                                        spatial=True))
        finally:
            jax_warp.set_pallas_dispatch(True)
        assert_out(got["out"], np.asarray(ref), f"{scenario} vs JAX")
        assert_out(got["out"], one["out"], f"{scenario} vs one process")
        net = ranks.build(name)
        assert got["slab"] == (mesh_lib.slab_bounds(net.slab_depth, mesh_shape[1],
                                                    net.slab_align)[0][1]
                               if net.slab_inputs else None)
        for out in runs["ranks"][1:]:
            np.testing.assert_array_equal(out[scenario]["out"], got["out"])


def assert_out(actual, expected, label):
    scale = np.abs(expected).max()
    assert actual.shape == expected.shape and scale > 0, label
    np.testing.assert_allclose(actual, expected, rtol=0, atol=OUT_RTOL * scale, err_msg=label)


def hold(runs, scenario, name, mesh_shape, batch, jax_reference="trainer"):
    """The sharded run of ``scenario`` against JAX and against the port in
    one process: losses, params, the stream state where the model has one,
    and the eval forward's moved image. ``jax_reference`` "trainer" holds
    the losses, params and state to JAX's spatially sharded Trainer;
    "gradients" holds the first step's loss and gradients to JAX's sharded
    step's (``jax_grads``) and to one process's, and the losses, in place
    of the params and the moved image after the steps; None holds nothing
    to JAX."""
    got, one = runs[4][scenario], runs[1][scenario]
    assert got["mesh"] == dict(zip(("data", "space"), mesh_shape))
    begin = start(runs["case"], name)
    if jax_reference == "gradients":
        loss, grads = jax_grads(runs["case"], name, mesh_shape, batch)
        np.testing.assert_allclose(got["losses"][0], loss, rtol=LOSS_RTOL)
        assert sorted(grads) == sorted(got["grads"])
        for k, g in grads.items():
            gap = np.abs(got["grads"][k] - g).max()
            assert gap <= GRAD_RTOL * np.abs(g).max(), (k, gap, np.abs(g).max())
            gap = np.abs(got["grads"][k] - one["grads"][k]).max()
            assert gap <= GRAD_RTOL * np.abs(g).max(), (k, gap, np.abs(g).max())
        np.testing.assert_allclose(got["losses"], jax_train(runs["case"], name, mesh_shape,
                                                            batch)[0], rtol=LOSS_RTOL)
    elif jax_reference:
        jax_losses_, jax_params, jax_state = jax_train(runs["case"], name, mesh_shape, batch)
        assert_params(got["params"], jax_params, begin, f"{scenario}: four ranks vs JAX")
        np.testing.assert_allclose(got["losses"], jax_losses_, rtol=LOSS_RTOL)
        net = ranks.build(name)
        ours = modelio.state_to_jax(net, {k: torch.from_numpy(v)
                                          for k, v in got["params"].items()})
        assert sorted(ours) == sorted(jax_state)
        for key in ours:
            np.testing.assert_allclose(ours[key], jax_state[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    if jax_reference != "gradients":
        assert_params(got["params"], one["params"], begin, f"{scenario}: four ranks vs one")
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    if jax_reference != "gradients":
        assert_out(got["moved"], one["moved"], f"{scenario}: the moved image")


def assert_whole_gradients(runs, scenario, names):
    """The reduced gradient of each parameter ``names`` (the model's
    ``whole_parameters``) in the first sharded step equals one process's,
    not ``space`` times it."""
    got, one = runs[4][scenario]["grads"], runs[1][scenario]["grads"]
    assert names
    for n in names:
        scale = np.abs(one[n]).max()
        gap = np.abs(got[n] - one[n]).max()
        assert scale > 0 and gap <= GRAD_RTOL * scale, (n, gap, scale)
        ratio = np.abs(got[n]).max() / scale
        assert abs(ratio - 1) < 1e-3, (n, ratio)


def assert_ranks_alike(runs, scenario):
    """Every rank ends ``scenario`` with rank 0's params and buffers."""
    for r, out in enumerate(runs["ranks"][1:], 1):
        for k, v in runs[4][scenario]["params"].items():
            np.testing.assert_array_equal(out[scenario]["params"][k], v, err_msg=f"rank {r}: {k}")
