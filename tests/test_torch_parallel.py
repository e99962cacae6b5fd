"""The port's data parallelism (``voxelmorph_tpu_torch.parallel``, the
Trainer over a process group) against the JAX package's mesh on the CPU.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``).
The port runs every scenario of ``tests/torch_parallel_ranks.py`` twice:
in this process (a world of one rank) and in a gloo world of two processes
started once for the module. The mesh arithmetic and its warning are held
to JAX's exactly. A step at world size 2 is held to JAX's 8-device Trainer
and to the port at world size 1 within JAX's own DP-vs-single tolerance
(``tests/test_sharding.py::test_dp_matches_single_device``: rtol 1e-4, atol
1e-6 on the params after the steps, rtol 1e-5 on the loss); so are the
sampling draws (``use_probs``, SynthMorph's synthesis), MeanStream's
buffers, the cached-pair and cached-label dispatches, a batch that leaves a
rank idle and a resumed JAX checkpoint. Every comparison also asserts that
the steps moved the params by at least ten times the tolerance.
"""

import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_parity import flatten, unflatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.parallel import mesh as jax_mesh
from voxelmorph_tpu.training import LossTerm as JaxLossTerm
from voxelmorph_tpu.training import Trainer as JaxTrainer
from voxelmorph_tpu_torch import parallel
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib
from voxelmorph_tpu_torch.training import Trainer

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
RTOL, ATOL = 1e-4, 1e-6  # JAX's DP-vs-single bound on the params
LOSS_RTOL = 1e-5
SHAPE = ranks.SHAPE


def _case(tmp):
    rng = np.random.default_rng(8)
    src = rng.normal(size=(8, *SHAPE, 1)).astype(np.float32)
    trg = rng.normal(size=(8, *SHAPE, 1)).astype(np.float32)
    zero = np.zeros((8, *SHAPE, 3), np.float32)
    params = {}
    for k, cfg in ranks.CONFIGS.items():
        p = jax.device_get(JaxVxmDense(inshape=SHAPE, nb_unet_features=ranks.FEATS, **cfg).init(
            jax.random.PRNGKey(k), src[:1], trg[:1])["params"])
        flat = flatten(p)
        # flows of voxels, not the init's ~1e-5
        flat["flow||kernel"] = np.random.default_rng(3 + k).normal(
            0.0, 0.1, flat["flow||kernel"].shape).astype(np.float32)
        params[k] = flat
    case = dict(params=params, batch8=((src, trg), (trg, zero)),
                atlas=rng.normal(size=(1, *SHAPE, 1)).astype(np.float32),
                stack=rng.normal(size=(4, *SHAPE, 1)).astype(np.float32),
                labels=[rng.integers(0, 4, size=SHAPE).astype(np.int32) for _ in range(4)])
    # a JAX checkpoint one step in (Adam's state included), to resume
    jt = _jax_trainer(1)
    jt.init(case["batch8"][0], params=_jax_params(params[1]))
    jt.train_step(*case["batch8"])
    case["jax_checkpoint"] = str(tmp / "jax_start.npz")
    jt.save(case["jax_checkpoint"])
    return case


def _jax_params(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten(flat))


def _jax_trainer(int_steps, mesh=None):
    terms = [JaxLossTerm("y_source", jax_losses.MSE().loss, weight=1.0, target_index=0),
             JaxLossTerm("reg", jax_losses.Grad("l2").loss, weight=0.01, target_index=1,
                         name="grad")]
    model = JaxVxmDense(inshape=SHAPE, nb_unet_features=ranks.FEATS, **ranks.CONFIGS[int_steps])
    return JaxTrainer(model, terms, lr=ranks.LR, mesh=mesh)


def _jax_state(trainer):
    """A JAX Trainer's params by the port's state-dict names."""
    return {k: v.numpy() for k, v in modelio.params_from_jax(
        flatten(jax.device_get(trainer.params))).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario at world size 1 (here) and 2 (two gloo processes):
    ``{1: results, 2: rank 0's results, "rank1": rank 1's}``."""
    tmp = tmp_path_factory.mktemp("parallel")
    case = _case(tmp)
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(Path(ranks.__file__)), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    one = ranks.run(case, str(tmp))  # meanwhile, world size 1 here
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    out = {1: one, "case": case}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out[2 if r == 0 else f"rank{r}"] = pickle.load(f)
    return out


def _assert_params(actual, expected, start=None, label=""):
    """Each tensor of ``actual`` within RTOL/ATOL of ``expected``; with
    ``start``, the run must have moved some param by 10 x ATOL."""
    assert sorted(actual) == sorted(expected), label
    for k in expected:
        np.testing.assert_allclose(actual[k], expected[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}: {k}")
    if start is not None:
        moved = max(np.abs(expected[k] - start[k]).max() for k in start)
        assert moved >= 10 * ATOL, f"{label}: the steps moved the params by {moved}"


def _start(case, int_steps=1):
    return {k: v.numpy() for k, v in modelio.params_from_jax(case["params"][int_steps]).items()}


MESH_CASES = [(8, None), (1, None), (2, 8), (2, 7), (3, None), (4, 16), (6, 9)]


@pytest.mark.parametrize("batch,spatial", MESH_CASES)
def test_mesh_for_batch_matches_jax(batch, spatial):
    """make_mesh_for_batch over 8 ranks: JAX's shape on its 8 devices, and
    its warning word for word, or its silence."""
    caught = {}
    for name, build in (("jax", lambda: jax_mesh.make_mesh_for_batch(batch, spatial)),
                        ("port", lambda: mesh_lib.make_mesh_for_batch(batch, spatial,
                                                                      devices=range(8)))):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            mesh = build()
        caught[name] = (dict(mesh.shape), [str(w.message) for w in seen])
    assert caught["port"] == caught["jax"]
    assert tuple(caught["port"][0]) == ("data", "space")


@pytest.mark.parametrize("shape", [None, (2, 4), (4, 2), (1, 8)])
def test_make_mesh_matches_jax(shape):
    ours = mesh_lib.make_mesh(shape, devices=range(8))
    ref = jax_mesh.make_mesh(shape)
    assert dict(ours.shape) == dict(ref.shape) and ours.axis_names == tuple(ref.axis_names)
    assert ours.devices.shape == ref.devices.shape and ours.size == 8
    # no process group here: a world of rank 0
    assert dict(mesh_lib.make_mesh().shape) == {"data": 1, "space": 1}
    assert parallel.mesh is mesh_lib and set(mesh_lib.__all__) == set(jax_mesh.__all__) | {
        "gather_batch"}


def test_shard_batch_rows_and_replicated():
    """The rows of each data slice; an idle rank holds slice rank % data;
    a replicated spec holds everything; one process is unchanged."""
    mesh = mesh_lib.make_mesh_for_batch(8, devices=range(4))
    sh = mesh_lib.batch_sharding(mesh, 5)
    assert sh.spec == ("data", None, None, None, None)
    assert [sh.rows(8, rank=r) for r in range(4)] == [slice(2 * r, 2 * r + 2) for r in range(4)]
    with pytest.warns(UserWarning, match="using 2 of 4 devices"):
        idle = mesh_lib.make_mesh_for_batch(6, devices=range(4))
    assert [mesh_lib.batch_sharding(idle, 2).rows(6, rank=r) for r in range(4)] == [
        slice(0, 3), slice(3, 6), slice(0, 3), slice(3, 6)]
    assert mesh_lib.replicated(mesh).rows(8) == slice(None)
    x = np.arange(8 * 3, dtype=np.float64).reshape(8, 3)
    got = mesh_lib.shard_batch(mesh_lib.make_mesh(), {"a": [x]}, device="cpu")["a"][0]
    assert got.dtype == torch.float32 and torch.equal(got, torch.as_tensor(x, dtype=torch.float32))
    t = torch.ones(4, 2)
    assert mesh_lib.gather_batch(mesh_lib.make_mesh(), (t,))[0] is t
    assert mesh_lib.replicate(mesh_lib.make_mesh(), [t])[0] is t


@pytest.mark.parametrize("int_steps", [0, 1])
def test_dp_step_matches_jax_mesh_and_one_rank(runs, int_steps):
    """Two steps at batch 8 over two ranks: JAX's Trainer on
    make_mesh_for_batch(8) (8-way on its devices), and the port's one rank."""
    two, one = runs[2][f"dp{int_steps}"], runs[1][f"dp{int_steps}"]
    assert two["data"] == 2 and one["data"] == 1
    jt = _jax_trainer(int_steps)
    jt.init(runs["case"]["batch8"][0], params=_jax_params(runs["case"]["params"][int_steps]))
    assert jt.mesh.shape["data"] == 8
    jax_losses_ = [float(jt.train_step(*runs["case"]["batch8"])["loss"]) for _ in range(2)]
    start = _start(runs["case"], int_steps)
    _assert_params(two["params"], _jax_state(jt), start, "two ranks vs JAX's mesh")
    _assert_params(two["params"], one["params"], start, "two ranks vs one")
    np.testing.assert_allclose(two["losses"], jax_losses_, rtol=LOSS_RTOL)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=LOSS_RTOL)
    # rank 1 ends with rank 0's params
    _assert_params(runs["rank1"][f"dp{int_steps}"]["params"], two["params"])


@pytest.mark.parametrize("scenario", ["probs", "template", "idle"])
def test_scenario_matches_one_rank(runs, scenario):
    """use_probs (the noise drawn at the global shape and sharded),
    TemplateCreation (MeanStream's buffers fold in the global batch) and
    batch 3 (the idle rank repeats a data slice): two ranks give the
    params, buffers and losses of one."""
    two, one = runs[2][scenario], runs[1][scenario]
    _assert_params(two["params"], one["params"], label=scenario)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=LOSS_RTOL)


def test_scenarios_moved(runs):
    """Each scenario's steps changed what they train: the weights of each
    run differ from those of a fresh model by 10 x ATOL, and the template's
    MeanStream counted the global batch twice."""
    fresh = {"probs": VxmDense(SHAPE, nb_unet_features=ranks.FEATS, int_steps=1, use_probs=True,
                               generator=torch.Generator().manual_seed(0)).state_dict()}
    for name, ref in fresh.items():
        got = runs[2][name]["params"]
        assert max(np.abs(got[k] - v.numpy()).max() for k, v in ref.items()) >= 10 * ATOL
    for name in ("idle", "cached_pairs"):
        got = runs[2][name]["params"]
        start = _start(runs["case"])
        assert max(np.abs(got[k] - start[k]).max() for k in start) >= 10 * ATOL
    stream = runs[2]["template"]["params"]
    assert float(stream["mean_stream.count"]) == 4.0  # a global batch of 4, capped at 4
    assert np.abs(stream["mean_stream.mean"]).max() >= 10 * ATOL


def test_idle_rank_warns_as_jax(runs):
    """Batch 3 over two ranks: JAX's warning over its devices (1 of 2 used),
    on both ranks, and the one-rank run warns of nothing."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        jax_mesh.make_mesh_for_batch(3, devices=jax.devices()[:2])
    expected = [str(w.message) for w in seen]
    assert expected and "using 1 of 2 devices" in expected[0]
    assert runs[2]["idle"]["warnings"] == runs["rank1"]["idle"]["warnings"] == expected
    assert runs[1]["idle"]["warnings"] == []


@pytest.mark.parametrize("scenario", ["cached_pairs", "cached_labels"])
def test_cached_dispatch_matches_one_rank(runs, scenario):
    """fit_cached_pairs and fit_cached_labels (SynthMorph's synthesis drawn
    at the global batch's shape) over two ranks: the params and the
    dispatch's metrics of one rank."""
    two, one = runs[2][scenario], runs[1][scenario]
    _assert_params(two["params"], one["params"], label=scenario)
    assert sorted(two["metrics"]) == sorted(one["metrics"])
    for k in one["metrics"]:
        np.testing.assert_allclose(two["metrics"][k], one["metrics"][k], rtol=LOSS_RTOL)
    assert np.isfinite(list(two["metrics"].values())).all()


def test_checkpoint_written_by_rank0_reads_in_jax(runs):
    """Rank 0 alone writes; JAX's Trainer.load reads its params and Adam's
    state, equal to what the port saved."""
    two = runs[2]["checkpoints"]
    assert two["written"] == ["port_2.npz"] and runs["rank1"]["checkpoints"]["written"] == []
    jt = _jax_trainer(1)
    jt.load(two["path"], sample_inputs=runs["case"]["batch8"][0])
    assert jt.global_step == 1
    saved = {k: v for k, v in two["saved"].items()}
    for k, v in _jax_state(jt).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    mu = jax.tree_util.tree_leaves(jax.device_get(jt.opt_state))
    assert any(np.abs(np.asarray(leaf)).max() > 0 for leaf in mu[1:])


def test_jax_checkpoint_resumes_over_two_ranks(runs):
    """The JAX checkpoint (one step in) resumed for two steps: two ranks
    against JAX's Trainer resumed on its mesh and against one rank."""
    two, one = runs[2]["checkpoints"], runs[1]["checkpoints"]
    assert two["step"] == one["step"] == 3
    jt = _jax_trainer(1)
    jt.load(runs["case"]["jax_checkpoint"], sample_inputs=runs["case"]["batch8"][0])
    start = _jax_state(jt)
    jax_losses_ = [float(jt.train_step(*runs["case"]["batch8"])["loss"]) for _ in range(2)]
    _assert_params(two["params"], _jax_state(jt), start, "resumed: two ranks vs JAX")
    _assert_params(two["params"], one["params"], start, "resumed: two ranks vs one")
    np.testing.assert_allclose(two["losses"], jax_losses_, rtol=LOSS_RTOL)


def test_sharded_serving_gathers_one_process(runs):
    """build_register_fn on each rank's 2 rows of a batch of 4, gathered:
    the moved images and warps of one process at batch 4."""
    two, one = runs[2]["serving"], runs[1]["serving"]
    assert two["rows"] == 2 and one["rows"] == 4
    for key in ("moved", "warp"):
        assert two[key].shape == one[key].shape == (4, *SHAPE, 1 if key == "moved" else 3)
        np.testing.assert_allclose(two[key], one[key], rtol=0,
                                   atol=1e-6 * np.abs(one[key]).max(), err_msg=key)
        np.testing.assert_array_equal(runs["rank1"]["serving"][key], two[key])
    assert np.abs(one["warp"]).max() > 0.1  # voxels


def test_space_axis_refused(runs):
    """The 'space' axis is refused only to models without the slab
    protocol: over two ranks a (1, 2) mesh, and --spatial-shard at batch 1,
    train a VxmDense on slabs as one rank trains it whole; where the batch
    leaves no rank over, --spatial-shard trains data-parallel, as in JAX; a
    user's module on a (1, 2) mesh raises, naming itself."""
    got, one = runs[2]["space_axis"], runs[1]["space_axis"]
    assert got["spatial_shard_mesh_1"] == {"data": 1, "space": 2}
    assert one["spatial_shard_mesh_1"] == {"data": 1, "space": 1}
    start = _start(runs["case"])
    for key in ("mesh", "spatial_shard"):
        _assert_params(got[f"{key}_params"], one["spatial_shard_params"], start, key)
    np.testing.assert_allclose(got["mesh_losses"], one["spatial_shard"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["spatial_shard"], one["spatial_shard"], rtol=LOSS_RTOL)
    assert got["spatial_shard_mesh"] == {"data": 2, "space": 1}
    assert np.isfinite(got["spatial_shard_dp"]).all()
    assert "of _UsersModule is not ported" in got["refused"]
    assert "refused" not in one  # a mesh of one rank shards nothing
    # in one process: a grid of two ranks that the world lacks, and the spec
    mesh = mesh_lib.make_mesh(shape=(1, 2), devices=[0, 1])
    with pytest.raises(ValueError, match="holds every rank of the world"):
        Trainer(VxmDense(SHAPE, nb_unet_features=ranks.FEATS), ranks.dp_terms(),
                device="cpu", mesh=mesh)
    assert mesh_lib.batch_sharding(mesh, 5, spatial=True).spec == (
        "data", "space", None, None, None)
    assert mesh_lib.batch_sharding(mesh, 5).spec[0] == "data"
