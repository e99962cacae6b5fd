"""The port's spatial sharding (the mesh's 'space' axis: a VxmDense's U-Net
on slabs of the first spatial dim, a halo exchanged around every conv)
against the JAX package's GSPMD mesh on the CPU.

The JAX package runs ``Trainer(spatial_shard=True)`` on
``make_mesh((d, s), devices=jax.devices()[:4])`` of its 8 virtual CPU
devices (``tests/conftest.py``). The port runs every scenario of
``tests/torch_spatial_ranks.py`` twice: in this process (one rank,
unsharded) and in a gloo world of four processes started once for the
module, at (24, 8, 8) with a two-pool U-Net, so that the slabs are uneven
(8/8/4/4 on (1, 4)). The sharded steps are held to JAX's and to the
unsharded port's within JAX's own tolerances (``tests/test_sharding.py``:
the loss within rtol 2e-5; the params after the steps within rtol 1e-4,
atol 1e-6, the steps moving them by ten times that). The flow head is
redrawn for flows of about a voxel, where the warps' gradients are smooth.
In this process, threads stand in for ranks (their all-reduce a sum behind
a barrier) to hold ``halo_exchange``, the conv blocks on slabs and
``gather_space``, with their gradients, to the whole volume's.
"""

import copy
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_ranks as ranks
from torch_parity import flatten, unflatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu.parallel import mesh as jax_mesh
from voxelmorph_tpu.training import LossTerm as JaxLossTerm
from voxelmorph_tpu.training import Trainer as JaxTrainer
from voxelmorph_tpu_torch import models
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.unet import ConvBlock
from voxelmorph_tpu_torch.ops import conv3
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib
from voxelmorph_tpu_torch.training import Trainer

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
RTOL, ATOL = 1e-4, 1e-6  # JAX's sharded-vs-single bound on the params
LOSS_RTOL = 2e-5  # tests/test_sharding.py's sharded-vs-single loss bound
# a forward's outputs, relative to their largest magnitude, as the port's
# forwards are held to JAX's (tests/test_torch_train.py): the slabs' convs
# sum in other orders than the whole volume's (measured: 2.0e-6 on y_source)
OUT_RTOL = 1e-5
SHAPE = ranks.SHAPE


def _case():
    rng = np.random.default_rng(18)
    params = {}
    for k, (name, cfg) in enumerate(ranks.CONFIGS.items()):
        x = np.zeros((1, *cfg["inshape"], 1), np.float32)
        flat = flatten(jax.device_get(JaxVxmDense(nb_unet_features=ranks.FEATS, **cfg).init(
            {"params": jax.random.PRNGKey(k), "sample": jax.random.PRNGKey(k)}, x, x)["params"]))
        # flows of about a voxel, not the init's ~1e-5; a sigma whose
        # draws move the flow
        flat["flow||kernel"] = np.random.default_rng(3 + k).normal(
            0.0, 0.1, flat["flow||kernel"].shape).astype(np.float32)
        if "log_sigma||bias" in flat:
            flat["log_sigma||bias"] = np.full_like(flat["log_sigma||bias"], -3.0)
        params[name] = flat
    src, trg = (rng.normal(size=(2, *SHAPE, 1)).astype(np.float32) for _ in range(2))
    zero = np.zeros((2, *SHAPE, 3), np.float32)
    serve_2d = tuple(rng.normal(size=(1, *ranks.SHAPE_2D, 1)).astype(np.float32)
                     for _ in range(2))
    return dict(params=params,
                batch={"mse": ((src, trg), (trg, zero)), "probs": ((src, trg), (trg, src, zero))},
                eps=rng.normal(size=(2, *SHAPE, 3)).astype(np.float32),
                stack=rng.normal(size=(4, *SHAPE, 1)).astype(np.float32),
                serve={"mse": (src, trg), "2d": serve_2d})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario in one process (here) and on four gloo ranks:
    ``{1: results, 4: rank 0's, "ranks": every rank's, "case": case}``."""
    tmp = tmp_path_factory.mktemp("spatial")
    case = _case()
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(Path(ranks.__file__)), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    one = ranks.run(case, str(tmp))  # meanwhile, one process here
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    every = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            every.append(pickle.load(f))
    return {1: one, 4: every[0], "ranks": every, "case": case}


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


def _start(case, name):
    return {k: v.numpy() for k, v in modelio.params_from_jax(case["params"][name]).items()}


def _jax_terms(name):
    if name == "mse":
        return [JaxLossTerm("y_source", jax_losses.MSE().loss, weight=1.0, target_index=0),
                JaxLossTerm("reg", jax_losses.Grad("l2").loss, weight=0.01, target_index=1,
                            name="grad")]
    return [JaxLossTerm("y_source", jax_losses.NCC().loss, weight=0.5, target_index=0),
            JaxLossTerm("y_target", jax_losses.NCC().loss, weight=0.5, target_index=1),
            JaxLossTerm("reg", jax_losses.KL(10.0, SHAPE).loss, weight=0.01, target_index=2,
                        name="kl")]


def _jax_steps(case, name, mesh_shape, batch):
    """JAX's spatially sharded Trainer on ``mesh_shape`` of 4 devices:
    ranks.STEPS steps; the losses and the params by the port's names."""
    cfg = ranks.CONFIGS[name]
    model = JaxVxmDense(nb_unet_features=ranks.FEATS, **cfg)
    trainer = JaxTrainer(model, _jax_terms(name), lr=ranks.LR, spatial_shard=True,
                         needs_sample_rng=cfg.get("use_probs", False),
                         mesh=jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:4]))
    inputs, targets = (tuple(a[:batch] for a in part) for part in case["batch"][name])
    try:
        trainer.init(inputs, params=jax.tree_util.tree_map(
            jnp.asarray, unflatten(case["params"][name])))
        assert dict(trainer.mesh.shape) == dict(zip(("data", "space"), mesh_shape))
        losses_ = [float(trainer.train_step(inputs, targets)["loss"])
                   for _ in range(ranks.STEPS)]
    finally:
        jax_warp.set_pallas_dispatch(True)  # the Trainer's guard turned it off
    params = {k: v.numpy() for k, v in modelio.params_from_jax(
        flatten(jax.device_get(trainer.params))).items()}
    return losses_, params


@pytest.mark.parametrize("scenario,mesh_shape,batch", [("mse", (1, 4), 1),
                                                       ("probs", (2, 2), 2)])
def test_sharded_step_matches_jax_and_one_process(runs, monkeypatch, scenario, mesh_shape,
                                                   batch):
    """(1, 4) at batch 1, MSE + Grad; (2, 2) at batch 2, NCC + KL + bidir
    with the same noise in both packages (each port rank draws it at the
    global batch's shape and keeps its rows): two steps against JAX's
    spatially sharded Trainer and the port in one process."""
    got, one = runs[4][scenario], runs[1][scenario]
    assert got["mesh"] == dict(zip(("data", "space"), mesh_shape))
    if scenario == "probs":
        eps = runs["case"]["eps"]
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                            jnp.asarray(eps[:shape[0]], dtype).reshape(shape))
    jax_losses_, jax_params = _jax_steps(runs["case"], scenario, mesh_shape, batch)
    start = _start(runs["case"], scenario)
    _assert_params(got["params"], jax_params, start, f"{scenario}: four ranks vs JAX")
    _assert_params(got["params"], one["params"], start, f"{scenario}: four ranks vs one")
    np.testing.assert_allclose(got["losses"], jax_losses_, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("scenario", ["mse", "probs", "probs_generator", "conv_kernel",
                                      "bfloat16", "cached_pairs"])
def test_ranks_end_bit_equal(runs, scenario):
    """Every rank ends each scenario with rank 0's params."""
    for r, out in enumerate(runs["ranks"][1:], 1):
        for k, v in runs[4][scenario]["params"].items():
            np.testing.assert_array_equal(out[scenario]["params"][k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("scenario", ["probs_generator", "conv_kernel"])
def test_sharded_step_matches_one_process(runs, scenario):
    """The Trainer's own generator, drawing at the global batch's shape on
    every rank ((2, 2)), and the conv-kernel mode ((1, 4), the kernel's
    plain version on the CPU; JAX's pallas_call has no GSPMD rule, so only
    the port in one process holds it): two steps against one process; the
    slabs' convolutions copy no input or cotangent to channels-last."""
    got, one = runs[4][scenario], runs[1][scenario]
    _assert_params(got["params"], one["params"], _start(runs["case"], "probs" if scenario ==
                                                        "probs_generator" else "mse"), scenario)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    if scenario == "conv_kernel":
        assert got["layout_copies"] == 0


# one bfloat16 step on four ranks against one process: each slab's edge
# planes sum their input gradient in two bfloat16 parts (the slab's own
# outputs' and the neighbour's, each rounded) where the whole volume rounds
# one sum, so the gradients differ by bfloat16 roundings. Each tensor's gap
# is held to a share of what bfloat16 itself costs, the gap between the
# unsharded bfloat16 and float32 steps' gradients; measured on the CPU: at
# most 0.090 of it (the largest gap, 1.6e-2 of a tensor's largest float32
# gradient, where bfloat16 costs that tensor 0.18).
BF16_GAP_SHARE = 0.25


def test_bfloat16_step_matches_one_process(runs):
    """One step of a bfloat16 model on (1, 4) against one process: the same
    loss, and gradients apart by a small share of bfloat16's own error."""
    got, one = runs[4]["bfloat16"], runs[1]["bfloat16"]
    f32 = ranks.train(runs["case"], "mse", ranks.mse_terms(), (1, 4), 1, steps=1)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    for k, g in f32["grads"].items():
        cost = np.abs(one["grads"][k] - g).max()
        gap = np.abs(got["grads"][k] - one["grads"][k]).max()
        assert 0 < cost and gap <= BF16_GAP_SHARE * cost, (k, gap, cost)


def test_cached_dispatch_matches_one_process(runs):
    """fit_cached_pairs on (1, 4): each step's pair sliced on the device
    into this rank's slabs; the params and the dispatch's metrics of one
    process (which JAX's dispatch, placing no batch on its mesh, computes)."""
    got, one = runs[4]["cached_pairs"], runs[1]["cached_pairs"]
    _assert_params(got["params"], one["params"], _start(runs["case"], "mse"), "cached_pairs")
    assert sorted(got["metrics"]) == sorted(one["metrics"])
    for k in one["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], one["metrics"][k], rtol=LOSS_RTOL)


@pytest.mark.parametrize("scenario,name,mesh_shape", [("serve_3d", "mse", (2, 2)),
                                                      ("serve_2d", "2d", (1, 4))])
def test_sharded_forward_matches_jax(runs, scenario, name, mesh_shape):
    """The eval-mode forward on slabs (tests/test_sharding.py's sharded
    forward): a 3-D batch of 2 on (2, 2) and a 2-D pair on (1, 4), gathered,
    against JAX's forward on the arrays sharded over its mesh, and against
    one process; build_register_fn gives the same moved image and warp."""
    got, one = runs[4][scenario], runs[1][scenario]
    src, trg = runs["case"]["serve"][name]
    cfg = ranks.CONFIGS[name]
    model = JaxVxmDense(nb_unet_features=ranks.FEATS, **cfg)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(runs["case"]["params"][name]))
    mesh = jax_mesh.make_mesh(mesh_shape, devices=jax.devices()[:4])
    out = jax.jit(lambda p, a, b: model.apply({"params": p}, a, b, train=False))(
        jax_mesh.replicate(mesh, params), jax_mesh.shard_batch(mesh, src, spatial=True),
        jax_mesh.shard_batch(mesh, trg, spatial=True))
    assert got["register_equal"]
    assert got["slab"] == (12 if mesh_shape == (2, 2) else 8)
    for key in ("y_source", "pos_flow"):
        ref = np.asarray(out[key])
        assert got[key].shape == ref.shape == one[key].shape
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[key], ref, rtol=0, atol=OUT_RTOL * scale, err_msg=key)
        np.testing.assert_allclose(got[key], one[key], rtol=0, atol=OUT_RTOL * scale,
                                   err_msg=key)
    assert np.abs(got["pos_flow"]).max() > 0.1  # voxels
    np.testing.assert_allclose(got["unet_out"], one["unet_out"], rtol=0,
                               atol=OUT_RTOL * np.abs(one["unet_out"]).max())
    assert got["row_sums"].shape == (len(src),)
    np.testing.assert_allclose(got["row_sums"], one["row_sums"], rtol=OUT_RTOL)


def test_gather_batch_puts_the_slabs_back(runs):
    """gather_batch(spatial=True) of each rank's shard_batch(spatial=True)
    slabs is the whole array, bit for bit."""
    for scenario, name in (("serve_3d", "mse"), ("serve_2d", "2d")):
        src = runs["case"]["serve"][name][0]
        for out in runs["ranks"]:
            np.testing.assert_array_equal(out[scenario]["inputs"], src)


@pytest.mark.parametrize("size,space,align,expected", [
    (160, 2, 16, [(0, 80), (80, 160)]),
    (160, 4, 16, [(0, 48), (48, 96), (96, 128), (128, 160)]),
    (24, 4, 4, [(0, 8), (8, 16), (16, 20), (20, 24)]),
    (26, 4, 4, [(0, 8), (8, 16), (16, 20), (20, 26)]),
    (7, 3, 1, [(0, 3), (3, 5), (5, 7)])])
def test_slab_bounds(size, space, align, expected):
    """Slabs of whole align-plane units, lengths apart by at most one unit,
    the remainder past the last unit on the last slab."""
    assert mesh_lib.slab_bounds(size, space, align) == expected


def test_slab_bounds_refuse_a_volume_too_thin():
    with pytest.raises(ValueError, match="--spatial-shard"):
        mesh_lib.slab_bounds(16, 2, 16)


def test_spatial_sharding_spec_and_slabs():
    """JAX's PartitionSpec with 'space' on the first spatial dim, only for
    arrays of three dims or more; each rank's rows and slab of (1, 4) and
    (2, 2) meshes, read in one process."""
    mesh = mesh_lib.make_mesh((2, 2), devices=range(4))
    assert mesh_lib.batch_sharding(mesh, 5, spatial=True).spec == tuple(
        jax_mesh.batch_sharding(jax_mesh.make_mesh((2, 2), devices=jax.devices()[:4]), 5,
                                spatial=True).spec)
    assert mesh_lib.batch_sharding(mesh, 2, spatial=True).spec == ("data", None)
    sh = mesh_lib.batch_sharding(mesh, 5, spatial=True, align=4)
    assert [sh.index((2, 24, 8, 8, 1), rank=r) for r in range(4)] == [
        (slice(0, 1), slice(0, 12)), (slice(0, 1), slice(12, 24)),
        (slice(1, 2), slice(0, 12)), (slice(1, 2), slice(12, 24))]
    row = mesh_lib.make_mesh((1, 4), devices=range(4))
    sh = mesh_lib.batch_sharding(row, 5, spatial=True, align=4)
    assert [sh.slab(24, rank=r) for r in range(4)] == [slice(0, 8), slice(8, 16),
                                                        slice(16, 20), slice(20, 24)]
    assert mesh_lib.batch_sharding(row, 5, spatial=False).index((1, 24, 8, 8, 1), rank=3) == (
        slice(0, 1),)


class _Hub:
    """The all-reduce of threads standing in for the ranks of a space
    group: each rank's buffer summed in rank order, behind a barrier."""

    def __init__(self, size):
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size

    def all_reduce(self, index, buf):
        self.slots[index] = buf.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for part in self.slots[1:]:
            total += part
        self.barrier.wait()
        buf.copy_(total)


class _ThreadSpace(mesh_lib.Space):
    def __init__(self, hub, size, index, depth, align):
        super().__init__(size, index, None, depth, align)
        self.hub = hub

    def all_reduce(self, buf):
        self.hub.all_reduce(self.index, buf)


def _on_threads(size, fn):
    """``fn(index)`` on ``size`` threads at once; their results in order."""
    results, errors = [None] * size, []

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


# (mode, dtype, ndims, do_res): cuDNN (the CPU's convolution) and the conv
# kernel's plain version, a residual block, a 2-D block
BLOCK_CASES = [("cudnn", torch.float32, 3, False), ("kernel", torch.float32, 3, False),
               ("kernel", torch.bfloat16, 3, False), ("cudnn", torch.float32, 3, True),
               ("cudnn", torch.float32, 2, False)]


@pytest.mark.parametrize("mode,dtype,ndims,do_res", BLOCK_CASES)
def test_conv_block_on_exchanged_slabs_matches_the_volume(mode, dtype, ndims, do_res):
    """A ConvBlock on each of four slabs (8/8/4/4 of 24 planes) widened by
    halo_exchange: its output, and the input and weight gradients of a
    random cotangent, against the block on the whole volume (the weight
    gradients summed over the slabs)."""
    rng = np.random.default_rng(5)
    spatial = (24, 8, 16)[:ndims]
    x = torch.from_numpy(rng.normal(size=(2, 6, *spatial)).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(rng.normal(size=(2, 8, *spatial)).astype(np.float32)).to(dtype)
    block = ConvBlock(6, 8, ndims, dtype=dtype, do_res=do_res,
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        block.conv.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    bounds = mesh_lib.slab_bounds(24, 4, 4)
    hub = _Hub(4)
    conv3.set_pallas_conv(mode == "kernel")
    try:
        whole_x = x.clone().requires_grad_()
        whole = block(whole_x)
        whole.backward(gy)

        def rank(i):
            lo, hi = bounds[i]
            mine = copy.deepcopy(block)
            mine.zero_grad()
            xs = x[:, :, lo:hi].clone().requires_grad_()
            ext = mesh_lib.halo_exchange(xs, 1, 2, _ThreadSpace(hub, 4, i, 24, 4))
            out = mine(ext, None, 24)
            out.backward(gy[:, :, lo:hi])
            return out.detach(), xs.grad, {n: p.grad for n, p in mine.named_parameters()}

        parts = _on_threads(4, rank)
    finally:
        conv3.set_pallas_conv(None)
    tol = 1e-5 if dtype == torch.float32 else 1e-2

    def close(a, b, label):
        a, b = a.float(), b.float()
        scale = b.abs().max()
        assert scale > 0 and (a - b).abs().max() <= tol * scale, label

    close(torch.cat([p[0] for p in parts], 2), whole.detach(), "output")
    close(torch.cat([p[1] for p in parts], 2), whole_x.grad, "input gradient")
    for name, p in block.named_parameters():
        close(sum(part[2][name] for part in parts), p.grad, name)


def test_gather_space_on_threads():
    """gather_space puts four slabs' fields together on every rank, and
    its backward keeps each rank's slab of the (whole, alike) cotangent."""
    rng = np.random.default_rng(6)
    field = torch.from_numpy(rng.normal(size=(1, 24, 4, 4, 3)).astype(np.float32))
    bounds = mesh_lib.slab_bounds(24, 4, 4)
    hub = _Hub(4)
    g = torch.from_numpy(rng.normal(size=field.shape).astype(np.float32))

    def rank(i):
        lo, hi = bounds[i]
        # a slab at half the resolution of the slabs' own volume of 48
        space = _ThreadSpace(hub, 4, i, 48, 8)
        part = field[:, lo:hi].clone().requires_grad_()
        whole = mesh_lib.gather_space(part, 1, space)
        whole.backward(g)
        return whole.detach(), part.grad

    results = _on_threads(4, rank)
    for whole, _ in results:
        assert torch.equal(whole, field)
    assert torch.equal(torch.cat([grad for _, grad in results], 1), g)


class _UsersModule(torch.nn.Module):
    """A model of the user's own, with no slab protocol."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(2, 3, 3, padding=1)

    def forward(self, source, target, generator=None):
        return {"flow": self.conv(torch.cat([source, target], -1).movedim(-1, 1))}


def _refused():
    feats = [[4, 4, 4], [4, 4, 4, 4]]  # three pools: slabs in units of 8 planes
    return {
        "_UsersModule": (NotImplementedError, "of _UsersModule is not ported: the model has "
                         "no slab protocol", _UsersModule),
        "Transform": (NotImplementedError, "of Transform is not ported", models.Transform),
        "a VxmDense too thin": (ValueError, "--spatial-shard", lambda: models.VxmDense(
            (8, 16, 16), nb_unet_features=feats)),
        # its slabs cut the half-resolution pair, 8 of 16 planes, in units
        # of 2 ** 3
        "a HyperVxmJoint too thin": (ValueError, "needs at least 16 planes", lambda: (
            models.HyperVxmJoint((16, 16, 16), int_steps=2, hyp_units=(4,), enc_nf=(4, 4, 4),
                                 dec_nf=(4, 4, 4), add_nf=(4,), aff_num_feat=4,
                                 aff_enc_nf=(4,)))),
    }


@pytest.mark.parametrize("name", sorted(_refused()))
def test_models_outside_the_slice_raise(name):
    """A mesh whose 'space' axis is > 1 refuses a model without the slab
    protocol (slab_inputs, slab_depth, slab_align, whole_parameters),
    naming it, and a volume too thin for the slabs of a model that has it."""
    error, message, make = _refused()[name]
    mesh = mesh_lib.make_mesh((1, 2), devices=[0, 1])
    with pytest.raises(error, match=message):
        Trainer(make(), [], device="cpu", mesh=mesh)
