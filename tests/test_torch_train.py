"""The PyTorch port's training path against the JAX package on the CPU.

At 16^3 with narrow features, JAX params are carried across with
``params_from_jax`` after the flow head's kernel is redrawn as N(0, 0.3)
(its own N(0, 1e-5) init gives flows of ~1e-4 voxels, which no comparison
could see), so that flows are 0.5-4 voxels. Both sides get the same inputs
and, for ``use_probs``, the same noise: the test replaces the sampler of each
package for its duration. Tolerances, each relative to the largest magnitude
of the compared tensor: 1e-5 on the training forward's outputs, 1e-4 on one
step's loss and parameter gradients, and 2e-3 on the change of the params
over 3 Adam steps (measured: <= 7.6e-7, <= 8.1e-6 and <= 2.0e-4; the
convolutions and scatter-adds sum in other orders, and Adam's first steps
divide each gradient by its own magnitude, which amplifies the differences
of small entries).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import train as train_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models import vxm as vxm_module
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib
from voxelmorph_tpu_torch.py.utils import load_volfile
from voxelmorph_tpu_torch.registration import register_pair
from voxelmorph_tpu_torch.training import LossTerm, Trainer, find_latest_checkpoint

SHAPE = (16, 16, 16)
CFG = dict(inshape=SHAPE, nb_unet_features=[[4, 8], [8, 4]], int_steps=7, int_resolution=2)
LR = 1e-4
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-3
MIN_FLOW = 0.5  # voxels


def _pair(seed):
    """Two smooth blobs, as in the repository's verification recipe."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE], indexing="ij")
    out = []
    for _ in range(2):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        out.append(np.exp(-d2 / 18).astype(np.float32)[None, ..., None])
    return out


def _jax_model(cfg, seed=0):
    jm = JaxVxmDense(**cfg)
    src, trg = _pair(seed)
    key = jax.random.PRNGKey(seed)
    params = dict(jm.init({"params": key, "sample": key}, jnp.asarray(src),
                          jnp.asarray(trg))["params"])
    kernel = params["flow"]["kernel"]
    params["flow"] = dict(params["flow"], kernel=jnp.asarray(
        np.random.default_rng(3).normal(0.0, 0.3, kernel.shape).astype(np.float32)))
    return jm, params


def _torch_model(cfg, params):
    model = VxmDense(**cfg)
    model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return model


@pytest.fixture
def same_noise(monkeypatch):
    """Feed both packages the same numpy noise for the use_probs sample."""
    eps = np.random.default_rng(11).normal(size=(1, *SHAPE, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(eps, dtype).reshape(shape))
    monkeypatch.setattr(vxm_module, "sample_normal",
                        lambda shape, generator, device: torch.from_numpy(eps).reshape(shape))
    return eps


def test_train_forward_with_probs_matches_jax(monkeypatch):
    cfg = dict(CFG, use_probs=True, bidir=True)
    jm, params = _jax_model(cfg)
    model = _torch_model(cfg, params).train()
    src, trg = _pair(1)
    eps = np.random.default_rng(11).normal(size=(1, *SHAPE, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(eps, dtype))
    monkeypatch.setattr(vxm_module, "sample_normal",
                        lambda shape, generator, device: torch.from_numpy(eps))
    ref = jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(trg), train=True,
                   rngs={"sample": jax.random.PRNGKey(0)})
    out = model(torch.from_numpy(src), torch.from_numpy(trg))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "y_target", "svf", "preint_flow", "pos_flow", "neg_flow",
                "flow_params"):
        assert_rel_close(out[key].detach().numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    # the sample differs from the mean the eval forward uses
    model.eval()
    mean = model(torch.from_numpy(src), torch.from_numpy(trg))["svf"]
    assert (mean - out["svf"]).abs().max() > 1e-3


RECIPES = {
    # scripts/train.py's default: MSE + Grad-l2 (loss_mult 2), lambda 0.01
    "default": (dict(), lambda L: [
        L.LossTerm("y_source", L.losses.MSE(1.0).loss, weight=1.0, target_index=0),
        L.LossTerm("reg", L.losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                   target_index=1, name="grad")]),
    "ncc": (dict(), lambda L: [
        L.LossTerm("y_source", L.losses.NCC().loss, weight=1.0, target_index=0),
        L.LossTerm("reg", L.losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                   target_index=1, name="grad")]),
    # the committed checkpoint's recipe: use_probs, NCC and KL
    "probs": (dict(use_probs=True), lambda L: [
        L.LossTerm("y_source", L.losses.NCC().loss, weight=1.0, target_index=0),
        L.LossTerm("reg", L.losses.KL(10.0, SHAPE).loss, weight=0.01,
                   target_index=1, name="kl")]),
}


class _Jax:
    losses = jax_losses
    LossTerm = jax_training.LossTerm


class _Torch:
    losses = losses
    LossTerm = LossTerm


@pytest.mark.parametrize("recipe,window", [("default", "gather"), ("default", "kernel"),
                                           ("ncc", "gather"), ("probs", "gather")])
def test_train_steps_match_jax(monkeypatch, same_noise, recipe, window):
    """One step's loss and every parameter gradient, then the params after 3
    Adam steps, against the JAX package's loss and ``make_train_step``. With
    ``window`` 'kernel' the port's squaring steps take the bounded warp and
    its backward (the plain version of the CUDA kernel) where JAX gathers."""
    extra, make_terms = RECIPES[recipe]
    cfg = dict(CFG, **extra)
    jm, params = _jax_model(cfg)
    src, trg = _pair(1)
    zero = np.zeros((1, *SHAPE, 3), np.float32)
    inputs, targets = (src, trg), (trg, zero)
    key = jax.random.PRNGKey(0)
    jterms = make_terms(_Jax)
    loss_fn = jax_training.make_loss_fn(jm, jterms, needs_sample_rng=cfg.get("use_probs", False))
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {}, inputs, targets, key)
    tx = optax.adam(LR)
    step = jax_training.make_train_step(jm, jterms, tx, donate=False,
                                        needs_sample_rng=cfg.get("use_probs", False))
    ref_params, opt_state = params, tx.init(params)
    for i in range(3):
        ref_params, _, opt_state, _ = step(ref_params, {}, opt_state, key,
                                           np.asarray(i, np.int32), inputs, targets)

    monkeypatch.setenv("VXM_WINDOW_HALO", "1" if window == "kernel" else "0")
    model = _torch_model(cfg, params)
    trainer = Trainer(model, make_terms(_Torch), lr=LR, device="cpu")
    model.train()
    loss, _ = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                              tuple(map(torch.from_numpy, targets)))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_grads = flatten(ref_grads)
    assert sorted(grads) == sorted(ref_grads)
    for name in ref_grads:
        assert_rel_close(grads[name], ref_grads[name], GRAD_RTOL, name)

    for _ in range(3):
        trainer.train_step(inputs, targets)
    ours = modelio.params_to_jax(model.state_dict())
    start, ref_params = flatten(params), flatten(ref_params)
    for name in ref_params:
        assert_rel_close(ours[name] - start[name], ref_params[name] - start[name],
                         ADAM_RTOL, name)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port's Trainer wrote gives the JAX package's
    load_model the same model: its outputs equal the port's."""
    cfg = dict(CFG, use_probs=True)
    _, params = _jax_model(cfg)
    model = _torch_model(cfg, params)
    trainer = Trainer(model, [LossTerm("y_source", losses.MSE().loss)], device="cpu")
    trainer.train_step(_pair(1), (_pair(1)[1],))
    path = str(tmp_path / "0001.npz")
    trainer.save(path)

    jm, jp = jax_load_model(path)
    assert jm.use_probs and tuple(jm.inshape) == SHAPE and jm.dtype == jnp.float32
    src, trg = _pair(2)
    ref = jm.apply({"params": jp}, jnp.asarray(src), jnp.asarray(trg), train=False)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(src), torch.from_numpy(trg))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "pos_flow", "flow_params"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)


def test_resume_continues_the_run(tmp_path):
    """Two steps, a checkpoint, a new Trainer that loads it and takes one
    more step: the same params as three steps without a break."""
    def run(steps, load=None):
        torch.manual_seed(0)
        model = VxmDense(**CFG, use_probs=True, generator=torch.Generator().manual_seed(5))
        terms = [LossTerm("y_source", losses.MSE().loss, target_index=0),
                 LossTerm("reg", losses.KL(10.0, SHAPE).loss, weight=0.01, target_index=1)]
        trainer = Trainer(model, terms, lr=1e-2, seed=3, device="cpu")
        if load:
            trainer.load(load)
        for _ in range(steps):
            trainer.train_step(_pair(1), (_pair(1)[1], np.zeros((1, *SHAPE, 3), np.float32)))
        return trainer

    first = run(2)
    first.save(str(tmp_path / "0002.npz"))
    resumed = run(1, load=str(tmp_path / "0002.npz"))
    whole = run(3)
    assert resumed.global_step == whole.global_step == 3
    for (name, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert find_latest_checkpoint(str(tmp_path)) == (str(tmp_path / "0002.npz"), 2)


def test_init_draws_as_flax():
    """he-normal convs (truncated at two std, std sqrt(2 / fan_in)), zero
    biases, the flow head N(0, 1e-5), the log-sigma head N(0, 1e-10) and -10."""
    model = VxmDense((32, 32, 32), use_probs=True, generator=torch.Generator().manual_seed(0))
    w = model.unet.dec_final_conv_0.conv.weight  # 48 -> 32 channels
    std = (2.0 / w[0].numel()) ** 0.5
    assert w.std().item() == pytest.approx(std, rel=0.05)
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert not model.unet.dec_final_conv_0.conv.bias.any()
    assert model.flow.weight.std().item() == pytest.approx(1e-5, rel=0.1)
    assert model.log_sigma.weight.std().item() == pytest.approx(1e-10, rel=0.1)
    assert torch.all(model.log_sigma.bias == -10)
    same = VxmDense((32, 32, 32), use_probs=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(same.unet.enc_conv_0_0.conv.weight, model.unet.enc_conv_0_0.conv.weight)


def _blob_files(tmp_path, n=4):
    """The blob scans of the repository's verification recipe."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in SHAPE], indexing="ij")
    files = []
    for i in range(n):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        path = tmp_path / f"scan{i}.npz"
        np.savez(path, vol=np.exp(-d2 / 18).astype(np.float32), seg=(d2 < 9).astype(np.int32))
        files.append(str(path))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    return files


def test_cli_train_then_register(tmp_path, capsys):
    files = _blob_files(tmp_path)
    models = tmp_path / "models"
    train_cli.main(["--img-list", str(tmp_path / "list.txt"), "--model-dir", str(models),
                    "--epochs", "2", "--steps-per-epoch", "3", "--int-steps", "2",
                    "--enc", "4", "8", "--dec", "8", "4", "--lr", "1e-3", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "epoch 1/2" in log and "epoch 2/2" in log
    assert sorted(os.listdir(models)) == ["0000.npz", "0002.npz", "metrics.csv"]
    with open(models / "metrics.csv") as f:
        assert f.readline().strip() == "epoch,wall_s,grad,loss,y_source"
        assert len(f.readlines()) == 2

    moved, warp = str(tmp_path / "moved.nii.gz"), str(tmp_path / "warp.nii.gz")
    register_cli.main(["--moving", files[0], "--fixed", files[1], "--model",
                       str(models / "0002.npz"), "--moved", moved, "--warp", warp,
                       "--device", "cpu"])
    mv = load_volfile(files[0], add_batch_axis=True, add_feat_axis=True)
    fx = load_volfile(files[1], add_batch_axis=True, add_feat_axis=True)
    ref_moved, ref_warp = register_pair(modelio.load_model(str(models / "0002.npz"),
                                                           device="cpu"), mv, fx)
    np.testing.assert_array_equal(load_volfile(moved), np.squeeze(ref_moved))
    np.testing.assert_array_equal(load_volfile(warp), np.squeeze(ref_warp))
    # the trained flow head moved away from its N(0, 1e-5) init
    assert np.abs(ref_warp).max() > 1e-3


# what the CLI refuses of the multi-device flags, by the first flag: the
# error and the flag it names
REFUSED = {"--spatial-shard": (ValueError, "--spatial-shard"),
           "--coordinator": (ValueError, "--num-processes"),
           "--process-id": (ValueError, "--process-id"),
           "--num-processes": (ValueError, "--coordinator")}


@pytest.mark.parametrize("flag", [["--spatial-shard"],
                                  ["--coordinator", "localhost:1", "--num-processes", "0"],
                                  ["--process-id", "1"], ["--num-processes", "2"]])
def test_cli_train_rejects_unported_flags(tmp_path, flag, monkeypatch):
    """--spatial-shard where the rank that the batch leaves over cannot
    take a slab (a world of two ranks, patched in, at batch 1: 16 planes
    do not split into two slabs of the default U-Net's 16-plane unit),
    --num-processes below 1, a --process-id outside the job and several
    processes without --coordinator raise, naming the flag."""
    _blob_files(tmp_path, n=2)
    monkeypatch.setattr(mesh_lib, "world", lambda: (0, 2))
    error, named = REFUSED[flag[0]]
    with pytest.raises(error, match=named):
        train_cli.main(["--img-list", str(tmp_path / "list.txt"), "--device", "cpu", *flag])


def test_training_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the GPU default runs")
    _blob_files(tmp_path, n=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(VxmDense(SHAPE), [LossTerm("y_source", losses.MSE().loss)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--img-list", str(tmp_path / "list.txt")])


def test_warp_bounded_gradient_reaches_the_flow_in_training(monkeypatch):
    """The bounded warp carries a gradient to the flow, so a model whose every
    warp takes the kernel tier still trains its U-Net."""
    model = VxmDense(SHAPE, nb_unet_features=[[4, 8], [8, 4]], int_steps=3,
                     generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        model.flow.weight.normal_(0, 1e-2, generator=torch.Generator().manual_seed(1))
    src, trg = (torch.from_numpy(a) for a in _pair(1))
    before = warp_bounded.launches
    monkeypatch.setenv("VXM_WINDOW_HALO", "1")
    out = model(src, trg)
    assert out["pos_flow"].abs().max() <= 1  # every warp on the kernel tier
    loss = losses.MSE().loss(trg, out["y_source"])
    loss.backward()
    assert warp_bounded.launches == before == 0  # the CPU runs the plain versions
    assert model.unet.enc_conv_0_0.conv.weight.grad.abs().max() > 0
    assert model.flow.weight.grad.abs().max() > 0


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_optax(max_norm):
    from voxelmorph_tpu_torch.training import _clip_by_global_norm
    rng = np.random.default_rng(9)
    grads = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    ours = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    _clip_by_global_norm(list(ours.values()), max_norm)
    for k in grads:
        assert_rel_close(ours[k].numpy(), np.asarray(ref[k]), 1e-6, k)
    if max_norm > 10:
        assert all(np.array_equal(ours[k].numpy(), grads[k]) for k in grads)
