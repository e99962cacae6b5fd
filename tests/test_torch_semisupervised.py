"""The port's semi-supervised segmentation path against the JAX package on
the CPU: the generator, ``VxmDenseSemiSupervisedSeg``, its training step,
checkpoints and resumes across the packages, registration through its inner
VxmDense, and the training CLI.

At 16^3 with narrow features and 6 one-hot labels at half resolution (more
than 4 channels: the segmentation warp is the gather in both packages), the
JAX params are carried across with ``params_from_jax`` after the flow head's
kernel is redrawn as N(0, 0.3), for flows of voxels. Tolerances, each
relative to the largest magnitude of the compared tensor, as in
``tests/test_torch_train.py``: 1e-5 on the forward's outputs, 1e-4 on one
step's loss and gradients, 2e-3 on the change of the params over 3 Adam
steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu import generators as jax_generators
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import VxmDenseSemiSupervisedSeg as JaxSeg
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.registration import resolve_registration_model as jax_resolve
from voxelmorph_tpu_torch import generators, losses
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import test as test_cli
from voxelmorph_tpu_torch.cli import train_semisupervised_seg as semi_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import (VxmDense, VxmDenseSemiSupervisedSeg,
                                             registration_model)
from voxelmorph_tpu_torch.py.utils import load_volfile
from voxelmorph_tpu_torch.registration import resolve_registration_model
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPE = (16, 16, 16)
HALF = (8, 8, 8)
LABELS = 6
CFG = dict(inshape=SHAPE, nb_labels=LABELS, nb_unet_features=[[4, 8], [8, 4]],
           int_steps=7, int_resolution=2)
LR = 1e-3
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-3
MIN_FLOW = 0.5  # voxels


def _scan(rng):
    """A blob image and a label map of LABELS regions (nearest of LABELS
    random centres, inside a ball)."""
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE],
                             indexing="ij"), -1)
    c = 8 + rng.uniform(-2.5, 2.5, size=3)
    d2 = ((g - c) ** 2).sum(-1)
    vol = np.exp(-d2 / 18).astype(np.float32)
    centres = rng.uniform(2, 14, size=(LABELS - 1, 3))
    seg = 1 + np.argmin(((g[..., None, :] - centres) ** 2).sum(-1), axis=-1)
    seg[d2 > 36] = 0
    return vol, seg.astype(np.int32)


def _batch(seed=1):
    """(src, trg, src_seg), (trg, zero flow, trg_seg) as the generator
    yields them: one-hot segs at half resolution."""
    rng = np.random.default_rng(seed)
    (sv, ss), (tv, ts) = _scan(rng), _scan(rng)
    onehot = [generators._one_hot_seg(s[None, ..., None], np.arange(LABELS), 2) for s in (ss, ts)]
    src, trg = sv[None, ..., None], tv[None, ..., None]
    return (src, trg, onehot[0]), (trg, np.zeros((1, *SHAPE, 3), np.float32), onehot[1])


def _jax_params(cfg):
    """JAX init with the flow head redrawn N(0, 0.3), as numpy arrays."""
    (src, trg, sseg), (_, _, tseg) = _batch()
    params = jax.device_get(dict(JaxSeg(**cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(trg), jnp.asarray(sseg),
        jnp.asarray(tseg))["params"]))
    vxm = dict(params["vxm"])
    vxm["flow"] = dict(vxm["flow"], kernel=np.random.default_rng(3).normal(
        0.0, 0.3, vxm["flow"]["kernel"].shape).astype(np.float32))
    params["vxm"] = vxm
    return params


def _torch_model(cfg, params=None):
    model = VxmDenseSemiSupervisedSeg(**cfg)
    if params is not None:
        model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return model


def _jax_terms():
    return [jax_training.LossTerm("y_source", jax_losses.MSE().loss, target_index=0),
            jax_training.LossTerm("reg", jax_losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                                  target_index=1, name="grad"),
            jax_training.LossTerm("y_seg_source", jax_losses.Dice().loss, weight=0.5,
                                  target_index=2, name="dice")]


def _torch_terms():
    return [LossTerm("y_source", losses.MSE().loss, target_index=0),
            LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=1,
                     name="grad"),
            LossTerm("y_seg_source", losses.Dice().loss, weight=0.5, target_index=2,
                     name="dice")]


def _files(tmp_path, n=4, separate_segs=False):
    """Scans as npz files with 'vol' and 'seg', or with the segs in files
    of their own, and an atlas npz."""
    rng = np.random.default_rng(7)
    vols, segs = [], []
    for i in range(n):
        vol, seg = _scan(rng)
        path = str(tmp_path / f"scan{i}.npz")
        if separate_segs:
            np.savez(path, vol=vol)
            segs.append(str(tmp_path / f"seg{i}.npz"))
            np.savez(segs[-1], seg=seg)
        else:
            np.savez(path, vol=vol, seg=seg)
            segs.append(path)
        vols.append(path)
    vol, seg = _scan(rng)
    np.savez(tmp_path / "atlas.npz", vol=vol, seg=seg)
    return vols, segs, str(tmp_path / "atlas.npz")


@pytest.mark.parametrize("layout", ["vol+seg npz", "seg files", "atlas"])
def test_generator_matches_jax(tmp_path, layout):
    """The same picks (the JAX module's generator seeded as the port's)
    give the same arrays."""
    vols, segs, atlas = _files(tmp_path, separate_segs=layout == "seg files")
    labels = np.array([0, 1, 3, 5])
    kw = dict(labels=labels, atlas_file=atlas if layout == "atlas" else None)
    jax_generators.seed_rng(5)
    ref = jax_generators.semisupervised(vols, segs, **kw)
    ours = generators.semisupervised(vols, segs, rng=np.random.default_rng(5), **kw)
    for _ in range(4):
        (ri, ro), (oi, oo) = next(ref), next(ours)
        for a, b in zip(oi + oo, ri + ro):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert oi[2].shape == (1, *HALF, len(labels)) and oi[2].sum() > 0


def test_generator_refuses_what_jax_refuses(tmp_path):
    vols, _, _ = _files(tmp_path, n=2)
    with pytest.raises(ValueError, match="must match"):
        next(generators.volgen(vols, segs=vols[:1]))
    niftis = [v.replace(".npz", ".nii.gz") for v in vols]
    with pytest.raises(ValueError, match="npz"):
        next(generators.semisupervised(niftis, niftis, labels=[1]))
    with pytest.raises(ValueError, match="npz"):
        next(jax_generators.semisupervised(niftis, niftis, labels=[1]))


@pytest.mark.parametrize("bidir_labels", [False, True])
def test_forward_matches_jax(bidir_labels):
    cfg = dict(CFG, bidir_labels=bidir_labels)
    params = _jax_params(cfg)
    (src, trg, sseg), (_, _, tseg) = _batch(2)
    ref = JaxSeg(**cfg).apply({"params": params}, jnp.asarray(src), jnp.asarray(trg),
                              jnp.asarray(sseg), jnp.asarray(tseg))
    model = _torch_model(cfg, params).train()
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (src, trg, sseg, tseg)))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    keys = ["y_source", "pos_flow", "preint_flow", "y_seg_source"]
    if bidir_labels:
        keys += ["y_target", "neg_flow", "y_seg_target"]
    else:
        assert "y_seg_target" not in out and "y_target" not in out
    for key in keys:
        assert out[key].shape == ref[key].shape, key
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    assert out["y_seg_source"].shape == (1, *HALF, LABELS)
    if bidir_labels:
        with pytest.raises(ValueError, match="target segmentation"):
            model(*map(torch.from_numpy, (src, trg, sseg)))


def test_train_steps_match_jax():
    """One step's loss and every gradient, then the params after 3 Adam
    steps, against the JAX package's loss and train step."""
    import optax
    params = _jax_params(CFG)
    inputs, targets = _batch(3)
    jm = JaxSeg(**CFG)
    loss_fn = jax_training.make_loss_fn(jm, _jax_terms())
    (ref_loss, (ref_metrics, _)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, {}, inputs, targets, jax.random.PRNGKey(0))
    tx = optax.adam(LR)
    step = jax_training.make_train_step(jm, _jax_terms(), tx, donate=False)
    ref_params, opt_state = params, tx.init(params)
    for i in range(3):
        ref_params, _, opt_state, _ = step(ref_params, {}, opt_state, jax.random.PRNGKey(0),
                                           np.asarray(i, np.int32), inputs, targets)

    model = _torch_model(CFG, params)
    trainer = Trainer(model, _torch_terms(), lr=LR, device="cpu")
    model.train()
    loss, metrics = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                                    tuple(map(torch.from_numpy, targets)))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    assert -1 <= metrics["dice"].item() < -0.05
    assert metrics["dice"].item() == pytest.approx(float(ref_metrics["dice"]), rel=GRAD_RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_grads = flatten(ref_grads)
    assert sorted(grads) == sorted(ref_grads) and all(k.startswith("vxm||") for k in grads)
    for name in ref_grads:
        assert_rel_close(grads[name], ref_grads[name], GRAD_RTOL, name)

    for _ in range(3):
        trainer.train_step(inputs, targets)
    ours = modelio.params_to_jax(model.state_dict())
    start, ref_params = flatten(params), flatten(ref_params)
    for name in ref_params:
        assert_rel_close(ours[name] - start[name], ref_params[name] - start[name], ADAM_RTOL,
                         name)


def _eval_outputs_match(jm, jp, model):
    (src, trg, sseg), _ = _batch(4)
    ref = jm.apply({"params": jp}, jnp.asarray(src), jnp.asarray(trg), jnp.asarray(sseg),
                   train=False)
    with torch.no_grad():
        out = model.eval()(*map(torch.from_numpy, (src, trg, sseg)))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "pos_flow", "y_seg_source"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)


def test_checkpoints_load_in_both_packages(tmp_path):
    params = _jax_params(CFG)
    # port -> JAX: a checkpoint of the port's Trainer
    trainer = Trainer(_torch_model(CFG, params), _torch_terms(), lr=LR, device="cpu")
    trainer.train_step(*_batch(3))
    trainer.save(str(tmp_path / "port.npz"))
    jm, jp = jax_load_model(str(tmp_path / "port.npz"))
    assert type(jm).__name__ == "VxmDenseSemiSupervisedSeg" and jm.nb_labels == LABELS
    _eval_outputs_match(jm, jp, trainer.model)

    # JAX -> port: the JAX package's save_model
    jax_save_model(str(tmp_path / "jax.npz"), JaxSeg(**CFG), params)
    model = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(model, VxmDenseSemiSupervisedSeg) and not model.training
    assert model.config == _torch_model(CFG).config
    _eval_outputs_match(JaxSeg(**CFG), params, model)


def _steps(trainer, n):
    for _ in range(n):
        trainer.train_step(*_batch(3))
    return trainer


def test_resume_across_packages_keeps_adam(tmp_path):
    """Two steps in one package, a checkpoint, one step in the other: the
    params of three steps in one package, both ways."""
    params = _jax_params(CFG)
    start = flatten(params)

    def compare(resumed, whole):
        for name in whole:
            assert_rel_close(resumed[name] - start[name], whole[name] - start[name], ADAM_RTOL,
                             name)

    jt = jax_training.Trainer(JaxSeg(**CFG), _jax_terms(), lr=LR)
    jt.init(None, params=jax.tree_util.tree_map(jnp.asarray, params))
    _steps(jt, 2).save(str(tmp_path / "jax_0002.npz"))
    jax_whole = flatten(jax.device_get(_steps(jt, 1).params))
    resumed = Trainer(_torch_model(CFG), _torch_terms(), lr=LR, device="cpu")
    resumed.load(str(tmp_path / "jax_0002.npz"))
    assert resumed.global_step == 2
    assert float(next(iter(resumed.optimizer.state.values()))["step"]) == 2
    compare(modelio.params_to_jax(_steps(resumed, 1).model.state_dict()), jax_whole)

    first = _steps(Trainer(_torch_model(CFG, params), _torch_terms(), lr=LR, device="cpu"), 2)
    first.save(str(tmp_path / "port_0002.npz"))
    port_whole = modelio.params_to_jax(_steps(first, 1).model.state_dict())
    jt = jax_training.Trainer(JaxSeg(**CFG), _jax_terms(), lr=LR)
    jt.load(str(tmp_path / "port_0002.npz"))
    assert jt.global_step == 2 and int(jt.opt_state[0].count) == 2
    compare(flatten(jax.device_get(_steps(jt, 1).params)), port_whole)


def test_registration_model_extracts_the_vxm_dense(tmp_path):
    cfg = dict(CFG, bidir_labels=True)
    params = _jax_params(cfg)
    model = _torch_model(cfg, params)
    net, state = registration_model(model)
    assert type(net) is VxmDense and net.bidir and net.int_steps == 7
    assert sorted(state) == sorted(k[len("vxm."):] for k in model.state_dict())
    assert resolve_registration_model(model) is net
    retargeted = resolve_registration_model(model, (24, 16, 16))
    assert retargeted.inshape == (24, 16, 16)
    with pytest.raises(ValueError, match="no registration extraction"):
        registration_model(type("VxmDenseUnknown", (), {})())

    # the register CLI on a semi-supervised checkpoint of the JAX package,
    # against the JAX package's extracted net
    jax_save_model(str(tmp_path / "semi.npz"), JaxSeg(**cfg), params)
    (src, trg, _), _ = _batch(5)
    np.savez(tmp_path / "mv.npz", vol=src[0, ..., 0])
    np.savez(tmp_path / "fx.npz", vol=trg[0, ..., 0])
    moved, warp = str(tmp_path / "moved.nii.gz"), str(tmp_path / "warp.nii.gz")
    register_cli.main(["--moving", str(tmp_path / "mv.npz"), "--fixed", str(tmp_path / "fx.npz"),
                       "--model", str(tmp_path / "semi.npz"), "--moved", moved, "--warp", warp,
                       "--device", "cpu"])
    jnet, jparams = jax_resolve(*jax_load_model(str(tmp_path / "semi.npz")))
    ref = jnet.apply({"params": jparams}, jnp.asarray(src), jnp.asarray(trg), train=False)
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    assert_rel_close(load_volfile(warp), np.asarray(ref["pos_flow"])[0], OUT_RTOL, "warp")
    assert_rel_close(load_volfile(moved), np.asarray(ref["y_source"])[0, ..., 0], OUT_RTOL,
                     "moved")


def _blob_recipe(tmp_path):
    """The repository's verification recipe: 4 blob scans (vol + 0/1 seg in
    npz), a list, pairs, and labels.npy of [1]."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in SHAPE], indexing="ij")
    files = []
    for i in range(4):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        files.append(str(tmp_path / f"scan{i}.npz"))
        np.savez(files[-1], vol=np.exp(-d2 / 18).astype(np.float32),
                 seg=(d2 < 9).astype(np.int32))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    (tmp_path / "pairs.txt").write_text(f"{files[0]} {files[1]}\n{files[2]} {files[3]}\n")
    np.save(tmp_path / "labels.npy", np.array([1]))
    return files


def test_cli_trains_then_serves(tmp_path, capsys):
    files = _blob_recipe(tmp_path)
    models = tmp_path / "models"
    args = ["--img-list", str(tmp_path / "list.txt"), "--img-suffix", "", "--seg-prefix", "",
            "--labels", str(tmp_path / "labels.npy"), "--model-dir", str(models),
            "--epochs", "2", "--steps-per-epoch", "3", "--int-steps", "2",
            "--enc", "4", "8", "--dec", "8", "4", "--lr", "1e-3"]
    semi_cli.main([*args, "--device", "cpu"])
    log = capsys.readouterr().out
    assert "epoch 1/2" in log and "epoch 2/2" in log and "dice:" in log
    assert sorted(os.listdir(models)) == ["0000.npz", "0002.npz", "metrics.csv"]
    with open(models / "metrics.csv") as f:
        assert f.readline().strip() == "epoch,wall_s,dice,grad,loss,y_source"
        rows = [dict(zip(("epoch", "wall_s", "dice", "grad", "loss", "y_source"),
                         map(float, line.split(",")))) for line in f]
    assert len(rows) == 2 and all(-1 <= r["dice"] < 0 for r in rows)
    jm, _ = jax_load_model(str(models / "0002.npz"))
    assert type(jm).__name__ == "VxmDenseSemiSupervisedSeg" and jm.nb_labels == 1

    # the serving CLIs take the checkpoint through its inner VxmDense
    moved, warp = str(tmp_path / "moved.nii.gz"), str(tmp_path / "warp.nii.gz")
    register_cli.main(["--moving", files[0], "--fixed", files[1], "--model",
                       str(models / "0002.npz"), "--moved", moved, "--warp", warp,
                       "--device", "cpu"])
    assert load_volfile(warp).shape == (*SHAPE, 3)
    scores = test_cli.main(["--model", str(models / "0002.npz"), "--pairs",
                            str(tmp_path / "pairs.txt"), "--img-suffix", "", "--seg-prefix", "",
                            "--device", "cpu"])
    assert len(scores) == 2 and all(0 < s <= 1 for s in scores)

    # the device-cached generator: scan-to-scan on npz files only
    cached = [str(tmp_path / "cached") if a == str(models) else a for a in args]
    semi_cli.main([*cached, "--cache-device", "--device", "cpu"])
    assert "epoch 2/2" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--cache-device"):
        semi_cli.main([*cached, "--cache-device", "--atlas", files[0], "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            semi_cli.main(args)
