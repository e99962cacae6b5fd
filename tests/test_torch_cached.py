"""The port's device-cached training against the JAX package on the CPU: the
pick stream and the cached generators, ``Trainer.fit_cached_pairs`` against
JAX's scanned dispatch and against single steps, resumes, the CLI's
``--cache-device`` and ``--steps-per-dispatch``, and the rematerialised
integration of ``integrate_vec_batched``.

The picks come from numpy (``default_rng((seed, step))``), so the port draws
JAX's sequence exactly. Training is compared at 16^3 with narrow features
and the flow head redrawn as N(0, 0.3), for flows of about a voxel: the
change of the params within 2e-3 of its largest magnitude, as in
``tests/test_torch_resume.py``, and the dispatch-mean metrics within 1e-3 of
JAX's (the steps' losses follow params that differ by that much). On one
device the port computes the same steps whatever the dispatch, so its K-step
and single-step runs, and a run resumed from its checkpoint, are bit-equal.
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
from voxelmorph_tpu.py import utils as jax_utils
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu_torch import generators, losses
from voxelmorph_tpu_torch.cli import train as train_cli
from voxelmorph_tpu_torch.py import utils
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.training import (LossTerm, Trainer, device_cached_pair_generator,
                                           device_cached_pair_indices,
                                           device_cached_semisupervised_generator,
                                           load_volume_stack)

SHAPE = (16, 16, 16)
CFG = dict(inshape=SHAPE, nb_unet_features=[[4, 8], [8, 4]], int_steps=7, int_resolution=2)
LR = 1e-3
ADAM_RTOL = 2e-3
METRIC_RTOL = 1e-3


def _files(tmp_path, n=5):
    """Blob scans (npz with 'vol' and a 3-label 'seg'), as the repository's
    verification recipe makes them."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in SHAPE], indexing="ij")
    files = []
    for i in range(n):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        files.append(str(tmp_path / f"scan{i}.npz"))
        np.savez(files[-1], vol=np.exp(-d2 / 18).astype(np.float32),
                 seg=(d2 < 9).astype(np.int32) + (d2 < 20) + (g[0] > 12))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    return files


@pytest.mark.parametrize("atlas, batch_size", [(False, 1), (True, 1), (False, 2)])
def test_pick_stream_and_generator_match_jax(tmp_path, atlas, batch_size):
    """20 steps of picks and batches equal JAX's; a stream started at step 7
    continues the uninterrupted one."""
    files = _files(tmp_path)
    n = len(files)
    kw = dict(batch_size=batch_size, atlas=atlas, seed=3)
    ours = device_cached_pair_indices(n, **kw)
    ref = jax_training.device_cached_pair_indices(n, **kw)
    picks = [next(ours) for _ in range(20)]
    for p in picks:
        r = next(ref)
        assert p.dtype == r.dtype and p.shape == (batch_size * (1 if atlas else 2),)
        np.testing.assert_array_equal(p, r)
    resumed = device_cached_pair_indices(n, start_step=7, **kw)
    for p in picks[7:]:
        np.testing.assert_array_equal(next(resumed), p)

    atlas_vol = np.load(files[0])["vol"][..., None] if atlas else None
    gkw = dict(batch_size=batch_size, bidir=True, atlas=atlas_vol, seed=3)
    ours = device_cached_pair_generator(files, device="cpu", **gkw)
    ref = jax_training.device_cached_pair_generator(files, **gkw)
    for _ in range(20):
        (oi, oo), (ri, ro) = next(ours), next(ref)
        for a, b in zip(oi + oo, ri + ro):
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    later = device_cached_pair_generator(files, device="cpu", start_step=7, **gkw)
    again = device_cached_pair_generator(files, device="cpu", **gkw)
    for _ in range(7):
        next(again)
    for _ in range(3):
        for a, b in zip(*(sum(next(g), []) for g in (later, again))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("pad_shape, resize_factor",
                         [((18, 20, 16), 1), (None, 0.5), ((20, 17, 18), 1.5)])
def test_volgen_pads_and_resizes_as_jax(tmp_path, pad_shape, resize_factor):
    """volgen's and load_volfile's pad_shape and resize_factor, with the
    JAX module's generator seeded as the port's."""
    files = _files(tmp_path)
    kw = dict(pad_shape=pad_shape, resize_factor=resize_factor)
    for var in ("vol", "seg"):
        np.testing.assert_array_equal(
            utils.load_volfile(files[1], np_var=var, add_feat_axis=True, **kw),
            jax_utils.load_volfile(files[1], np_var=var, add_feat_axis=True, **kw))
    jax_generators.seed_rng(6)
    ref = jax_generators.volgen(files, batch_size=2, segs=True, **kw)
    ours = generators.volgen(files, batch_size=2, segs=True, rng=np.random.default_rng(6), **kw)
    for _ in range(3):
        for a, b in zip(next(ours), next(ref)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    size = [round(p * resize_factor) for p in (pad_shape or SHAPE)]
    assert a.shape == (2, *size, 1)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(utils.resize(t, 2, batch_axis=True).numpy(),
                                  jax_utils.resize(a, 2, batch_axis=True))


def test_semisupervised_generator_matches_jax(tmp_path):
    files = _files(tmp_path)
    labels = np.array([1, 2, 3])
    ours = device_cached_semisupervised_generator(files, labels, seed=2, device="cpu")
    ref = jax_training.device_cached_semisupervised_generator(files, labels, seed=2)
    for _ in range(6):
        (oi, oo), (ri, ro) = next(ours), next(ref)
        for a, b in zip(oi + oo, ri + ro):
            assert a.dtype == torch.float32 and tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert oi[2].shape == (1, 8, 8, 8, 3) and oi[2].sum() > 0


def _params(data):
    probe = jnp.asarray(data[:1])
    params = jax.device_get(dict(JaxVxmDense(**CFG).init(jax.random.PRNGKey(0), probe,
                                                         probe)["params"]))
    params["flow"] = dict(params["flow"], kernel=np.random.default_rng(3).normal(
        0.0, 0.3, params["flow"]["kernel"].shape).astype(np.float32))
    return params


def _terms(L, Term):
    return [Term("y_source", L.MSE(1.0).loss, weight=1.0, target_index=0),
            Term("reg", L.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=1,
                 name="grad")]


def _trainer(params):
    model = VxmDense(**CFG)
    model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return Trainer(model, _terms(losses, LossTerm), lr=LR, device="cpu")


def _jax_trainer(params):
    jt = jax_training.Trainer(JaxVxmDense(**CFG), _terms(jax_losses, jax_training.LossTerm),
                              lr=LR)
    jt.init(None, params=jax.tree_util.tree_map(jnp.asarray, params))
    return jt


def test_fit_cached_pairs_matches_jax_and_single_steps(tmp_path):
    """K = 3 against JAX's scanned dispatch of 3 steps (params and the
    dispatch-mean metrics), and against three dispatches of one step (the
    same params bit for bit; one metric fetch a dispatch)."""
    data = load_volume_stack(_files(tmp_path), device="cpu").numpy()
    params = _params(data)
    kw = dict(batch_size=1, seed=5, log_fn=lambda _: None)
    jt = _jax_trainer(params)
    ref_metrics = jt.fit_cached_pairs(data, epochs=1, steps_per_epoch=3, steps_per_dispatch=3,
                                      **kw)

    trainer = _trainer(params)
    metrics = trainer.fit_cached_pairs(data, epochs=1, steps_per_epoch=3,
                                       steps_per_dispatch=3, **kw)
    assert trainer.global_step == 3 and trainer.metric_fetches == 1
    assert sorted(metrics) == sorted(ref_metrics)
    for key in ref_metrics:
        assert metrics[key] == pytest.approx(ref_metrics[key], rel=METRIC_RTOL), key
    ours = modelio.params_to_jax(trainer.model.state_dict())
    start, ref = flatten(params), flatten(jax.device_get(jt.params))
    for name in ref:
        assert_rel_close(ours[name] - start[name], ref[name] - start[name], ADAM_RTOL, name)

    single = _trainer(params)
    csv = str(tmp_path / "single.csv")
    single.fit_cached_pairs(data, epochs=3, steps_per_epoch=1, steps_per_dispatch=1,
                            metrics_csv=csv, **kw)
    assert single.global_step == 3 and single.metric_fetches == 3
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(single.model.state_dict()[name], p), name
    with open(csv) as f:
        keys = f.readline().strip().split(",")
        rows = [dict(zip(keys, map(float, line.split(",")))) for line in f]
    for key in metrics:  # the K = 3 dispatch's mean is the mean of its steps
        assert metrics[key] == pytest.approx(np.mean([r[key] for r in rows]), rel=1e-6), key
    with pytest.raises(ValueError, match="multiple"):
        single.fit_cached_pairs(data, epochs=1, steps_per_epoch=4, steps_per_dispatch=3, **kw)


def test_fit_cached_pairs_resumes_either_package(tmp_path):
    """A port run resumed from its own checkpoint equals the uninterrupted
    run bit for bit; one resumed from a JAX checkpoint continues JAX's
    stream and steps (params within 2e-3 of their change)."""
    data = load_volume_stack(_files(tmp_path), device="cpu").numpy()
    params = _params(data)
    kw = dict(steps_per_epoch=2, steps_per_dispatch=2, seed=4, log_fn=lambda _: None)
    whole = _trainer(params)
    whole.fit_cached_pairs(data, epochs=2, **kw)
    first = _trainer(params)
    first.fit_cached_pairs(data, epochs=1, model_dir=str(tmp_path / "port"), **kw)
    resumed = _trainer(params)
    resumed.load(str(tmp_path / "port" / "0001.npz"))
    resumed.fit_cached_pairs(data, epochs=2, initial_epoch=1, **kw)
    for name, p in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], p), name

    jt = _jax_trainer(params)
    jt.fit_cached_pairs(data, epochs=1, model_dir=str(tmp_path / "jax"), **kw)
    jt.fit_cached_pairs(data, epochs=2, initial_epoch=1, **kw)
    from_jax = _trainer(params)
    from_jax.load(str(tmp_path / "jax" / "0001.npz"))
    assert from_jax.global_step == 2
    from_jax.fit_cached_pairs(data, epochs=2, initial_epoch=1, **kw)
    ours = modelio.params_to_jax(from_jax.model.state_dict())
    start, ref = flatten(params), flatten(jax.device_get(jt.params))
    for name in ref:
        assert_rel_close(ours[name] - start[name], ref[name] - start[name], ADAM_RTOL, name)


def test_cli_cache_device_with_steps_per_dispatch(tmp_path, capsys):
    _files(tmp_path, n=4)
    args = ["--img-list", str(tmp_path / "list.txt"), "--epochs", "2", "--steps-per-epoch", "3",
            "--int-steps", "2", "--enc", "4", "8", "--dec", "8", "4", "--lr", "1e-3",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="requires --cache-device"):
        train_cli.main([*args, "--steps-per-dispatch", "3"])
    runs = {}
    for name, extra in (("dispatch", ["--steps-per-dispatch", "3"]), ("cached", [])):
        models = tmp_path / name
        train_cli.main([*args, "--model-dir", str(models), "--cache-device", *extra])
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
        loss = [float(ln.split("loss: ")[1].split()[0]) for ln in lines]
        assert len(loss) == 2 and loss[1] < loss[0], lines
        assert sorted(os.listdir(models)) == ["0000.npz", "0002.npz", "metrics.csv"]
        runs[name] = modelio.load_model(str(models / "0002.npz"), device="cpu").state_dict()
    # both paths train on the same picks (the probe took step 0 in both)
    for name, p in runs["cached"].items():
        assert torch.equal(runs["dispatch"][name], p), name


@pytest.fixture
def tier_log(monkeypatch):
    """The tiers that the integration's warps take, in call order."""
    log = []
    switch = warp_ops._tiered_windowed_switch

    def spy(args, windowed_fn, gather_fn, window_halo, max_d):
        tier = next((h for h in sorted({1, int(window_halo)}) if max_d <= h), "gather")
        log.append((max_d, tier))
        return switch(args, windowed_fn, gather_fn, window_halo, max_d)

    monkeypatch.setattr(warp_ops, "_tiered_windowed_switch", spy)
    monkeypatch.setenv("VXM_WINDOW_HALO", "2")
    return log


def test_integrate_remat_gradients_and_tiers(tier_log):
    """The rematerialised integration's gradients equal the stored one's bit
    for bit, and every recomputed squaring takes the tier its forward took:
    the halo-1 kernel, the halo-2 kernel and the gather all occur."""
    rng = np.random.default_rng(0)
    vec = torch.from_numpy(rng.normal(0, 3.0, size=(1, 8, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=vec.shape).astype(np.float32))
    grads = {}
    for remat in (False, True):
        tier_log.clear()
        v = vec.clone().requires_grad_()
        out = warp_ops.integrate_vec_batched(v, nb_steps=5, remat=remat)
        forward = list(tier_log)
        (out * w).sum().backward()
        grads[remat] = (out.detach(), v.grad)
        recomputed = tier_log[len(forward):]
        assert len(forward) == 5
        assert {t for _, t in forward} == {1, 2, "gather"}
        # the backward recomputes the squarings last to first
        assert recomputed == (forward[::-1] if remat else [])
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
