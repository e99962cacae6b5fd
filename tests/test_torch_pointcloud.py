"""The port's point-cloud semi-supervised path against the JAX package on the
CPU: ``py/ndimage``, the segmentation, SDT and surface helpers of
``py/utils``, the ``surf_semisupervised`` generator,
``VxmDenseSemiSupervisedPointCloud``, its training step, its checkpoints and
the training CLI.

The image helpers and the generator must equal the JAX package's numpy
versions bit for bit: integer labels, exact sums of integer squared
distances, the same float64 products and sums in the same order, and the
same numpy draws. The model is compared at 16^3 with narrow features and the
flow head redrawn as N(0, 0.3), for flows of about a voxel (at the init's
~1e-5 voxels, points sit on exact grid coordinates, where the two packages'
gathers differ): the forward within 1e-4 and the change of the params over
3 Adam steps within 2e-3 of the compared tensor's largest magnitude, as in
``tests/test_torch_resume.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu import generators as jax_generators
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import VxmDenseSemiSupervisedPointCloud as JaxPC
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models.vxm import registration_model as jax_registration_model
from voxelmorph_tpu.py import ndimage as jax_ndimage
from voxelmorph_tpu.py import utils as jax_utils
from voxelmorph_tpu_torch import generators, losses
from voxelmorph_tpu_torch.cli import train_semisupervised_pointcloud as pc_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import (VxmDense, VxmDenseSemiSupervisedPointCloud,
                                             registration_model)
from voxelmorph_tpu_torch.py import ndimage
from voxelmorph_tpu_torch.py import utils
from voxelmorph_tpu_torch.registration import resolve_registration_model
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPE = (16, 16, 16)
NPTS = 64
LR = 1e-3
OUT_RTOL = 1e-4
ADAM_RTOL = 2e-3
MIN_FLOW = 0.5  # voxels


def _label_map(shape, seed):
    """A label map with what cleaning and distance transforms must handle:
    label 1 a ball with a hole and a second, smaller island; label 2 a slab
    touching the volume's edge; label 3 a small ball; background 0."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=float) for s in shape], indexing="ij"), -1)
    centre = np.asarray(shape) / 2 + rng.uniform(-1, 1, size=len(shape))
    r = np.sqrt(((g - centre) ** 2).sum(-1))
    seg = np.zeros(shape, np.int32)
    seg[r < shape[0] * 0.3] = 1
    seg[r < 1.2] = 0  # the hole
    island = np.asarray([2] * len(shape)) + rng.integers(0, 2, size=len(shape))
    seg[tuple(slice(i, i + 2) for i in island)] = 1
    seg[..., -3:][r[..., -3:] < shape[0] * 0.45] = 2
    small = centre + np.asarray([shape[0] * 0.3] + [0] * (len(shape) - 1))
    seg[np.sqrt(((g - small) ** 2).sum(-1)) < 2.2] = 3
    return seg


def _blobs(shape, seed):
    """A random binary image of several blobs, holes and edge contacts."""
    rng = np.random.default_rng(seed)
    f = jax_ndimage.gaussian_filter(rng.random(shape), 1.2)
    return f > np.quantile(f, 0.55)


SHAPES = [(16, 16, 16), (24, 20)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_label_components_and_edt_equal_numpy(shape, seed):
    bw = _blobs(shape, seed)
    lab = ndimage.label_components(torch.from_numpy(bw)).numpy()
    ref = jax_ndimage.label_components(bw)
    assert ref.max() >= 2 and lab.dtype == ref.dtype
    np.testing.assert_array_equal(lab, ref)
    for x in (bw, ~bw, np.ones(shape, bool), np.zeros(shape, bool)):
        np.testing.assert_array_equal(ndimage.label_components(torch.from_numpy(x)).numpy(),
                                      jax_ndimage.label_components(x))
        np.testing.assert_array_equal(
            ndimage.distance_transform_edt(torch.from_numpy(x)).numpy(),
            jax_ndimage.distance_transform_edt(x))


@pytest.mark.parametrize("shape", SHAPES + [(7,)], ids=str)
def test_blur_and_zoom_equal_numpy(shape):
    f = np.random.default_rng(2).random(shape)
    for sigma in (0.1, 0.7, 1.0, 3.0):
        np.testing.assert_array_equal(ndimage.gaussian_filter(torch.from_numpy(f), sigma).numpy(),
                                      jax_ndimage.gaussian_filter(f, sigma))
    for factor in (2, 0.5, 1.3, [1, 0.5, 2][:len(shape)]):
        for order in (0, 1):
            ours = ndimage.zoom(torch.from_numpy(f), factor, order).numpy()
            ref = jax_ndimage.zoom(f, factor, order)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        ndimage.zoom(torch.from_numpy(f.astype(np.float32)), 2, 1).numpy(),
        jax_ndimage.zoom(f.astype(np.float32), 2, 1))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("std", [0.1, 1.0])
def test_seg_and_sdt_helpers_equal_numpy(shape, std):
    seg = _label_map(shape, 3)
    t = torch.from_numpy(seg)
    for label in (1, 2, 3):
        mask = seg == label
        np.testing.assert_array_equal(utils.extract_largest_vol(torch.from_numpy(mask)).numpy(),
                                      jax_utils.extract_largest_vol(mask))
        clean = utils.clean_seg(t == label, std)
        ref = jax_utils.clean_seg(mask, std)
        assert clean.dtype == torch.float64
        np.testing.assert_array_equal(clean.numpy(), ref)
        for resize in (1, 0.5):
            for signed in (True, False):
                np.testing.assert_array_equal(
                    utils.vol_to_sdt(clean, sdt=signed, sdt_vol_resize=resize).numpy(),
                    jax_utils.vol_to_sdt(ref, sdt=signed, sdt_vol_resize=resize))
    np.testing.assert_array_equal(utils.filter_labels(t, [1, 3]).numpy(),
                                  jax_utils.filter_labels(seg, [1, 3]))
    batch = (seg[None, ..., None] == 1)
    np.testing.assert_array_equal(
        utils.clean_seg_batch(torch.from_numpy(batch.astype(float)), std).numpy(),
        jax_utils.clean_seg_batch(batch.astype(float), std))
    np.testing.assert_array_equal(
        utils.vol_to_sdt_batch(torch.from_numpy(batch)).numpy(),
        jax_utils.vol_to_sdt_batch(batch))
    with pytest.raises(ValueError, match="no foreground"):
        utils.extract_largest_vol(torch.zeros(shape, dtype=torch.bool))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_surface_points_equal_numpy(shape):
    seg = _label_map(shape, 4)
    sdt = jax_utils.vol_to_sdt(jax_utils.clean_seg(seg == 1, 0.1))
    ratios = np.array([0.2, 0.3, 0.5])
    np.testing.assert_array_equal(utils.get_surface_pts_per_label(101, ratios),
                                  jax_utils.get_surface_pts_per_label(101, ratios))
    edges = np.abs(sdt) < 1
    np.testing.assert_array_equal(utils.edge_to_surface_pts(torch.from_numpy(edges)).numpy(),
                                  jax_utils.edge_to_surface_pts(edges))
    for factor, thr in ((2, 0.50001), (3, 1 / 3 + 1e-5)):
        ours = utils.sdt_to_surface_pts(torch.from_numpy(sdt), 40, factor, thr,
                                        rng=np.random.default_rng(9))
        ref = jax_utils.sdt_to_surface_pts(sdt, 40, factor, thr, rng=np.random.default_rng(9))
        assert ours.dtype == torch.float64 and ours.shape == (40, len(shape))
        np.testing.assert_array_equal(ours.numpy(), ref)


def _files(tmp_path, n=3):
    """Scans (npz with 'vol' and 'seg') and an atlas, of _label_map's
    labels with blurred intensities."""
    paths = []
    for i in range(n + 1):
        seg = _label_map(SHAPE, 10 + i)
        vol = jax_ndimage.gaussian_filter(seg.astype(float), 1.0).astype(np.float32) / 3
        path = str(tmp_path / (f"scan{i}.npz" if i < n else "atlas.npz"))
        np.savez(path, vol=vol, seg=seg)
        paths.append(path)
    return paths[:n], paths[n]


@pytest.mark.parametrize("nb_labels_sample, surf_bidir",
                         [(None, True), (2, True), (3, False), (1, False)])
def test_generator_matches_jax(tmp_path, nb_labels_sample, surf_bidir):
    """The same seed gives the same images, SDT stacks and point clouds,
    with every label and with fewer labels drawn per step."""
    scans, atlas = _files(tmp_path)
    with np.load(atlas) as d:
        atlas_vol, atlas_seg = d["vol"], d["seg"]
    kw = dict(nb_surface_pts=NPTS, surf_bidir=surf_bidir, smooth_seg_std=0.1,
              nb_labels_sample=nb_labels_sample)
    jax_generators.seed_rng(11)
    ref = jax_generators.surf_semisupervised(scans, atlas_vol, atlas_seg, **kw)
    ours = generators.surf_semisupervised(scans, atlas_vol, atlas_seg, device="cpu",
                                          rng=np.random.default_rng(11), **kw)
    nb = nb_labels_sample or 3
    for _ in range(3):
        (ri, ro), (oi, oo) = next(ref), next(ours)
        assert len(oi) == len(ri) == (6 if surf_bidir else 4) and len(oo) == len(ro)
        for a, b in zip(oi + oo, ri + ro):
            assert a.shape == b.shape and a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
        assert oi[2].shape == (1, *SHAPE, nb) and oi[-1].shape == (1, NPTS, 4)
        assert set(np.unique(oi[-1][0, :, -1].numpy())) <= set(range(nb))


def _inputs(seed=1):
    """A batch of the generator's layout (surf_bidir) from random blobs."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE],
                             indexing="ij"), -1)
    vols = [np.exp(-((g - 8 - rng.uniform(-2, 2, 3)) ** 2).sum(-1) / 18)[None, ..., None]
            for _ in range(2)]
    dts = [rng.normal(size=(1, *SHAPE, 2)).astype(np.float32) * 3 for _ in range(2)]
    pts = []
    for _ in range(2):
        p = rng.uniform(2, 13, size=(1, NPTS, 4)).astype(np.float32)
        p[..., -1] = rng.integers(0, 2, NPTS)
        pts.append(p)
    inputs = (vols[0].astype(np.float32), vols[1].astype(np.float32), dts[0], dts[1], *pts)
    zero_pts = np.zeros((1, NPTS, 1), np.float32)
    targets = (inputs[1], inputs[0], np.zeros((1, *SHAPE, 3), np.float32), zero_pts, zero_pts)
    return inputs, targets


CFG = dict(inshape=SHAPE, nb_surface_points=NPTS, nb_labels_sample=2,
           nb_unet_features=[[4, 8], [8, 4]], int_steps=7, int_resolution=2)


def _jax_params(cfg=CFG):
    inputs, _ = _inputs()
    params = jax.device_get(dict(JaxPC(**cfg).init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs))["params"]))
    vxm = dict(params["vxm"])
    vxm["flow"] = dict(vxm["flow"], kernel=np.random.default_rng(3).normal(
        0.0, 0.3, vxm["flow"]["kernel"].shape).astype(np.float32))
    params["vxm"] = vxm
    return params


def _torch_model(cfg=CFG, params=None):
    model = VxmDenseSemiSupervisedPointCloud(**cfg)
    if params is not None:
        model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return model


def _terms(mod, term_cls):
    return [term_cls("y_source", mod.MSE().loss, weight=0.5, target_index=0),
            term_cls("y_target", mod.MSE().loss, weight=0.5, target_index=1),
            term_cls("reg", mod.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=2,
                     name="grad"),
            term_cls("subj_dt_value", mod.MSE().loss, weight=0.25, target_index=3,
                     name="subj_dt"),
            term_cls("atl_dt_value", mod.MSE().loss, weight=0.25, target_index=4,
                     name="atl_dt")]


KEYS = ["y_source", "y_target", "pos_flow", "neg_flow", "warped_atl_surface", "subj_dt_value",
        "warped_subj_surface", "atl_dt_value"]


def test_forward_matches_jax():
    params = _jax_params()
    inputs, _ = _inputs(2)
    ref = JaxPC(**CFG).apply({"params": params}, *map(jnp.asarray, inputs))
    model = _torch_model(CFG, params).train()
    with torch.no_grad():
        out = model(*map(torch.from_numpy, inputs))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in KEYS:
        assert out[key].shape == ref[key].shape, key
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    assert out["subj_dt_value"].shape == (1, NPTS, 1)


def test_forward_without_surf_bidir_takes_the_generators_four_inputs():
    cfg = dict(CFG, surf_bidir=False)
    params = _jax_params()
    inputs, _ = _inputs(2)
    src, trg, subj_dt, _, _, atlas_pts = inputs
    ref = JaxPC(**cfg).apply({"params": params}, *map(jnp.asarray, (src, trg, subj_dt)),
                             atlas_surface=jnp.asarray(atlas_pts))
    with torch.no_grad():
        out = _torch_model(cfg, params)(*map(torch.from_numpy, (src, trg, subj_dt, atlas_pts)))
    assert "atl_dt_value" not in out and "atl_dt_value" not in ref
    assert_rel_close(out["subj_dt_value"].numpy(), np.asarray(ref["subj_dt_value"]), OUT_RTOL,
                     "subj_dt_value")


def test_train_steps_match_jax():
    """One step's loss, then the params after 3 Adam steps, against the JAX
    package's loss and train step."""
    import optax
    params = _jax_params()
    inputs, targets = _inputs(3)
    jm = JaxPC(**CFG)
    loss_fn = jax_training.make_loss_fn(jm, _terms(jax_losses, jax_training.LossTerm))
    ref_loss, _ = jax.jit(loss_fn)(params, {}, inputs, targets, jax.random.PRNGKey(0))
    tx = optax.adam(LR)
    step = jax_training.make_train_step(jm, _terms(jax_losses, jax_training.LossTerm), tx,
                                        donate=False)
    ref_params, opt_state = params, tx.init(params)
    for i in range(3):
        ref_params, _, opt_state, _ = step(ref_params, {}, opt_state, jax.random.PRNGKey(0),
                                           np.asarray(i, np.int32), inputs, targets)

    model = _torch_model(CFG, params)
    trainer = Trainer(model, _terms(losses, LossTerm), lr=LR, device="cpu")
    model.train()
    loss, metrics = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                                    tuple(map(torch.from_numpy, targets)))
    assert loss.item() == pytest.approx(float(ref_loss), rel=OUT_RTOL)
    assert metrics["subj_dt"].item() > 0.5 and metrics["atl_dt"].item() > 0.5
    for _ in range(3):
        trainer.train_step(inputs, targets)
    ours = modelio.params_to_jax(model.state_dict())
    start, ref_params = flatten(params), flatten(ref_params)
    assert sorted(ours) == sorted(ref_params) and all(k.startswith("vxm||") for k in ours)
    for name in ref_params:
        assert_rel_close(ours[name] - start[name], ref_params[name] - start[name], ADAM_RTOL,
                         name)


def test_checkpoints_load_in_both_packages_and_register(tmp_path):
    params = _jax_params()
    inputs, targets = _inputs(4)
    trainer = Trainer(_torch_model(CFG, params), _terms(losses, LossTerm), lr=LR, device="cpu")
    trainer.train_step(inputs, targets)
    trainer.save(str(tmp_path / "port.npz"))
    jm, jp = jax_load_model(str(tmp_path / "port.npz"))
    assert type(jm).__name__ == "VxmDenseSemiSupervisedPointCloud" and jm.nb_surface_points == NPTS
    jnet, jvxm = jax_registration_model(jm, jp)
    src, trg = inputs[:2]
    ref = jnet.apply({"params": jvxm}, jnp.asarray(src), jnp.asarray(trg), train=False)
    net, state = registration_model(trainer.model)
    assert type(net) is VxmDense and net.bidir
    assert sorted(state) == sorted(k[len("vxm."):] for k in trainer.model.state_dict())
    assert resolve_registration_model(trainer.model) is net
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(src), torch.from_numpy(trg))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "pos_flow"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)

    jax_save_model(str(tmp_path / "jax.npz"), JaxPC(**CFG), params)
    model = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(model, VxmDenseSemiSupervisedPointCloud) and not model.training
    assert model.config == _torch_model().config
    ref = JaxPC(**CFG).apply({"params": params}, *map(jnp.asarray, inputs), train=False)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, inputs))
    for key in KEYS:
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)


def test_cli_trains_and_the_loss_falls(tmp_path, capsys, monkeypatch):
    """The CLI's run, its generator's draws seeded so that the run is
    deterministic."""
    monkeypatch.setattr(generators, "surf_semisupervised", functools.partial(
        generators.surf_semisupervised, rng=np.random.default_rng(0)))
    scans, atlas = _files(tmp_path)
    (tmp_path / "list.txt").write_text("\n".join(scans) + "\n")
    pc_cli.main(["--img-list", str(tmp_path / "list.txt"), "--atlas", atlas,
                 "--model-dir", str(tmp_path / "models"), "--epochs", "2",
                 "--steps-per-epoch", "4", "--int-steps", "2", "--enc", "4", "8", "--dec", "8",
                 "4", "--lr", "3e-3", "--surf-bidir", "--surf-points", str(NPTS),
                 "--num-labels", "2", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
    loss = [float(ln.split("loss: ")[1].split()[0]) for ln in lines]
    assert len(loss) == 2 and loss[1] < loss[0], lines
    model = modelio.load_model(str(tmp_path / "models" / "0002.npz"), device="cpu")
    assert isinstance(model, VxmDenseSemiSupervisedPointCloud)
    assert model.nb_labels_sample == 2 and model.surf_bidir
