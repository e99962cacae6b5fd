"""The port's atlas CLIs against the JAX package's scripts on the CPU:
cli/train_template, train_cond_template and train_unsupervised_seg, each
resumed from the same JAX checkpoint for the same steps on a one-scan list
(so that both draw the same batches), and cli/test_unsupervised_seg on the
same checkpoint, atlas and image.

Volumes are 16^3 with narrow features; the checkpoints' flow heads are
redrawn as N(0, 0.3), for flows of voxels. Tolerances as in
``tests/test_torch_semisupervised.py``: 2e-3 of the largest change on the
params and MeanStream's state after two Adam steps, 1e-5 on inference
outputs; the segmentation is equal.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import ConditionalTemplateCreation as JaxCond
from voxelmorph_tpu.models import ProbAtlasSegmentation as JaxProb
from voxelmorph_tpu.models import TemplateCreation as JaxTemplate
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu_torch.cli import test_unsupervised_seg as test_seg_cli
from voxelmorph_tpu_torch.cli import train_cond_template as cond_cli
from voxelmorph_tpu_torch.cli import train_template as template_cli
from voxelmorph_tpu_torch.cli import train_unsupervised_seg as seg_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.py.utils import load_volfile

SHAPE = (16, 16, 16)
FEATS = [[4, 8], [8, 4]]
ADAM_RTOL = 2e-3
OUT_RTOL = 1e-5
MIN_FLOW = 0.5  # voxels
SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
# the CLIs' small-network flags
NET = ["--enc", "4", "8", "--dec", "8", "4", "--epochs", "1", "--steps-per-epoch", "2"]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _image(seed):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE],
                             indexing="ij"), -1)
    c = 8 + rng.uniform(-2.5, 2.5, size=3)
    blob = np.exp(-((g - c) ** 2).sum(-1) / 18)
    return (0.8 * blob + 0.2 * rng.uniform(size=SHAPE)).astype(np.float32)


def _prob_atlas(labels, seed=12):
    """A smooth probabilistic atlas ``(*SHAPE, labels)``."""
    logits = np.random.default_rng(seed).normal(size=(4, 4, 4, labels)) * 3
    up = logits.repeat(4, 0).repeat(4, 1).repeat(4, 2)
    p = np.exp(up - up.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _redraw_flow(params):
    params = dict(params)
    vxm = dict(params["vxm"])
    vxm["flow"] = dict(vxm["flow"], kernel=np.random.default_rng(3).normal(
        0.0, 0.3, vxm["flow"]["kernel"].shape).astype(np.float32))
    params["vxm"] = vxm
    return params


def _one_scan(tmp_path):
    """A one-scan list (every draw picks it), its background zeroed."""
    vol = _image(1)
    vol[:2] = 0
    np.savez(tmp_path / "scan0.npz", vol=vol)
    (tmp_path / "list.txt").write_text(str(tmp_path / "scan0.npz") + "\n")
    return str(tmp_path / "list.txt")


def _jax_start(tmp_path, jm, terms, sample, params_fn):
    """A JAX Trainer checkpoint at step 0 with the stream state (if the
    model has one) and ``params_fn`` applied to its init params."""
    jt = jax_training.Trainer(jm, terms, lr=1e-4)
    jt.init(sample)
    jt.init(None, params=jax.tree_util.tree_map(
        jnp.asarray, params_fn(jax.device_get(jt.params))))
    path = str(tmp_path / "start.npz")
    jt.save(path)
    return path


def _compare_runs(start, jax_dir, port_dir):
    """The params and state of the two runs' last checkpoints, each change
    from ``start`` within ADAM_RTOL of the largest change."""
    _, _, flat0, extra0 = modelio.read_checkpoint(start, with_extra=True)
    _, _, jflat, jextra = modelio.read_checkpoint(os.path.join(jax_dir, "0001.npz"),
                                                  with_extra=True)
    _, _, pflat, pextra = modelio.read_checkpoint(os.path.join(port_dir, "0001.npz"),
                                                  with_extra=True)
    assert sorted(pflat) == sorted(jflat)
    for key in jflat:
        assert_rel_close(pflat[key] - flat0[key], jflat[key] - flat0[key], ADAM_RTOL, key)
    states = [modelio.checkpoint_state(e) for e in (extra0, jextra, pextra)]
    assert sorted(states[2]) == sorted(states[1])
    for key in states[1]:
        assert_rel_close(states[2][key] - states[0][key], states[1][key] - states[0][key],
                         ADAM_RTOL, key)
    assert int(pextra["train||step"]) == int(jextra["train||step"]) == 2
    return states[2]


def test_train_template_matches_the_jax_script(tmp_path):
    img_list = _one_scan(tmp_path)
    np.savez(tmp_path / "init.npz", vol=_image(5))
    jm = JaxTemplate(inshape=SHAPE, nb_unet_features=FEATS)
    terms = [jax_training.LossTerm("y_source", jax_losses.NCC().loss)]
    start = _jax_start(tmp_path, jm, terms, (_image(1)[None, ..., None],),
                       lambda p: _redraw_flow(dict(p, atlas=_image(5)[None, ..., None])))
    common = ["--img-list", img_list, *NET, "--load-weights", start,
              "--image-loss-weight", "0.7"]
    _script("train_template").main([*common, "--model-dir", str(tmp_path / "jax")])
    trainer = template_cli.main([*common, "--model-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    state = _compare_runs(start, str(tmp_path / "jax"), str(tmp_path / "port"))
    assert state["stream||mean_stream||count"] == 2
    assert trainer.model.mean_stream.count.item() == 2

    # --init-template seeds the atlas on a fresh start, and not on a resume
    fresh = template_cli.main(["--img-list", img_list, *NET[:6], "--epochs", "0",
                               "--init-template", str(tmp_path / "init.npz"),
                               "--model-dir", str(tmp_path / "fresh"), "--device", "cpu"])
    np.testing.assert_array_equal(fresh.model.get_atlas(), _image(5))
    resumed = template_cli.main([*common, "--init-template", str(tmp_path / "scan0.npz"),
                                 "--model-dir", str(tmp_path / "resumed"), "--device", "cpu"])
    assert np.abs(resumed.model.get_atlas() - _image(5)).max() < 0.01


def test_train_cond_template_matches_the_jax_script(tmp_path):
    img_list = _one_scan(tmp_path)
    (tmp_path / "pheno.csv").write_text("file,age,sex,site\nscan0.npz,0.6,1.0,-0.4\n")
    np.savez(tmp_path / "atlas.npz", vol=_image(6))
    jm = JaxCond(inshape=SHAPE, pheno_input_shape=(3,), nb_unet_features=FEATS,
                 conv_nb_features=4, extra_conv_layers=3)
    sample = (np.asarray([[0.6, 1.0, -0.4]], np.float32), _image(6)[None, ..., None],
              _image(1)[None, ..., None])
    terms = [jax_training.LossTerm("y_source", jax_losses.NCC().loss)]
    start = _jax_start(tmp_path, jm, terms, sample, _redraw_flow)
    common = ["--img-list", img_list, "--pheno-csv", str(tmp_path / "pheno.csv"),
              "--atlas", str(tmp_path / "atlas.npz"), *NET, "--load-weights", start]
    _script("train_cond_template").main([*common, "--model-dir", str(tmp_path / "jax")])
    trainer = cond_cli.main([*common, "--model-dir", str(tmp_path / "port"), "--device", "cpu"])
    state = _compare_runs(start, str(tmp_path / "jax"), str(tmp_path / "port"))
    assert state["stream||mean_stream||count"] == 2
    assert trainer.model.pheno_dense.weight.shape == (int(np.prod(SHAPE)) * 4, 3)


@pytest.fixture
def prob_checkpoint(tmp_path):
    """A JAX ProbAtlasSegmentation checkpoint of 3 labels (stat post warp),
    its atlas npz and a one-scan list."""
    atlas = _prob_atlas(3)
    np.savez(tmp_path / "atlas.npz", vol=atlas)
    jm = JaxProb(inshape=SHAPE, nb_labels=3, nb_unet_features=FEATS, stat_post_warp=True)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 1)),
                                             jnp.asarray(atlas[None]))["params"])
    params = _redraw_flow(dict(params))
    rng = np.random.default_rng(15)
    for name in ("mu_vol", "logsigmasq_vol"):
        params[name] = {k: rng.normal(0.0, 0.1, v.shape).astype(np.float32)
                        for k, v in params[name].items()}
    path = str(tmp_path / "prob.npz")
    jax_save_model(path, jm, params)
    return path, str(tmp_path / "atlas.npz"), _one_scan(tmp_path)


def test_train_unsupervised_seg_matches_the_jax_script(tmp_path, prob_checkpoint):
    start, atlas, img_list = prob_checkpoint
    common = ["--img-list", img_list, "--atlas", atlas, *NET, "--load-weights", start]
    _script("train_unsupervised_seg").main([*common, "--model-dir", str(tmp_path / "jax")])
    seg_cli.main([*common, "--model-dir", str(tmp_path / "port"), "--device", "cpu"])
    # the checkpoint of save_model has no optimizer state; both start Adam
    _, _, flat0 = modelio.read_checkpoint(start)
    _, _, jflat = modelio.read_checkpoint(str(tmp_path / "jax" / "0001.npz"))
    _, _, pflat = modelio.read_checkpoint(str(tmp_path / "port" / "0001.npz"))
    assert sorted(pflat) == sorted(jflat)
    for key in jflat:
        assert_rel_close(pflat[key] - flat0[key], jflat[key] - flat0[key], ADAM_RTOL, key)


def test_test_unsupervised_seg_matches_the_jax_script(tmp_path, prob_checkpoint):
    """A 7-label full atlas mapped onto the 3 classes, 2 labels a chunk."""
    model, atlas, _ = prob_checkpoint
    full = _prob_atlas(7, seed=16)
    np.savez(tmp_path / "full.npz", vol=full)
    np.save(tmp_path / "mapping.npy", np.array([0, 1, 2, 1, 0, 2, 2]))
    np.savez(tmp_path / "image.npz", vol=_image(17))
    outputs = ("seg", "warped_atlas", "posteriors", "warp")

    def args(prefix):
        out = [str(tmp_path / "image.npz"), str(tmp_path / f"{prefix}seg.nii.gz"),
               "--model", model, "--atlas", atlas, "--atlas-full", str(tmp_path / "full.npz"),
               "--mapping", str(tmp_path / "mapping.npy"), "--max-feats", "2",
               "--stats", str(tmp_path / f"{prefix}stats.npz")]
        for name in outputs[1:]:
            out += [f"--{name.replace('_', '-')}", str(tmp_path / f"{prefix}{name}.nii.gz")]
        return out

    _script("test_unsupervised_seg").main(args("jax_"))
    seg = test_seg_cli.main([*args("port_"), "--device", "cpu"])
    ref = {name: load_volfile(str(tmp_path / f"jax_{name}.nii.gz")) for name in outputs}
    ours = {name: load_volfile(str(tmp_path / f"port_{name}.nii.gz")) for name in outputs}
    assert np.abs(ref["warp"]).max() >= MIN_FLOW
    assert len(np.unique(ref["seg"])) >= 4  # labels of every class
    np.testing.assert_array_equal(seg, ref["seg"])
    np.testing.assert_array_equal(ours["seg"], ref["seg"])
    assert ours["posteriors"].shape == ref["posteriors"].shape == (*SHAPE, 7)
    for name in outputs[1:]:
        assert_rel_close(ours[name], ref[name], OUT_RTOL, name)
    with np.load(tmp_path / "jax_stats.npz") as a, np.load(tmp_path / "port_stats.npz") as b:
        for key in ("means", "log_variances"):
            assert_rel_close(b[key], a[key], OUT_RTOL, key)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            test_seg_cli.main(args("gpu_"))
