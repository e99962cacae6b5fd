"""The port's InstanceDense, Transform and cli/train_instance against the
JAX package on the CPU.

At 16^3 the flow parameter is set to a smooth random field of up to about
two voxels (after ``mult``), so every compared flow is at least half a
voxel. Tolerances, each relative to the largest magnitude of the compared
tensor, as in ``tests/test_torch_semisupervised.py``: 1e-5 on outputs, 1e-4
on one step's loss and gradient, 2e-3 on the change of the flow over 3 Adam
steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import InstanceDense as JaxInstance
from voxelmorph_tpu.models import Transform as JaxTransform
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.cli import train_instance as instance_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import InstanceDense, Transform
from voxelmorph_tpu_torch.py.utils import load_volfile
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPE = (16, 16, 16)
HALF = (8, 8, 8)
MULT = 1000.0
LR = 1e-3
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-3
MIN_FLOW = 0.5  # voxels


def _image(seed):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE],
                             indexing="ij"), -1)
    c = 8 + rng.uniform(-2.5, 2.5, size=3)
    blob = np.exp(-((g - c) ** 2).sum(-1) / 18)
    return (0.8 * blob + 0.2 * rng.uniform(size=SHAPE)).astype(np.float32)[None, ..., None]


def _flow_param(shape, seed=4, voxels=2.0):
    """A smooth field of up to ``voxels``, as the stored (divided by MULT)
    parameter ``(1, *shape, 3)``."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, size=(2, 2, 2, 3))
    reps = [s // 2 for s in shape]
    field = coarse.repeat(reps[0], 0).repeat(reps[1], 1).repeat(reps[2], 2)
    field = field + 0.2 * rng.uniform(-1, 1, size=(*shape, 3))
    return (voxels / np.abs(field).max() * field / MULT).astype(np.float32)[None]


def _models(int_steps=7, int_resolution=2):
    cfg = dict(inshape=SHAPE, int_steps=int_steps, int_resolution=int_resolution, mult=MULT)
    grid = HALF if int_resolution == 2 else SHAPE
    params = {"flow": _flow_param(grid)}
    model = InstanceDense(**cfg)
    modelio.load_weights(model, flatten(params))
    return JaxInstance(**cfg), params, model, cfg


@pytest.mark.parametrize("int_steps", [7, 0])
def test_forward_matches_jax(int_steps):
    """The forward; with int_steps=0 at int_resolution=2 JAX samples the
    moved image on the flow's half-resolution grid, and so does the port."""
    jm, params, model, _ = _models(int_steps)
    src = _image(1)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(src))
    with torch.no_grad():
        out = model(torch.from_numpy(src))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "pos_flow", "preint_flow", "reg"):
        assert out[key].shape == ref[key].shape, key
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    if int_steps == 0:
        assert out["y_source"].shape == (1, *HALF, 1)
    else:
        assert out["y_source"].shape == (1, *SHAPE, 1)
    # the parameter's init, as flax draws it
    fresh = InstanceDense(SHAPE, generator=torch.Generator().manual_seed(0))
    assert fresh.flow.shape == (1, *HALF, 3) and 0.5e-5 < fresh.flow.std().item() < 2e-5
    np.testing.assert_allclose(InstanceDense.flow_from_warp(np.ones(3), MULT),
                               JaxInstance.flow_from_warp(np.ones(3), MULT))


def _terms(pkg_losses, term_cls):
    return [term_cls("y_source", pkg_losses.MSE().loss, weight=1.0, target_index=0),
            term_cls("reg", pkg_losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                     target_index=1, name="grad")]


def test_train_steps_and_checkpoints_match_jax(tmp_path):
    """One step's loss and the flow's gradient, 3 Adam steps, and a
    checkpoint of each package loading in the other."""
    import optax
    jm, params, model, cfg = _models()
    inputs = (_image(2),)
    targets = (_image(3), np.zeros((1, *SHAPE, 3), np.float32))
    terms = _terms(jax_losses, jax_training.LossTerm)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        jax_training.make_loss_fn(jm, terms), has_aux=True))(
        params, {}, inputs, targets, jax.random.PRNGKey(0))
    tx = optax.adam(LR)
    step = jax_training.make_train_step(jm, terms, tx, donate=False)
    ref_params, opt_state = params, tx.init(params)
    for i in range(3):
        ref_params, _, opt_state, _ = step(ref_params, {}, opt_state, jax.random.PRNGKey(0),
                                           np.asarray(i, np.int32), inputs, targets)

    trainer = Trainer(model, _terms(losses, LossTerm), lr=LR, device="cpu")
    model.train()
    loss, _ = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                              tuple(map(torch.from_numpy, targets)))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    assert_rel_close(model.flow.grad.numpy(), np.asarray(ref_grads["flow"]), GRAD_RTOL, "flow")
    model.flow.grad = None
    for _ in range(3):
        trainer.train_step(inputs, targets)
    assert_rel_close(model.flow.detach().numpy() - params["flow"],
                     np.asarray(ref_params["flow"]) - params["flow"], ADAM_RTOL, "flow")

    # port -> JAX, and JAX -> port, the flow parameter as it is
    trainer.save(str(tmp_path / "port.npz"))
    jm2, jp2 = jax_load_model(str(tmp_path / "port.npz"))
    assert type(jm2).__name__ == "InstanceDense" and jm2.mult == MULT
    np.testing.assert_array_equal(np.asarray(jp2["flow"]), model.flow.detach().numpy())
    jax_save_model(str(tmp_path / "jax.npz"), jm, ref_params)
    loaded = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(loaded, InstanceDense) and loaded.config == InstanceDense(**cfg).config
    ref = jax.jit(jm.apply)({"params": ref_params}, jnp.asarray(inputs[0]))
    with torch.no_grad():
        out = loaded(torch.from_numpy(inputs[0]))
    assert_rel_close(out["y_source"].numpy(), np.asarray(ref["y_source"]), OUT_RTOL, "y_source")


@pytest.mark.parametrize("case", ["dense", "dense, rescaled", "affine", "affine, rescaled",
                                  "nearest, fill"])
def test_transform_matches_jax(case):
    rng = np.random.default_rng(5)
    img = np.concatenate([_image(6), _image(7)])
    kw = {}
    if "affine" in case:
        trf = np.stack([np.eye(3, 4) + rng.uniform(-0.08, 0.08, size=(3, 4)) for _ in range(2)])
        trf[:, :, 3] = rng.uniform(-2, 2, size=(2, 3))
        trf = trf.astype(np.float32)
    else:
        grid = HALF if "rescaled" in case else SHAPE
        trf = np.concatenate([_flow_param(grid, seed=8) * MULT, _flow_param(grid, seed=9) * MULT])
    if "rescaled" in case:
        kw["rescale"] = 2.0
    if case == "nearest, fill":
        kw.update(interp_method="nearest", fill_value=0.25)
    ref = JaxTransform(**kw).apply({}, jnp.asarray(img), jnp.asarray(trf))
    out = Transform(**kw)(torch.from_numpy(img), torch.from_numpy(trf))
    assert out.shape == ref.shape == img.shape
    assert np.abs(np.asarray(ref) - img).max() > 0.05  # the transform moved the images
    assert_rel_close(out.numpy(), np.asarray(ref), OUT_RTOL, case)


def test_cli_matches_the_jax_script(tmp_path, capsys):
    """cli/train_instance warm-started from a VxmDense checkpoint against
    scripts/train_instance.py on the same files: the change 3 steps make to
    the warm start's moved image and warp. (At the default learning rate an
    Adam step moves each flow component by about a voxel, mult x lr, and
    the field grows rough enough that the squarings amplify the order of
    sums; 1e-4 keeps it smooth.)"""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "jax_train_instance", os.path.join(os.path.dirname(__file__), "..", "scripts",
                                           "train_instance.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)

    np.savez(tmp_path / "mv.npz", vol=_image(10)[0, ..., 0])
    np.savez(tmp_path / "fx.npz", vol=_image(11)[0, ..., 0])
    vxm = JaxVxmDense(inshape=SHAPE, nb_unet_features=[[4, 8], [8, 4]], int_steps=7)
    vparams = jax.device_get(jax.jit(vxm.init)(jax.random.PRNGKey(0),
                                               jnp.zeros((1, *SHAPE, 1)),
                                               jnp.zeros((1, *SHAPE, 1)))["params"])
    vparams = dict(vparams, flow=dict(vparams["flow"], kernel=np.random.default_rng(3).normal(
        0.0, 0.3, vparams["flow"]["kernel"].shape).astype(np.float32)))
    jax_save_model(str(tmp_path / "vxm.npz"), vxm, vparams)
    common = ["--moving", str(tmp_path / "mv.npz"), "--fixed", str(tmp_path / "fx.npz"),
              "--model", str(tmp_path / "vxm.npz"), "--lr", "1e-4"]
    jax_script.main([*common, "--steps", "3", "--moved", str(tmp_path / "jax_moved.nii.gz"),
                     "--warp", str(tmp_path / "jax_warp.nii.gz")])
    runs = {}
    for steps in (0, 3):
        runs[steps] = instance_cli.main([*common, "--steps", str(steps), "--moved",
                                         str(tmp_path / f"moved{steps}.nii.gz"), "--warp",
                                         str(tmp_path / f"warp{steps}.nii.gz"), "--device", "cpu"])
    assert runs[0] == [] and len(runs[3]) == 3 and runs[3][-1] < runs[3][0]
    ref_warp = load_volfile(str(tmp_path / "jax_warp.nii.gz"))
    assert ref_warp.shape == (*SHAPE, 3) and np.abs(ref_warp).max() >= MIN_FLOW
    # the warm start alone, then the change the three steps make
    start = {name: load_volfile(str(tmp_path / f"{name}0.nii.gz")) for name in ("warp", "moved")}
    for name, ref in (("warp", ref_warp),
                      ("moved", load_volfile(str(tmp_path / "jax_moved.nii.gz")))):
        ours = load_volfile(str(tmp_path / f"{name}3.nii.gz"))
        assert_rel_close(ours - start[name], ref - start[name], ADAM_RTOL, name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            instance_cli.main([*common, "--moved", str(tmp_path / "m.nii.gz")])
