"""The port's VxmDense in 1, 2 and 3 dimensions, with the U-Net's ``do_res``
and ``final_activation_function``, against the JAX package on the CPU; its
bfloat16 train step against JAX's; and a 2-D run of the training CLI.

The JAX VxmDense builds its U-Net with the defaults; the cases with a
residual or a final activation build it with those fields set (the JAX
``Unet``'s own), as the port's VxmDense does with its ``do_res`` and
``final_activation_function``. Flow heads are redrawn (N(0, 0.3) in 3-D),
for flows of about a voxel. Tolerances, each relative to the largest magnitude
of the compared tensor, as in ``tests/test_torch_train.py``: 1e-5 on the
U-Net's output, 1e-4 on the model's outputs and on one step's loss and
gradients. Inputs of the U-Net are rounded to halves, so that the max pool
meets ties (its backward splits them in every dimensionality).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models import vxm as jax_vxm
from voxelmorph_tpu.models.unet import Unet as JaxUnet
from voxelmorph_tpu.ops import pallas_conv
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import train as train_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.unet import Unet
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops import conv3
from voxelmorph_tpu_torch.py.utils import load_volfile
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPES = {1: (24,), 2: (16, 12), 3: (8, 8, 8)}
UNET_RTOL = 1e-5
RTOL = 1e-4
MIN_FLOW = 0.5  # voxels
# U-Net features with final convs ([8] past the decoder's 2) and without
WITH_FINAL = [[4, 8], [8, 8, 8]]
NO_FINAL = [[4, 8], [8, 6]]


def _unet_case(ndims, seed=0, ch=2):
    rng = np.random.default_rng(seed)
    x = np.round(2 * rng.normal(size=(2, *SHAPES[ndims], ch))) / 2
    return x.astype(np.float32)


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("do_res, act, features", [
    (True, None, WITH_FINAL), (False, "tanh", NO_FINAL), (True, "sigmoid", WITH_FINAL),
    (True, "tanh", NO_FINAL)], ids=["res", "tanh-no_final", "res-sigmoid", "res-tanh-no_final"])
def test_unet_matches_jax(ndims, do_res, act, features):
    """Forward and the gradients of every param and of the input."""
    _check_unet(ndims, do_res, act, features, UNET_RTOL)


def _check_unet(ndims, do_res, act, features, out_rtol):
    x = _unet_case(ndims)
    jm = JaxUnet(ndims=ndims, nb_features=features, do_res=do_res,
                 final_activation_function=act)
    params = jm.init(jax.random.PRNGKey(ndims), jnp.asarray(x))["params"]
    w = np.random.default_rng(1).normal(size=jm.apply({"params": params},
                                                      jnp.asarray(x)).shape).astype(np.float32)

    def jloss(p, xx):
        return (jm.apply({"params": p}, xx) * w).sum()

    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    ref_gp, ref_gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))

    model = Unet(ndims, 2, nb_features=features, do_res=do_res, final_activation_function=act)
    state = modelio.params_from_jax(flatten(jax.device_get(params)))
    assert sorted(state) == sorted(model.state_dict())
    assert any(k.endswith("resfix.weight") for k in state) == do_res
    model.load_state_dict(state)
    xt = torch.from_numpy(x).movedim(-1, 1).requires_grad_()
    out = model(xt).movedim(1, -1)
    assert_rel_close(out.detach().numpy(), ref, out_rtol, "unet")
    (out * torch.from_numpy(w)).sum().backward()
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    for name, g in flatten(jax.device_get(ref_gp)).items():
        assert_rel_close(grads[name], g, RTOL, name)
    assert_rel_close(xt.grad.movedim(1, -1).numpy(), np.asarray(ref_gx), RTOL, "d input")


@pytest.mark.parametrize("switch", ["VXM_PALLAS_CONV", "VXM_XLA_DW_EINSUM"])
def test_residual_unet_under_the_conv_switches_matches_jax(monkeypatch, switch):
    """A 3-D do_res U-Net with a final activation, its blocks on the conv
    kernel's path (the JAX side through the Pallas interpreter) or the
    lean-dw convolution, in both packages: every block runs the conv with
    the activation off, then adds the residual and activates outside it.
    The output within 1e-4 of its largest magnitude, as the model-level
    tests of the switches hold it: both paths sum each conv in their own
    order (the kernel's plain version by im2col, the lean-dw path's by
    shifted products)."""
    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)
    monkeypatch.setenv(switch, "1")
    slopes = []
    name = "conv3_same_cf" if switch == "VXM_PALLAS_CONV" else "conv3_same_lean_dw"

    def spy(*args, _fn=getattr(conv3, name), **kw):
        slopes.append(kw.get("act_slope", args[3] if len(args) > 3 else None))
        return _fn(*args, **kw)

    monkeypatch.setattr(conv3, name, spy)
    _check_unet(3, True, "tanh", WITH_FINAL, RTOL)
    assert slopes == [None] * 5


def test_unknown_final_activation_raises():
    with pytest.raises(ValueError, match="final_activation_function"):
        Unet(2, 2, nb_features=NO_FINAL, final_activation_function="no_such")


def _pair(ndims, seed=1):
    rng = np.random.default_rng(seed)
    shape = SHAPES[ndims]
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij"), -1)
    src, trg = (np.exp(-((g - np.asarray(shape) / 2 - rng.uniform(-2, 2, ndims)) ** 2)
                       .sum(-1) / 18).astype(np.float32)[None, ..., None] for _ in range(2))
    return src, trg


def _jax_model(monkeypatch, unet_kw, **cfg):
    """The JAX VxmDense, its U-Net built with ``unet_kw`` set."""
    if unet_kw:
        monkeypatch.setattr(jax_vxm, "Unet", functools.partial(JaxUnet, **unet_kw))
    return JaxVxmDense(**cfg)


def _models(monkeypatch, ndims, unet_kw, dtype=jnp.float32):
    cfg = dict(inshape=SHAPES[ndims], nb_unet_features=[[4, 8], [8, 8, 4]], int_steps=5,
               int_resolution=2)
    src, trg = _pair(ndims)
    jm = _jax_model(monkeypatch, unet_kw, dtype=dtype, **cfg)
    params = dict(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(src),
                                         jnp.asarray(trg))["params"]))
    # N(0, 0.3) in 3-D, wider for the smaller fan-in of fewer dimensions
    std = 0.3 * 3 ** ((3 - ndims) / 2)
    params["flow"] = dict(params["flow"], kernel=np.random.default_rng(3).normal(
        0.0, std, params["flow"]["kernel"].shape).astype(np.float32))
    model = VxmDense(**cfg, **unet_kw, dtype={jnp.float32: torch.float32,
                                                jnp.bfloat16: torch.bfloat16}[dtype])
    model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return jm, params, model


def _terms(L, Term):
    return [Term("y_source", L.MSE(1.0).loss, weight=1.0, target_index=0),
            Term("reg", L.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=1,
                 name="grad")]


VARIANTS = {"plain": {}, "res_tanh": dict(do_res=True, final_activation_function="tanh")}


@pytest.mark.parametrize("ndims, variant", [(1, "plain"), (2, "plain"), (1, "res_tanh"),
                                            (2, "res_tanh"), (3, "res_tanh")])
def test_vxm_dense_forward_and_step_match_jax(monkeypatch, ndims, variant):
    jm, params, model = _models(monkeypatch, ndims, VARIANTS[variant])
    src, trg = _pair(ndims)
    ref = jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(trg))
    with torch.no_grad():
        out = model.train()(torch.from_numpy(src), torch.from_numpy(trg))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "preint_flow", "pos_flow"):
        assert out[key].shape == ref[key].shape
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), RTOL, key)

    zero = np.zeros((1, *SHAPES[ndims], ndims), np.float32)
    inputs, targets = (src, trg), (trg, zero)
    loss_fn = jax_training.make_loss_fn(jm, _terms(jax_losses, jax_training.LossTerm))
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {}, inputs, targets, jax.random.PRNGKey(0))
    trainer = Trainer(model, _terms(losses, LossTerm), lr=1e-4, device="cpu")
    loss, _ = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                              tuple(map(torch.from_numpy, targets)))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    for name, g in flatten(jax.device_get(ref_grads)).items():
        assert_rel_close(grads[name], g, RTOL, name)


def test_checkpoints_of_nd_models_load_both_ways(tmp_path, monkeypatch):
    """A 2-D VxmDense across the packages; a do_res model's config names its
    U-Net fields and reloads in the port."""
    jm, params, model = _models(monkeypatch, 2, {})
    src, trg = _pair(2)
    jax_save_model(str(tmp_path / "jax.npz"), jm, params)
    loaded = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert loaded.inshape == SHAPES[2] and loaded.flow.weight.dim() == 4
    modelio.save_model(str(tmp_path / "port.npz"), loaded)
    jm2, jp2 = jax_load_model(str(tmp_path / "port.npz"))
    ref = jm2.apply({"params": jp2}, jnp.asarray(src), jnp.asarray(trg), train=False)
    with torch.no_grad():
        out = loaded(torch.from_numpy(src), torch.from_numpy(trg))
    for key in ("y_source", "pos_flow"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), RTOL, key)

    _, _, res = _models(monkeypatch, 3, VARIANTS["res_tanh"])
    modelio.save_model(str(tmp_path / "res.npz"), res)
    back = modelio.load_model(str(tmp_path / "res.npz"), device="cpu")
    assert back.config == res.config and back.config["do_res"]
    assert back.config["final_activation_function"] == "tanh"
    for name, p in res.state_dict().items():
        assert torch.equal(back.state_dict()[name], p), name
    assert "do_res" not in VxmDense(SHAPES[3]).config


def test_bfloat16_train_step_matches_jax(monkeypatch):
    """One bfloat16 step (U-Net in bfloat16, flows and losses in float32) at
    16^3 against JAX's bfloat16 step, with every limit a multiple of how far
    bfloat16 moves JAX's own step from its float32 step (the gap): the loss
    and the forward's pos_flow, preint_flow and y_source within 1.5 times
    the gap, each gradient tensor within 3 times its gap (relative to its
    largest entry) and their root mean square within 1.5 times the gaps'.
    Measured: 0.69, 0.79, 0.54 and 0.46 of the gap; 1.94 on the worst
    tensor (a bias), 0.92 in the mean. In float32 the two packages agree to
    1e-4 (test_vxm_dense_forward_and_step_match_jax); in bfloat16 their
    convolutions round in other orders, which moves the step by as much as
    bfloat16 itself does. The port's bfloat16 step must also differ from
    its float32 step by at least half the gap, so that bfloat16 is what
    ran."""
    shape = (16, 16, 16)
    monkeypatch.setitem(SHAPES, 3, shape)
    src, trg = _pair(3)
    zero = np.zeros((1, *shape, 3), np.float32)
    inputs, targets = (src, trg), (trg, zero)
    refs, ports = {}, {}
    for dt in (jnp.bfloat16, jnp.float32):
        jm, params, model = _models(monkeypatch, 3, {}, dtype=dt)
        loss_fn = jax_training.make_loss_fn(jm, _terms(jax_losses, jax_training.LossTerm))
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {}, inputs, targets, jax.random.PRNGKey(0))
        out = jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(trg))
        refs[dt] = (float(loss), flatten(jax.device_get(grads)),
                    {k: np.asarray(out[k], np.float32) for k in OUT_KEYS})
        trainer = Trainer(model, _terms(losses, LossTerm), lr=1e-4, device="cpu")
        loss, _ = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                                  tuple(map(torch.from_numpy, targets)))
        loss.backward()
        with torch.no_grad():
            out = model.train()(torch.from_numpy(src), torch.from_numpy(trg))
        ports[dt] = (loss.item(),
                     modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()}),
                     {k: out[k].float().numpy() for k in OUT_KEYS})
    assert model.dtype == torch.float32 and trainer.model.unet.dtype == torch.float32

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    (bf_loss, bf_grads, bf_out), (f32_loss, f32_grads, f32_out) = refs.values()
    (loss, grads, out), (port_f32_loss, _, _) = ports.values()
    gap = abs(bf_loss - f32_loss)
    assert abs(loss - bf_loss) <= 1.5 * gap and abs(loss - port_f32_loss) >= 0.5 * gap
    for key in OUT_KEYS:
        out_gap = np.abs(bf_out[key] - f32_out[key]).max()
        assert np.abs(out[key] - bf_out[key]).max() <= 1.5 * out_gap, key
    gaps = {k: rel(bf_grads[k], f32_grads[k]) for k in bf_grads}
    errs = {k: rel(grads[k], bf_grads[k]) for k in bf_grads}
    for name in bf_grads:
        assert errs[name] <= 3 * gaps[name], (name, errs[name], gaps[name])
    rms = lambda d: float(np.sqrt(np.mean(np.square(list(d.values())))))  # noqa: E731
    assert rms(errs) <= 1.5 * rms(gaps), (rms(errs), rms(gaps))


OUT_KEYS = ("pos_flow", "preint_flow", "y_source")


def _blob_files_2d(tmp_path, n=4, shape=(24, 20)):
    """Blob scans of the verification recipe, in 2-D."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in shape], indexing="ij")
    files = []
    for i in range(n):
        c = [s / 2 + rng.uniform(-2.5, 2.5) for s in shape]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        files.append(str(tmp_path / f"scan{i}.npz"))
        np.savez(files[-1], vol=np.exp(-d2 / 18).astype(np.float32),
                 seg=(d2 < 9).astype(np.int32))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    return files


def test_cli_trains_a_2d_model_and_registers(tmp_path, capsys):
    """Scan-to-atlas on one moving scan, so that every step sees the same
    pair and the loss must fall."""
    files = _blob_files_2d(tmp_path)
    (tmp_path / "one.txt").write_text(files[0] + "\n")
    models = tmp_path / "models"
    train_cli.main(["--img-list", str(tmp_path / "one.txt"), "--atlas", files[1],
                    "--model-dir", str(models), "--epochs", "2", "--steps-per-epoch", "4",
                    "--int-steps", "2", "--enc", "4", "8", "--dec", "8", "4", "--lr", "1e-3",
                    "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch")]
    loss = [float(ln.split("loss: ")[1].split()[0]) for ln in lines]
    assert len(loss) == 2 and loss[1] < loss[0], lines
    jm, _ = jax_load_model(str(models / "0002.npz"))
    assert tuple(jm.inshape) == (24, 20)
    warp = str(tmp_path / "warp.nii.gz")
    register_cli.main(["--moving", files[0], "--fixed", files[1], "--model",
                       str(models / "0002.npz"), "--moved", str(tmp_path / "moved.nii.gz"),
                       "--warp", warp, "--device", "cpu"])
    assert load_volfile(warp).shape == (24, 20, 2)
    assert os.path.exists(tmp_path / "moved.nii.gz")
