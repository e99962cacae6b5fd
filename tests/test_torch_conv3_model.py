"""The port's conv blocks in the JAX package's conv modes, against the JAX
package on the CPU: ``VXM_PALLAS_CONV=1`` (the conv kernel; the JAX side
through the Pallas interpreter) and ``VXM_XLA_DW_EINSUM=1`` (the lean-dw
convolution), at the block, model and train-step level. Inputs come from
numpy seeds; each test states its tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_close, assert_rel_close, flatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models.unet import PallasConv3
from voxelmorph_tpu.ops import pallas_conv
from voxelmorph_tpu.registration import resolve_registration_model as jax_resolve
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.unet import ConvBlock
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops import conv3
from voxelmorph_tpu_torch.registration import resolve_registration_model
from voxelmorph_tpu_torch.training import LossTerm, Trainer

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "artifacts_r4",
                          "probs_ncc_0050.npz")
BF16_STEP = 2.0 ** -7
# test_checkpoint_bfloat16_matches_jax's tolerances (voxels, intensities)
BF16_FLOW_TOL = 1.5e-2
BF16_IMAGE_TOL = 1e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)


@pytest.fixture
def kernel_mode(interpret):
    """The VXM_PALLAS_CONV=1 mode in both packages, for the test's duration."""
    pallas_conv.set_pallas_conv(True)
    conv3.set_pallas_conv(True)
    try:
        yield
    finally:
        pallas_conv.set_pallas_conv(None)
        conv3.set_pallas_conv(None)


SMALL = dict(inshape=(16, 16, 16), nb_unet_features=[[4, 8], [8, 4]], int_steps=7,
             int_resolution=2)


def _small_pair(seed=1):
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.arange(16, dtype=np.float32)] * 3, indexing="ij")
    src, trg = (np.exp(-sum((x - c) ** 2 for x, c in zip(g, rng.uniform(5.5, 10.5, 3)))
                       / 18).astype(np.float32)[None, ..., None] for _ in range(2))
    return src, trg


def _small_models():
    src, trg = _small_pair()
    jm = JaxVxmDense(**SMALL)
    params = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(trg))["params"])
    kernel = params["flow"]["kernel"]
    params["flow"] = dict(params["flow"], kernel=jnp.asarray(
        np.random.default_rng(3).normal(0.0, 0.3, kernel.shape).astype(np.float32)))
    model = VxmDense(**SMALL)
    model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return jm, params, model


def _terms(L, Term):
    return [Term("y_source", L.MSE(1.0).loss, weight=1.0, target_index=0),
            Term("reg", L.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=1,
                 name="grad")]


@pytest.mark.parametrize("shape", [(8, 8, 8, 32, 32), (16, 16, 16, 16, 8), (8, 8, 32, 8, 8)])
def test_rounding_order_follows_jax(kernel_mode, shape):
    """A bfloat16 conv block rounds as the JAX package's ``PallasConv3``: once
    where its kernel takes the shape (the last two), conv output first where
    it falls back to XLA (the first). The right order agrees bit for bit but
    where the sums' order flips a rounding (measured: all or all but 1 in
    32768 elements); the other order differs in about a third."""
    D, H, W, ci, co = shape
    rng = np.random.default_rng(ci + co)
    x = rng.normal(size=(1, D, H, W, ci)).astype(np.float32)
    jblock = PallasConv3(co, fuse_act=True, dtype=jnp.bfloat16)
    k = np.asarray(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]["kernel"])
    b = (0.3 * rng.normal(size=(co,))).astype(np.float32)
    ref = np.asarray(jblock.apply({"params": {"kernel": k, "bias": b}}, jnp.asarray(x)),
                     np.float32)

    block = ConvBlock(ci, co, dtype=torch.bfloat16)
    block.load_state_dict(modelio.params_from_jax({"conv||kernel": k, "conv||bias": b}))
    with torch.no_grad():
        out = block(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).float().numpy()
    err = np.abs(out - ref)
    assert np.abs(ref).max() > 1.0
    assert (err <= BF16_STEP * np.abs(ref)).all(), err.max()
    assert (out == ref).mean() >= 0.999


def test_checkpoint_bfloat16_kernel_mode_matches_jax(kernel_mode):
    """The committed checkpoint in bfloat16 at 32^3 with the conv switch on in
    both packages: JAX's kernel takes the 32^3 and 16^3 convs and XLA the
    deeper ones, and the port rounds each as JAX does. Measured: 3.9e-3
    voxels on pos_flow, 1.4e-3 on y_source; rounding every conv once gives
    6.6e-3 and 3.9e-3 (test_rounding_order_follows_jax tells those apart),
    rounding every conv first, as XLA does, 2.4e-2 and 1.6e-2."""
    shape = (32, 32, 32)
    rng = np.random.default_rng(2)
    src, trg = (rng.uniform(size=(1, *shape, 1)).astype(np.float32) for _ in range(2))
    jm, jp = jax_load_model(CHECKPOINT)
    m, p = jax_resolve(jm, jp, shape)
    assert m.dtype == jnp.bfloat16
    ref = m.apply({"params": p}, jnp.asarray(src), jnp.asarray(trg), train=False)
    pallas_conv.set_pallas_conv(False)
    xla = m.apply({"params": p}, jnp.asarray(src), jnp.asarray(trg), train=False)

    model = resolve_registration_model(modelio.load_model(CHECKPOINT, device="cpu"), shape)
    with torch.inference_mode():
        out = model(torch.from_numpy(src), torch.from_numpy(trg))
    for key, tol in (("pos_flow", BF16_FLOW_TOL), ("y_source", BF16_IMAGE_TOL)):
        expected = np.asarray(ref[key], dtype=np.float32)
        # the tolerance tells the kernel mode's roundings from XLA's
        assert np.abs(np.asarray(xla[key], np.float32) - expected).max() > tol, key
        assert_close(out[key].numpy(), expected, tol, key)


@pytest.mark.parametrize("switch", ["VXM_PALLAS_CONV", "VXM_XLA_DW_EINSUM",
                                    "VXM_PALLAS_CONV,channels_last"])
def test_train_step_under_the_switch_matches_jax(monkeypatch, interpret, switch):
    """One float32 step of the default recipe with the switch set for both
    packages: every conv block takes the switch's path in the port, and the
    loss and parameter gradients equal JAX's within 1e-4 of each tensor's
    largest entry, the params after the Adam step within 2e-3 of their
    change (test_train_steps_match_jax's tolerances). ``channels_last``:
    the conv-kernel path is also held to its layout, every conv block's
    input and output channels-last and no layout copy in the forward."""
    switch, _, layout = switch.partition(",")
    monkeypatch.setenv("VXM_WINDOW_HALO", "0")
    monkeypatch.setenv(switch, "1")
    calls = {"conv3_same_cf": 0, "conv3_same_lean_dw": 0}
    for name in calls:
        def spy(*args, _fn=getattr(conv3, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(conv3, name, spy)

    jm, params, model = _small_models()
    src, trg = _small_pair()
    zero = np.zeros((1, 16, 16, 16, 3), np.float32)
    inputs, targets = (src, trg), (trg, zero)
    jterms = _terms(jax_losses, jax_training.LossTerm)
    loss_fn = jax_training.make_loss_fn(jm, jterms)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {}, inputs, targets, jax.random.PRNGKey(0))
    tx = optax.adam(1e-4)
    step = jax_training.make_train_step(jm, jterms, tx, donate=False)
    ref_params, _, _, _ = step(params, {}, tx.init(params), jax.random.PRNGKey(0),
                               np.asarray(0, np.int32), inputs, targets)

    trainer = Trainer(model, _terms(losses, LossTerm), lr=1e-4, device="cpu")
    model.train()
    layouts = []
    if layout:
        cl = torch.channels_last_3d
        for m in model.modules():
            if isinstance(m, ConvBlock):
                m.register_forward_hook(lambda m, i, o: layouts.append(
                    (i[0].is_contiguous(memory_format=cl), o.is_contiguous(memory_format=cl))))
        conv3.conv3_same_cf.layout_copies = 0
    loss, _ = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                              tuple(map(torch.from_numpy, targets)))
    if layout:
        assert layouts == [(True, True)] * 4 and conv3.conv3_same_cf.layout_copies == 0
    loss.backward()
    n_blocks = 4  # enc_conv_0_0, enc_conv_1_0, dec_conv_1_0, dec_conv_0_0
    expected = "conv3_same_cf" if switch == "VXM_PALLAS_CONV" else "conv3_same_lean_dw"
    # each block's forward, and its recomputation in the backward (the
    # U-Net's per-block remat)
    assert calls == {k: 2 * n_blocks if k == expected else 0 for k in calls}
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-4)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    for name, ref in flatten(ref_grads).items():
        assert_rel_close(grads[name], ref, 1e-4, name)
    trainer.train_step(inputs, targets)
    ours, start = modelio.params_to_jax(model.state_dict()), flatten(params)
    for name, ref in flatten(ref_params).items():
        assert_rel_close(ours[name] - start[name], ref - start[name], 2e-3, name)
