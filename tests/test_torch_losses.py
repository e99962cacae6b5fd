"""The PyTorch port's losses against the JAX package and the golden fixtures.

Values and gradients (with respect to the prediction) of NCC, MSE, Grad, KL,
TukeyBiweight, Dice and MutualInformation, on inputs made with numpy from seeds, within 1e-5 of each quantity's
largest magnitude (float32; the sums run in other orders). The golden
fixtures are held as ``tests/test_golden.py`` holds the JAX package: within
1e-5 relative and 1e-6 absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu_torch import losses

RTOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures.npz")


def _compare(jax_loss, torch_loss, y_true, y_pred):
    """Loss values and gradients with respect to y_pred on both sides."""
    ref, ref_grad = jax.value_and_grad(
        lambda p: jnp.sum(jax_loss(jnp.asarray(y_true), p)))(jnp.asarray(y_pred))
    pred = torch.from_numpy(y_pred).requires_grad_()
    ours = torch_loss(torch.from_numpy(y_true), pred)
    grad, = torch.autograd.grad(ours.sum(), pred)
    ref_raw = np.asarray(jax_loss(jnp.asarray(y_true), jnp.asarray(y_pred)))
    assert ours.shape == ref_raw.shape
    assert_rel_close(ours.detach().numpy(), ref_raw, RTOL, "loss")
    assert_rel_close(grad.numpy(), ref_grad, RTOL, "gradient")


def _images(seed, shape=(2, 10, 11, 9, 1)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = (0.6 * a + 0.4 * rng.uniform(size=shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kw,nch", [(dict(), 1), (dict(win=5), 1), (dict(win=5), 2),
                                    (dict(win=[3, 5, 7], signed=True), 1)],
                         ids=["win9", "win5", "win5-2ch", "signed"])
def test_ncc_matches_jax(kw, nch):
    y_true, y_pred = _images(1, (2, 10, 11, 9, nch))
    _compare(jax_losses.NCC(**kw).loss, losses.NCC(**kw).loss, y_true, y_pred)


@pytest.mark.parametrize("sigma", [1.0, 0.02])
def test_mse_matches_jax(sigma):
    y_true, y_pred = _images(2)
    _compare(jax_losses.MSE(sigma).loss, losses.MSE(sigma).loss, y_true, y_pred)


@pytest.mark.parametrize("penalty,mult,weighted", [("l1", None, False), ("l2", None, False),
                                                   ("l2", 2, False), ("l2", 2, True)])
def test_grad_matches_jax(penalty, mult, weighted):
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(2, 7, 8, 6, 3)).astype(np.float32)
    vw = rng.uniform(size=flow.shape).astype(np.float32) if weighted else None
    ref = jax_losses.Grad(penalty, loss_mult=mult,
                          vox_weight=None if vw is None else jnp.asarray(vw))
    ours = losses.Grad(penalty, loss_mult=mult,
                       vox_weight=None if vw is None else torch.from_numpy(vw))
    _compare(ref.loss, ours.loss, np.zeros_like(flow), flow)


def test_kl_matches_jax():
    rng = np.random.default_rng(4)
    shape = (7, 8, 6)
    params = np.concatenate([rng.normal(size=(2, *shape, 3)),
                             rng.normal(-3, 1, size=(2, *shape, 3))], -1).astype(np.float32)
    _compare(jax_losses.KL(10.0, shape).loss, losses.KL(10.0, shape).loss,
             np.zeros_like(params[..., :3]), params)
    np.testing.assert_array_equal(losses.KL(10.0, shape).D.numpy(),
                                  np.asarray(jax_losses.KL(10.0, shape).D))


@pytest.mark.parametrize("c", [0.5, 0.2])
def test_tukey_biweight_matches_jax(c):
    """Errors on both sides of the threshold c (y_pred - y_true in [-1, 1])."""
    rng = np.random.default_rng(5)
    y_true = rng.uniform(size=(2, 7, 8, 6, 1)).astype(np.float32)
    y_pred = (y_true + rng.uniform(-1, 1, size=y_true.shape)).astype(np.float32)
    assert (np.abs(y_pred - y_true) > c).mean() > 0.2
    assert (np.abs(y_pred - y_true) < c).mean() > 0.2
    _compare(jax_losses.TukeyBiweight(c).loss, losses.TukeyBiweight(c).loss, y_true, y_pred)


def test_dice_matches_jax():
    """Soft Dice of one-hot maps against soft predictions, with a label that
    neither sample has nor predicts (bottom == 0: its Dice counts as 0)."""
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 3, size=(2, 7, 8, 6))
    y_true = (labels[..., None] == np.arange(4)).astype(np.float32)
    logits = rng.normal(size=(2, 7, 8, 6, 4)).astype(np.float32)
    y_pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y_pred[..., 3] = 0.0
    y_pred = y_pred.astype(np.float32)
    _compare(jax_losses.Dice().loss, losses.Dice().loss, y_true, y_pred)
    # a perfect prediction of the present labels: -3/4 with the empty label
    perfect = losses.Dice().loss(torch.from_numpy(y_true), torch.from_numpy(y_true))
    assert perfect.item() == pytest.approx(-0.75)


@pytest.mark.parametrize("kw", [dict(), dict(nb_bins=8, minval=-0.2, maxval=1.2, sigma_ratio=1.0)],
                         ids=["default", "wide"])
def test_mutual_information_matches_jax(kw):
    rng = np.random.default_rng(7)
    y_true = rng.uniform(-0.1, 1.1, size=(2, 7, 8, 6, 1)).astype(np.float32)
    y_pred = (0.7 * y_true + 0.3 * rng.uniform(size=y_true.shape)).astype(np.float32)
    _compare(jax_losses.MutualInformation(**kw).loss, losses.MutualInformation(**kw).loss,
             y_true, y_pred)


def _assert_golden(out, gold):
    assert np.abs(gold).min() >= 10 * 1e-6  # ten times the absolute tolerance
    np.testing.assert_allclose(out, gold, rtol=1e-5, atol=1e-6)


def test_golden_ncc():
    g = np.load(FIXTURES)
    out = losses.NCC(win=5).loss(torch.from_numpy(g["img_a"]), torch.from_numpy(g["img_b"]))
    _assert_golden(out.numpy(), g["ncc_win5"])


def test_golden_grad():
    g = np.load(FIXTURES)
    out = losses.Grad("l2").loss(None, torch.from_numpy(g["flow"]))
    _assert_golden(out.numpy(), g["grad_l2"])


def test_golden_kl():
    g = np.load(FIXTURES)
    params = torch.cat([torch.from_numpy(g["mu"]), torch.from_numpy(g["logs"])], dim=-1)
    out = losses.KL(10.0, (9, 9, 9)).loss(torch.from_numpy(g["flow"]), params)
    _assert_golden(out.numpy(), g["kl"])
