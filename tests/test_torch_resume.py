"""Training resumes across the two packages with Adam's state.

A checkpoint carries optax's Adam leaves (count, mu, nu in the flax parameter
order) and the step, as the JAX ``Trainer`` writes them, in both directions:
two steps in one package, a checkpoint, one step in the other must give the
params of three steps in one package. Tolerance: 2e-3 of the largest change
of each parameter over the three steps, as ``test_train_steps_match_jax``
(the convolutions sum in other orders, and Adam's first steps divide each
gradient by its own magnitude). A restart of Adam at step 0 moves the third
step by several times that.
"""

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
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPE = (16, 16, 16)
CFG = dict(inshape=SHAPE, nb_unet_features=[[4, 8], [8, 4]], int_steps=7, int_resolution=2)
LR = 1e-3
ADAM_RTOL = 2e-3


def _batch():
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE], indexing="ij")
    src, trg = (np.exp(-sum((x - c) ** 2 for x, c in zip(g, rng.uniform(5.5, 10.5, 3)))
                       / 18).astype(np.float32)[None, ..., None] for _ in range(2))
    return (src, trg), (trg, np.zeros((1, *SHAPE, 3), np.float32))


def _params():
    """JAX params with the flow head redrawn N(0, 0.3), for flows of voxels,
    as numpy arrays (the JAX train step donates the device arrays it takes)."""
    (src, trg), _ = _batch()
    params = dict(JaxVxmDense(**CFG).init(jax.random.PRNGKey(0), jnp.asarray(src),
                                          jnp.asarray(trg))["params"])
    kernel = params["flow"]["kernel"]
    params["flow"] = dict(params["flow"], kernel=jnp.asarray(
        np.random.default_rng(3).normal(0.0, 0.3, kernel.shape).astype(np.float32)))
    return jax.device_get(params)


def _jax_trainer():
    terms = [jax_training.LossTerm("y_source", jax_losses.MSE(1.0).loss, target_index=0),
             jax_training.LossTerm("reg", jax_losses.Grad("l2", loss_mult=2).loss,
                                   weight=0.01, target_index=1)]
    return jax_training.Trainer(JaxVxmDense(**CFG), terms, lr=LR)


def _torch_trainer(params=None):
    model = VxmDense(**CFG)
    if params is not None:
        model.load_state_dict(modelio.params_from_jax(flatten(params)))
    terms = [LossTerm("y_source", losses.MSE(1.0).loss, target_index=0),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=1)]
    return Trainer(model, terms, lr=LR, device="cpu")


def _steps(trainer, n):
    for _ in range(n):
        trainer.train_step(*_batch())
    return trainer


def _compare(params, start):
    start = flatten(start)
    for name, whole in params["whole"].items():
        assert_rel_close(params["resumed"][name] - start[name], whole - start[name],
                         ADAM_RTOL, name)


@pytest.fixture(autouse=True)
def _gather_only(monkeypatch):
    monkeypatch.setenv("VXM_WINDOW_HALO", "0")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    params = _params()
    jt = _jax_trainer()
    jt.init(None, params=jax.tree_util.tree_map(jnp.asarray, params))
    _steps(jt, 2).save(str(tmp_path / "0002.npz"))
    whole = flatten(jax.device_get(_steps(jt, 1).params))

    resumed = _torch_trainer()
    resumed.load(str(tmp_path / "0002.npz"))
    assert resumed.global_step == 2
    assert float(next(iter(resumed.optimizer.state.values()))["step"]) == 2
    _steps(resumed, 1)
    assert resumed.global_step == 3
    _compare({"resumed": modelio.params_to_jax(resumed.model.state_dict()), "whole": whole},
             params)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    params = _params()
    first = _steps(_torch_trainer(params), 2)
    first.save(str(tmp_path / "0002.npz"))
    whole = modelio.params_to_jax(_steps(first, 1).model.state_dict())

    jt = _jax_trainer()
    jt.load(str(tmp_path / "0002.npz"))
    assert jt.global_step == 2 and int(jt.opt_state[0].count) == 2
    assert np.asarray(jt.base_rng).tolist() == np.asarray(jax.random.PRNGKey(0)).tolist()
    _steps(jt, 1)
    _compare({"resumed": flatten(jax.device_get(jt.params)), "whole": whole}, params)


def test_optax_leaf_layout_matches_jax(tmp_path):
    """The leaves the port writes are those optax keeps for the same params:
    the same count and order, shapes and dtypes."""
    params = _params()
    trainer = _torch_trainer(params)
    trainer.init()
    trainer.save(str(tmp_path / "0000.npz"))
    _, _, _, extra = modelio.read_checkpoint(str(tmp_path / "0000.npz"), with_extra=True)
    ours = [extra[k] for k in sorted(k for k in extra if k.startswith("opt||"))]
    ref = jax.tree_util.tree_leaves(optax.adam(LR).init(params))
    assert len(ours) == len(ref) == 1 + 2 * len(flatten(params))
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_unmappable_optimizer_state_raises(tmp_path):
    params = _params()
    trainer = _steps(_torch_trainer(params), 1)
    path = str(tmp_path / "0001.npz")
    trainer.save(path)
    with np.load(path) as data:
        arrays = dict(data)
    # a state with one leaf too few (another optimizer, or another model)
    short = {k: v for k, v in arrays.items() if k != "__extra__opt||00002"}
    np.savez(tmp_path / "short.npz", **short)
    with pytest.raises(ValueError, match="cannot be restored"):
        _torch_trainer().load(str(tmp_path / "short.npz"))
    # moments of another shape
    bad = dict(arrays, **{"__extra__opt||00001": np.zeros((2, 2), np.float32)})
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="optimizer state"):
        _torch_trainer().load(str(tmp_path / "bad.npz"))
    # the layout of an earlier version of the port
    old = dict(arrays, **{"__extra__torch_opt||00000||step": np.zeros((), np.float32)})
    np.savez(tmp_path / "old.npz", **old)
    with pytest.raises(ValueError, match="torch_opt"):
        _torch_trainer().load(str(tmp_path / "old.npz"))
