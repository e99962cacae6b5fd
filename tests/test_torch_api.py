"""The public surface of the PyTorch port against the JAX package's: every
symbol of ``tests/test_api_parity.py``'s ``REFERENCE_API`` reachable from
``voxelmorph_tpu_torch`` (the list is imported, so that the two cannot
drift), importing the package building nothing and touching no GPU,
``generators.seed_rng``, ``models.register_model`` and
``register_config``, ``MSE.mse`` and ``Grad.mean_loss``, and the Trainer's
background checkpoint write (``save(wait=False)``, ``wait_for_saves``).

Losses are held to JAX's within 1e-6 of their largest magnitude; the
checkpoints a background write leaves are compared with those of a
synchronous write array for array, bit for bit.
"""

import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxelmorph_tpu_torch as vxt
from test_api_parity import REFERENCE_API
from torch_parity import assert_rel_close
from voxelmorph_tpu import generators as jax_generators
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu_torch import generators, losses, models
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPE = (8, 8, 8)
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("dotted", REFERENCE_API.keys())
def test_reference_api_is_reachable(dotted):
    mod = vxt
    for part in dotted.split("."):
        mod = getattr(mod, part)
    missing = [s for s in REFERENCE_API[dotted] if not hasattr(mod, s)]
    assert not missing, f"{dotted}: {missing}"


def test_package_import_builds_nothing_and_touches_no_gpu():
    """Importing the package imports its submodules (as the JAX package's
    does), and neither builds a kernel nor initialises CUDA."""
    code = ("import torch, voxelmorph_tpu_torch as v\n"
            "assert v.models.HyperVxmJoint and v.networks.VxmDense and v.utils.transform\n"
            "assert v.registration.build_joint_register_fn and v.training.Trainer\n"
            "assert not torch.cuda.is_initialized()\n"
            "from voxelmorph_tpu_torch import _build\n"
            "assert not _build._LOADED and not _build._ENTRY_POINTS\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr


def _volume_files(tmp_path, n=5):
    rng = np.random.default_rng(0)
    files = []
    for i in range(n):
        files.append(str(tmp_path / f"vol{i}.npz"))
        np.savez(files[-1], vol=rng.uniform(size=SHAPE).astype(np.float32))
    return files


def test_seed_rng_gives_the_jax_stream(tmp_path):
    """After seed_rng with one seed, the port's volgen and scan_to_scan
    given no rng draw the JAX package's batches; a generator already
    running follows a later seed_rng, as in JAX."""
    files = _volume_files(tmp_path)
    for seed in (3, 11):
        generators.seed_rng(seed)
        jax_generators.seed_rng(seed)
        ours = generators.volgen(files, batch_size=2)
        ref = jax_generators.volgen(files, batch_size=2)
        for _ in range(3):
            np.testing.assert_array_equal(next(ours)[0], next(ref)[0])
        generators.seed_rng(seed + 1)
        jax_generators.seed_rng(seed + 1)
        np.testing.assert_array_equal(next(ours)[0], next(ref)[0])
    generators.seed_rng(5)
    first = next(generators.scan_to_scan(files))[0][0]
    generators.seed_rng(5)
    np.testing.assert_array_equal(next(generators.scan_to_scan(files))[0][0], first)


class _Toy(torch.nn.Module):
    """A model class outside the package, with a config object."""

    def __init__(self, width=3, spec=None):
        super().__init__()
        self.config = dict(width=width, spec=spec)
        self.scale = torch.nn.Parameter(torch.arange(float(width)))


class _Spec:
    def __init__(self, name):
        self.name = name

    def to_dict(self):
        return {"name": self.name}

    @classmethod
    def from_dict(cls, data):
        return cls(**data)


def test_register_model_and_config(tmp_path):
    """register_model and register_config (also ``models.*``) make a class
    and a config object loadable by name, as in the JAX package; a config
    class without to_dict/from_dict is refused."""
    assert models.register_model is modelio.register_model
    path = str(tmp_path / "toy.npz")
    try:
        assert models.register_model(_Toy) is _Toy
        assert models.register_config(_Spec) is _Spec
        modelio.save_model(path, _Toy(4, _Spec("a")))
        loaded = modelio.load_model(path, device="cpu")
        assert isinstance(loaded, _Toy) and loaded.config["width"] == 4
        assert isinstance(loaded.config["spec"], _Spec) and loaded.config["spec"].name == "a"
        assert torch.equal(loaded.scale, torch.arange(4.0))
        assert modelio.MODEL_REGISTRY["_Toy"] is _Toy
    finally:
        modelio.MODEL_REGISTRY.pop("_Toy", None)
        modelio.CONFIG_REGISTRY.pop("_Spec", None)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        modelio.load_model(path, device="cpu")
    with pytest.raises(TypeError, match="to_dict"):
        models.register_config(type("Bare", (), {}))


def test_mse_and_grad_mean_loss_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(2, *SHAPE, 1)).astype(np.float32) for _ in range(2))
    flow = rng.normal(size=(2, *SHAPE, 3)).astype(np.float32)
    assert_rel_close(losses.MSE(0.5).mse(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                     np.asarray(jax_losses.MSE(0.5).mse(jnp.asarray(a), jnp.asarray(b))), 1e-6)
    for penalty in ("l1", "l2"):
        ours = losses.Grad(penalty, loss_mult=2.0).mean_loss(None, torch.from_numpy(flow))
        ref = jax_losses.Grad(penalty, loss_mult=2.0).mean_loss(None, jnp.asarray(flow))
        assert ours.dim() == 0
        assert_rel_close(ours.numpy(), np.asarray(ref), 1e-6, penalty)


def _trainer():
    model = VxmDense(SHAPE, nb_unet_features=[[4], [4]], int_steps=2,
                     generator=torch.Generator().manual_seed(0))
    return Trainer(model, [LossTerm("y_source", losses.MSE().loss),
                           LossTerm("pos_flow", losses.Grad("l2").loss, weight=0.01)],
                   lr=1e-2, device="cpu")


def _batch():
    rng = np.random.default_rng(4)
    src, trg = (rng.uniform(size=(1, *SHAPE, 1)).astype(np.float32) for _ in range(2))
    return (src, trg), (trg, np.zeros((1, *SHAPE, 3), np.float32))


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_same_file(a, b):
    ours, ref = _arrays(a), _arrays(b)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_async_save_writes_the_state_of_its_call(tmp_path, monkeypatch):
    """save(wait=False) returns before the file is written, and the file,
    written while two more steps change the parameters and Adam's moments
    in place, is the one save(wait=True) wrote at the call's step."""
    trainer = _trainer()
    for _ in range(2):
        trainer.train_step(*_batch())
    sync_path, async_path = str(tmp_path / "sync.npz"), str(tmp_path / "async.npz")
    trainer.save(sync_path)
    steps_done = threading.Event()
    write = modelio.save_model

    def held_write(*args, **kwargs):
        assert steps_done.wait(timeout=60)
        return write(*args, **kwargs)

    monkeypatch.setattr(modelio, "save_model", held_write)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.save(async_path, wait=False)
    assert not os.path.exists(async_path)
    for _ in range(2):
        trainer.train_step(*_batch())
    assert any(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
    steps_done.set()
    trainer.wait_for_saves()
    assert not trainer._save_thread.is_alive() if trainer._save_thread else True
    _assert_same_file(async_path, sync_path)


def test_wait_for_saves_raises_a_failed_write(tmp_path, monkeypatch):
    """A failed background write is raised again at the next join (and
    only once); the next save joins it too."""
    trainer = _trainer()

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(modelio, "save_model", fail)
    trainer.save(str(tmp_path / "a.npz"), wait=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as err:
        trainer.wait_for_saves()
    assert isinstance(err.value.__cause__, OSError)
    trainer.wait_for_saves()
    trainer.save(str(tmp_path / "b.npz"), wait=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        trainer.save(str(tmp_path / "c.npz"), wait=False)


def test_fit_writes_in_the_background_the_files_of_sync_saves(tmp_path, monkeypatch):
    """fit saves with wait=False, joins before it returns, and its last
    checkpoint is the file save(wait=True) writes after it."""
    trainer = _trainer()
    waits = []
    save = Trainer.save

    def record(self, path, wait=True):
        waits.append(wait)
        return save(self, path, wait=wait)

    monkeypatch.setattr(Trainer, "save", record)

    def gen():
        while True:
            yield _batch()

    trainer.fit(gen(), epochs=2, steps_per_epoch=2, model_dir=str(tmp_path / "run"),
                save_freq_epochs=1, log_fn=lambda msg: None, prefetch_size=0)
    assert waits == [False, False, False]
    assert trainer._save_thread is None
    trainer.save(str(tmp_path / "sync.npz"))
    _assert_same_file(str(tmp_path / "run" / "0002.npz"), str(tmp_path / "sync.npz"))
