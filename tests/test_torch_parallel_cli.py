"""The port's train CLI across processes against scripts/train.py on the JAX
mesh, on the CPU.

Two ``python -m voxelmorph_tpu_torch.cli.train`` processes (``--device
cpu``: gloo) with ``--num-processes 2 --coordinator 127.0.0.1:<free port>
--process-id r`` train two epochs of one step at batch 2 from a JAX
checkpoint, on pairs drawn on the device by ``--cache-device`` (a stream
keyed by the step, the same in every process and in both packages). Rank 0
alone writes the checkpoints and the metrics. Each checkpoint it writes is
held to the step that scripts/train.py (on its 8 virtual devices, 2-way
data parallel at batch 2) and the port's CLI in one process take from the
checkpoint before it, resumed: within JAX's DP-vs-single tolerance (rtol
1e-4, atol 1e-6) on the params and Adam's moments, the steps moving the
params by ten times that. Each step starts from the same state because the
loss's gradient is only piecewise smooth (the trilinear warp): runs 1e-7
apart cross its seams at different steps, and three uninterrupted steps of
this recipe then differ by 7.7e-6 in a conv bias that moved by 1.4e-3
(the gradient of either package at either run's params jumps by 3.7%).
"""

import importlib.util
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import flatten, unflatten
from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.training import Trainer as JaxTrainer
from voxelmorph_tpu_torch.cli import train as train_cli
from voxelmorph_tpu_torch.models import modelio

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (8, 8, 8)
RTOL, ATOL = 1e-4, 1e-6
NET = ["--enc", "4", "--dec", "4", "4", "--int-steps", "2", "--lr", "1e-3"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scans(tmp_path, n=4):
    """Blob scans (npz with 'vol' and 'seg') and their list."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in SHAPE], indexing="ij")
    files = []
    for i in range(n):
        c = [4 + rng.uniform(-1.5, 1.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        files.append(str(tmp_path / f"scan{i}.npz"))
        np.savez(files[-1], vol=np.exp(-d2 / 6).astype(np.float32),
                 seg=(d2 < 4).astype(np.int32))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    return files


def _jax_start(tmp_path):
    """A JAX checkpoint at step 0 of the CLIs' VxmDense, its flow head
    redrawn N(0, 0.3) for flows of voxels."""
    x = np.zeros((1, *SHAPE, 1), np.float32)
    model = JaxVxmDense(inshape=SHAPE, nb_unet_features=[[4], [4, 4]], int_steps=2,
                        int_resolution=2)
    flat = flatten(jax.device_get(model.init(jax.random.PRNGKey(0), x, x)["params"]))
    flat["flow||kernel"] = np.random.default_rng(3).normal(
        0.0, 0.3, flat["flow||kernel"].shape).astype(np.float32)
    trainer = JaxTrainer(model, [], lr=1e-3)
    trainer.init(None, params=jax.tree_util.tree_map(jnp.asarray, unflatten(flat)))
    path = str(tmp_path / "start.npz")
    trainer.save(path)
    return path


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train", ROOT / "scripts" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_checks(got, ref, start=None):
    """A checkpoint's params and Adam's state within RTOL/ATOL of
    another's; the step count equal; with ``start``, moved by 10 x ATOL."""
    assert sorted(got[2]) == sorted(ref[2])
    for key in ref[2]:
        np.testing.assert_allclose(got[2][key], ref[2][key], rtol=RTOL, atol=ATOL, err_msg=key)
    if start is not None:
        moved = max(np.abs(ref[2][k] - start[2][k]).max() for k in start[2])
        assert moved >= 10 * ATOL
    assert int(got[3]["train||step"]) == int(ref[3]["train||step"])
    opt = sorted(k for k in ref[3] if k.startswith("opt||"))
    assert opt and opt == sorted(k for k in got[3] if k.startswith("opt||"))
    for key in opt:
        np.testing.assert_allclose(got[3][key], ref[3][key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_cli_train_over_two_processes_matches_the_jax_script(tmp_path):
    _scans(tmp_path)
    start = _jax_start(tmp_path)
    common = ["--img-list", str(tmp_path / "list.txt"), *NET, "--batch-size", "2",
              "--cache-device", "--steps-per-epoch", "1", "--save-freq", "1"]
    port_dir = tmp_path / "port"
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "voxelmorph_tpu_torch.cli.train", *common, "--epochs", "2",
         "--load-weights", start, "--model-dir", str(port_dir), "--device", "cpu",
         "--num-processes", "2", "--coordinator", coordinator, "--process-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    script = _jax_script()

    def step_from(epoch, before):
        """The JAX script's and the one-process CLI's step ``epoch`` from
        the checkpoint ``before``."""
        resume = ["--load-weights", before, "--initial-epoch", str(epoch - 1),
                  "--epochs", str(epoch)]
        with pytest.warns(UserWarning, match="using 2 of 8 devices"):
            script.main([*common, *resume, "--model-dir", str(tmp_path / f"jax{epoch}")])
        train_cli.main([*common, *resume, "--model-dir", str(tmp_path / f"one{epoch}"),
                        "--device", "cpu"])

    step_from(1, start)  # while the two processes run
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}:\n{log}"
    # rank 0 logged and wrote; rank 1 only trained
    assert "epoch 2/2" in logs[0] and "epoch" not in logs[1]
    assert sorted(os.listdir(port_dir)) == ["0000.npz", "0001.npz", "0002.npz", "metrics.csv"]
    assert len((port_dir / "metrics.csv").read_text().splitlines()) == 3
    step_from(2, str(port_dir / "0001.npz"))
    for epoch in (1, 2):
        before = start if epoch == 1 else str(port_dir / "0001.npz")
        got, jax_ref, one = (modelio.read_checkpoint(str(d / f"{epoch:04d}.npz"),
                                                     with_extra=True)
                             for d in (port_dir, tmp_path / f"jax{epoch}",
                                       tmp_path / f"one{epoch}"))
        assert int(got[3]["train||step"]) == epoch
        before = modelio.read_checkpoint(before, with_extra=True)
        _step_checks(got, jax_ref, before)
        _step_checks(got, one)


# cli/train's modes under --spatial-shard: the default (MSE + Grad), and
# --image-loss ncc --use-probs --bidir --int-downsize 1 in the conv-kernel
# mode (VXM_PALLAS_CONV=1; the kernel's plain version on the CPU)
SPATIAL_MODES = {"mse": ([], {}),
                 "ncc_probs_bidir_conv": (["--image-loss", "ncc", "--use-probs", "--bidir",
                                           "--int-downsize", "1"], {"VXM_PALLAS_CONV": "1"})}


def _port_start(tmp_path, flags):
    """A port checkpoint at step 0 of the CLI's VxmDense for ``flags``, its
    flow head redrawn N(0, 0.3) for flows of voxels."""
    import torch

    from voxelmorph_tpu_torch.models.vxm import VxmDense
    from voxelmorph_tpu_torch.training import Trainer

    model = VxmDense(SHAPE, nb_unet_features=[[4], [4, 4]], int_steps=2,
                     int_resolution=1 if "--int-downsize" in flags else 2,
                     use_probs="--use-probs" in flags, bidir="--bidir" in flags,
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.flow.weight.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "start.npz")
    Trainer(model, [], device="cpu").save(path)
    return path


@pytest.mark.parametrize("mode", sorted(SPATIAL_MODES))
def test_cli_train_spatial_shard_matches_one_process(tmp_path, monkeypatch, mode):
    """cli/train --spatial-shard --num-processes 2 at batch 1: the rank the
    batch leaves over takes the 'space' axis, each process trains the U-Net
    on its 4 of the 8 planes (the one pool's 2-plane unit), and the
    checkpoint after an epoch of two steps is the one-process CLI's, within
    JAX's sharded-vs-single tolerance on the params and Adam's moments."""
    flags, env_extra = SPATIAL_MODES[mode]
    _scans(tmp_path)
    start = _port_start(tmp_path, flags)
    common = ["--img-list", str(tmp_path / "list.txt"), *NET, *flags, "--batch-size", "1",
              "--cache-device", "--steps-per-epoch", "2", "--epochs", "1",
              "--load-weights", start, "--device", "cpu"]
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env_extra)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "voxelmorph_tpu_torch.cli.train", *common, "--spatial-shard",
         "--model-dir", str(tmp_path / "sharded"), "--num-processes", "2",
         "--coordinator", coordinator, "--process-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for name, value in env_extra.items():
        monkeypatch.setenv(name, value)
    train_cli.main([*common, "--model-dir", str(tmp_path / "one")])  # meanwhile
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}:\n{log}"
    assert "epoch 1/1" in logs[0] and "epoch" not in logs[1]
    # no rank idle (without --spatial-shard, make_mesh_for_batch warns)
    assert not any("make_mesh_for_batch" in log for log in logs)
    got, one = (modelio.read_checkpoint(str(tmp_path / d / "0001.npz"), with_extra=True)
                for d in ("sharded", "one"))
    assert int(got[3]["train||step"]) == 2
    _step_checks(got, one, modelio.read_checkpoint(start, with_extra=True))
