"""The port's HyperMorph CLIs against the JAX package's scripts on the CPU:
cli/train_hypermorph against scripts/train_hypermorph.py, resumed from the
same JAX checkpoint for the same steps on a one-scan list with an atlas
(so that both draw the same pairs); its --cache-device dispatches against
its single steps and its --load-weights latest against an uninterrupted
run; and cli/register, cli/test and cli/sweep_hypermorph with --hyper
against scripts/register.py, test.py and sweep_hypermorph.py on the same
checkpoint and blob scans.

Volumes are 16^3 (blobs with a three-label segmentation, as the
repository's verification recipe makes them) with narrow features; the
checkpoints' flow heads are redrawn N(0, 0.3) and the hypernetwork's
generator weights N(0, 0.05), for flows of voxels that change with lambda.
Tolerances as ``tests/test_torch_atlas_cli.py``: 2e-3 of the largest change
of each parameter over the Adam steps, 1e-5 on the warp and the moved
image, 1e-4 on --test-reg's images after training (they follow params
that differ within the Adam tolerance; measured 2.2e-6), each relative to
the largest magnitude; the lambda draws, the Dice
scores and the share of folded voxels are equal. The port's runs against
each other (dispatch against single steps, resumed against uninterrupted)
are bit-equal.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten, unflatten
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import HyperVxmDense as JaxHyper
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu_torch import training
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import sweep_hypermorph as sweep_cli
from voxelmorph_tpu_torch.cli import test as test_cli
from voxelmorph_tpu_torch.cli import train_hypermorph as train_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.py.utils import load_volfile

SHAPE = (16, 16, 16)
ADAM_RTOL = 2e-3
OUT_RTOL = 1e-5
MIN_FLOW = 0.5  # voxels
SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
# the CLIs' small-network flags
NET = ["--enc", "4", "8", "--dec", "8", "4", "--int-steps", "3"]
CFG = dict(inshape=SHAPE, nb_unet_features=[[4, 8], [8, 4]], int_steps=3, svf_resolution=2)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scans(tmp_path, n=4):
    """Blob scans (npz with 'vol' and a three-label 'seg'), the list of all
    of them and a list of the first alone."""
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
    (tmp_path / "one.txt").write_text(files[0] + "\n")
    return files


def _params(seed=0):
    """JAX HyperVxmDense params (numpy) with the flow head N(0, 0.3) and the
    generator weights N(0, 0.05)."""
    x = np.zeros((1, *SHAPE, 1), np.float32)
    params = jax.device_get(JaxHyper(**CFG).init(jax.random.PRNGKey(seed), x, x,
                                                 np.zeros((1, 1), np.float32))["params"])
    rng = np.random.default_rng(3)
    flat = flatten(params)
    for key, val in flat.items():
        if key.endswith("flow||kernel"):
            flat[key] = rng.normal(0.0, 0.3, val.shape).astype(np.float32)
        elif key.endswith("_gen||kernel"):
            flat[key] = rng.normal(0.0, 0.05, val.shape).astype(np.float32)
    return unflatten(flat)


def _jax_start(tmp_path):
    """A JAX Trainer checkpoint at step 0 (Adam's state included) of the
    redrawn params, as scripts/train_hypermorph.py builds its trainer."""
    jt = jax_training.Trainer(JaxHyper(**CFG), [], lr=1e-4)
    jt.init(None, params=jax.tree_util.tree_map(jnp.asarray, _params()))
    path = str(tmp_path / "start.npz")
    jt.save(path)
    return path


@pytest.fixture
def lambdas(monkeypatch):
    """The lambda input of every train step of either package, in order."""
    seen = {"jax": [], "port": []}
    for name, cls in (("jax", jax_training.Trainer), ("port", training.Trainer)):
        step = cls.train_step

        def record(self, inputs, targets, step=step, log=seen[name]):
            log.append(np.array(inputs[-1]))
            return step(self, inputs, targets)

        monkeypatch.setattr(cls, "train_step", record)
    return seen


def _params_of(path):
    return modelio.read_checkpoint(path)[2]


def test_train_matches_the_jax_script(tmp_path, lambdas):
    """Three steps of the recipe (MSE at sigma 0.05, Grad-l2, lambda drawn
    per step) from the same checkpoint: the same lambda draws, and the
    params within ADAM_RTOL; then --test-reg's 20 moved images."""
    files = _scans(tmp_path)
    start = _jax_start(tmp_path)
    common = ["--img-list", str(tmp_path / "one.txt"), "--atlas", files[1], *NET,
              "--epochs", "1", "--steps-per-epoch", "3", "--load-weights", start,
              "--oversample-rate", "0.5"]
    _script("train_hypermorph").main([*common, "--model-dir", str(tmp_path / "jax"),
                                      "--test-reg", files[0], files[1],
                                      str(tmp_path / "jax_sweep.nii.gz")])
    train_cli.main([*common, "--model-dir", str(tmp_path / "port"), "--device", "cpu",
                    "--test-reg", files[0], files[1], str(tmp_path / "port_sweep.nii.gz")])
    assert len(lambdas["jax"]) == len(lambdas["port"]) == 3
    for ours, ref in zip(lambdas["port"], lambdas["jax"]):
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == (1, 1)
        np.testing.assert_array_equal(ours, ref)
    flat0 = _params_of(start)
    jflat = _params_of(str(tmp_path / "jax" / "0001.npz"))
    pflat = _params_of(str(tmp_path / "port" / "0001.npz"))
    assert sorted(pflat) == sorted(jflat)
    for key in jflat:
        assert_rel_close(pflat[key] - flat0[key], jflat[key] - flat0[key], ADAM_RTOL, key)
    ours, ref = (load_volfile(str(tmp_path / f"{p}_sweep.nii.gz")) for p in ("port", "jax"))
    assert ours.shape == ref.shape == (*SHAPE, 20)
    assert np.abs(ours[..., 0] - ours[..., -1]).max() > 1e-2  # lambda moves the image
    assert_rel_close(ours, ref, 1e-4, "test-reg")


def test_cache_device_dispatch_and_resume(tmp_path, lambdas):
    """--cache-device --steps-per-dispatch 2 gives the params of the cached
    single steps on the same picks and lambdas; a run stopped after an
    epoch and resumed with --load-weights latest gives the uninterrupted
    run's lambdas and params. All bit for bit."""
    _scans(tmp_path)
    start = _jax_start(tmp_path)
    common = ["--img-list", str(tmp_path / "list.txt"), *NET, "--steps-per-epoch", "2",
              "--cache-device", "--save-freq", "1", "--device", "cpu"]
    with pytest.raises(SystemExit, match="requires --cache-device"):
        train_cli.main(["--img-list", str(tmp_path / "list.txt"), "--steps-per-dispatch", "2",
                        "--device", "cpu"])
    runs = {}
    for name, extra in (("single", []), ("dispatch", ["--steps-per-dispatch", "2"])):
        lambdas["port"].clear()
        train_cli.main([*common, "--epochs", "2", "--load-weights", start, *extra,
                        "--model-dir", str(tmp_path / name)])
        runs[name] = (list(lambdas["port"]), _params_of(str(tmp_path / name / "0002.npz")))
    lambdas["port"].clear()
    resumed = str(tmp_path / "resumed")
    train_cli.main([*common, "--epochs", "1", "--load-weights", start, "--model-dir", resumed])
    train_cli.main([*common, "--epochs", "2", "--load-weights", "latest", "--model-dir", resumed])
    runs["resumed"] = (list(lambdas["port"]), _params_of(os.path.join(resumed, "0002.npz")))

    draws, params = runs["single"]
    assert len(draws) == 4 and len({float(d[0, 0]) for d in draws}) > 1
    for name in ("dispatch", "resumed"):
        assert len(runs[name][0]) == 4
        for a, b in zip(runs[name][0], draws):
            np.testing.assert_array_equal(a, b)
        for key, val in params.items():
            np.testing.assert_array_equal(runs[name][1][key], val, err_msg=f"{name} {key}")


@pytest.fixture
def hyper_checkpoint(tmp_path):
    files = _scans(tmp_path)
    path = str(tmp_path / "hyper.npz")
    jax_save_model(path, JaxHyper(**CFG), _params())
    (tmp_path / "pairs.txt").write_text(f"{files[0]} {files[1]}\n{files[2]} {files[3]}\n")
    np.savez(tmp_path / "labels.npz", labels=np.array([1, 2, 3]))
    return path, files


def test_register_with_hyper_matches_the_jax_script(tmp_path, hyper_checkpoint):
    model, files = hyper_checkpoint
    outputs = {}
    for name, main in (("jax", _script("register").main), ("port", register_cli.main)):
        args = ["--moving", files[0], "--fixed", files[1], "--model", model, "--hyper", "0.3",
                "--moved", str(tmp_path / f"{name}_moved.nii.gz"),
                "--warp", str(tmp_path / f"{name}_warp.nii.gz")]
        main(args + (["--device", "cpu"] if name == "port" else []))
        outputs[name] = [load_volfile(str(tmp_path / f"{name}_{k}.nii.gz"))
                         for k in ("moved", "warp")]
    assert np.abs(outputs["jax"][1]).max() >= MIN_FLOW
    for ours, ref, key in zip(outputs["port"], outputs["jax"], ("moved", "warp")):
        assert_rel_close(ours, ref, OUT_RTOL, key)
    # another lambda, another warp
    register_cli.main(["--moving", files[0], "--fixed", files[1], "--model", model,
                       "--hyper", "0.9", "--moved", str(tmp_path / "m9.nii.gz"),
                       "--warp", str(tmp_path / "w9.nii.gz"), "--device", "cpu"])
    assert np.abs(load_volfile(str(tmp_path / "w9.nii.gz")) - outputs["port"][1]).max() > 1e-2


def test_dice_and_sweep_match_the_jax_scripts(tmp_path, hyper_checkpoint, capsys):
    """cli/test --hyper prints the JAX script's Dice for every pair, and
    cli/sweep_hypermorph writes the JAX script's report."""
    model, _ = hyper_checkpoint
    pairs = str(tmp_path / "pairs.txt")
    args = ["--model", model, "--pairs", pairs, "--img-suffix", "", "--seg-prefix", "",
            "--hyper", "0.3"]
    _script("test").main(args)
    ref = [ln.split("Dice: ")[1] for ln in capsys.readouterr().out.splitlines() if "Dice:" in ln]
    scores = test_cli.main([*args, "--device", "cpu"])
    ours = [ln.split("Dice: ")[1] for ln in capsys.readouterr().out.splitlines()
            if "Dice:" in ln]
    assert len(scores) == 2 and len(ours) == len(ref) == 3
    assert ours == ref

    lams = ["--lambdas", "0", "0.5", "1"]
    common = ["--model", model, "--pairs", pairs, "--labels", str(tmp_path / "labels.npz"),
              *lams]
    _script("sweep_hypermorph").main([*common, "--out", str(tmp_path / "jax.json")])
    report = sweep_cli.main([*common, "--out", str(tmp_path / "port.json"), "--device", "cpu"])
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == report
    assert sorted(report) == sorted(ref)
    for key in ("model", "n_pairs", "n_labels", "protocol", "identity_dice_mean", "sweep"):
        assert report[key] == ref[key], key
    assert [r["lambda"] for r in report["sweep"]] == [0.0, 0.5, 1.0]
    assert len({r["dice_mean"] for r in report["sweep"]}) > 1
    # the entry points run on the GPU unless told otherwise
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep_cli.main([*common, "--out", str(tmp_path / "gpu.json")])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--img-list", str(tmp_path / "list.txt"), *NET])
