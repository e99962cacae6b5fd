"""The phase warp (``--fast-warp``) and the Dice entry point (``cli/test.py``)
against the JAX package on the CPU.

``integrate_vec_batched(return_root_steps=s)`` and ``phase_warp_batched`` are
held to the JAX functions of the same names at 1e-5 of the largest entry
(float32; the two sides sum in other orders). The JAX package takes its
phase warp only on a TPU, so its VxmDense on the CPU warps by the gather;
the port takes it on either device, and its VxmDense is held to the JAX
functions composed as the JAX VxmDense composes them there. The Dice CLI is
held to ``scripts/test.py`` on the repository's blob recipe: the same Dice to
1e-6 and the same warped segmentation.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models.vxm import rescale_flow as jax_rescale_flow
from voxelmorph_tpu.ops.interp import resize as jax_resize
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu.py import utils as jax_utils
from voxelmorph_tpu.registration import build_eval_register_fn
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import test as test_cli
from voxelmorph_tpu_torch.models.modelio import load_model
from voxelmorph_tpu_torch.ops import warp
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded
from voxelmorph_tpu_torch.py import utils
from voxelmorph_tpu_torch.registration import build_register_seg_fn, enable_fast_warp

ROOT = os.path.join(os.path.dirname(__file__), "..")
CHECKPOINT = os.path.join(ROOT, "artifacts_r4", "probs_ncc_0050.npz")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _gather_only(monkeypatch):
    """Squarings by the gather in both packages, as on the CPU by default."""
    monkeypatch.setenv("VXM_WINDOW_HALO", "0")


def _smooth_field(seed, shape, scale, batch=1):
    """A smooth random field of about ``scale`` voxels: coarse noise resized."""
    rng = np.random.default_rng(seed)
    coarse = scale * rng.normal(size=(batch, 3, 3, 3, 3)).astype(np.float32)
    return np.stack([np.asarray(jax_resize(jnp.asarray(c), [s / 3 for s in shape],
                                           new_shape=shape)) for c in coarse])


@pytest.mark.parametrize("root_steps", [1, 2])
def test_integrate_root_steps_matches_jax(root_steps):
    vec = _smooth_field(1, (12, 14, 16), 20.0, batch=2)
    ref, ref_root = jax_warp.integrate_vec_batched(jnp.asarray(vec), nb_steps=7,
                                                   return_root_steps=root_steps)
    out, root = warp.integrate_vec_batched(torch.from_numpy(vec), nb_steps=7,
                                           return_root_steps=root_steps)
    assert np.abs(np.asarray(ref)).max() > 2.0
    assert_rel_close(out.numpy(), np.asarray(ref), RTOL, "final")
    assert_rel_close(root.numpy(), np.asarray(ref_root), RTOL, "root")
    # the root is the field before the last root_steps squarings
    assert np.abs(np.asarray(ref_root)).max() < np.abs(np.asarray(ref)).max() / 1.5
    assert torch.equal(warp.integrate_vec_batched(torch.from_numpy(vec), nb_steps=7), out)


@pytest.mark.parametrize("root_scale,branch", [(0.6, "bounded"), (4.0, "gather")])
def test_phase_warp_matches_jax(root_scale, branch):
    """Four halo-2 bounded warps by the root, or, where the root exceeds the
    halo, one gather by the full flow."""
    shape = (10, 12, 14)
    vols = np.random.default_rng(2).uniform(size=(2, *shape, 1)).astype(np.float32)
    root = _smooth_field(3, shape, root_scale, batch=2)
    full = _smooth_field(4, shape, 3.0, batch=2)
    assert (np.abs(root).max() <= 2.0) == (branch == "bounded")
    ref = jax_warp.phase_warp_batched(jnp.asarray(vols), jnp.asarray(root), jnp.asarray(full),
                                      4, 2)
    before = warp_bounded.launches
    out = warp.phase_warp_batched(torch.from_numpy(vols), torch.from_numpy(root),
                                  torch.from_numpy(full), 4, 2)
    assert warp_bounded.launches == before  # CPU tensors take the plain version
    assert out.dtype == torch.float32
    assert_rel_close(out.numpy(), np.asarray(ref), RTOL, branch)


def _jax_checkpoint(tmp_path, shape=(16, 16, 16)):
    """The committed checkpoint's weights at ``shape`` in float32, saved by
    the JAX package."""
    jm, jp = jax_load_model(CHECKPOINT)
    path = str(tmp_path / "model.npz")
    jax_save_model(path, jm.clone(inshape=shape, dtype=jnp.float32), jp)
    return path


def test_vxm_fast_warp_matches_jax_phase_warp(tmp_path):
    """The port's VxmDense with the phase warp on: the fields of the plain
    forward, and y_source as the JAX VxmDense computes it on a TPU (its
    integration root, rescaled, through JAX's phase_warp_batched)."""
    shape = (16, 16, 16)
    path = _jax_checkpoint(tmp_path, shape)
    rng = np.random.default_rng(5)
    src, trg = (rng.uniform(size=(1, *shape, 1)).astype(np.float32) for _ in range(2))
    jm, jp = jax_load_model(path)
    ref = jm.apply({"params": jp}, jnp.asarray(src), jnp.asarray(trg), train=False)
    pos, root = jax_warp.integrate_vec_batched(ref["preint_flow"], nb_steps=7,
                                               return_root_steps=2)
    root = jax_rescale_flow(root, 2.0)
    ref_moved = jax_warp.phase_warp_batched(jnp.asarray(src), root, ref["pos_flow"], 4, 2)

    model = load_model(path, device="cpu")
    fast = enable_fast_warp(model)
    assert (fast.fast_warp_phases, fast.fast_warp_halo, model.fast_warp_phases) == (2, 2, 0)
    with torch.inference_mode():
        out = fast(torch.from_numpy(src), torch.from_numpy(trg))
        plain = model(torch.from_numpy(src), torch.from_numpy(trg))
    assert np.abs(np.asarray(root)).max() <= 2.0  # the bounded branch
    for key in ("pos_flow", "preint_flow", "postint_flow"):
        assert torch.equal(out[key], plain[key]), key
    assert_rel_close(out["y_source"].numpy(), np.asarray(ref_moved), 1e-4, "y_source")
    assert not torch.equal(out["y_source"], plain["y_source"])


def _blob_data(tmp_path, shape=(16, 16, 16)):
    """The repository's verification recipe: Gaussian-blob scans with a
    thresholded seg in each npz, and a list of pairs."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in shape], indexing="ij")
    files = []
    for i in range(4):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        path = str(tmp_path / f"scan{i}.npz")
        np.savez(path, vol=np.exp(-d2 / 18).astype(np.float32), seg=(d2 < 9).astype(np.int32))
        files.append(path)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text(f"{files[0]} {files[1]}\n{files[2]} {files[3]}\n")
    return files, str(pairs)


def _jax_test_script():
    spec = importlib.util.spec_from_file_location(
        "jax_test_script", os.path.join(ROOT, "scripts", "test.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fast_warp", [False, True], ids=["gather", "fast-warp"])
def test_cli_test_matches_jax(tmp_path, capsys, fast_warp):
    files, pairs = _blob_data(tmp_path)
    path = _jax_checkpoint(tmp_path)
    args = ["--model", path, "--pairs", pairs, "--img-suffix", "", "--seg-prefix", ""]
    flag = ["--fast-warp"] if fast_warp else []

    _jax_test_script().main(args + flag)
    jax_lines = capsys.readouterr().out.splitlines()
    scores = test_cli.main(args + flag + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    # the Dice columns of the per-pair and average lines
    assert [ln.split("Dice:")[1] for ln in lines if "Dice:" in ln] == \
        [ln.split("Dice:")[1] for ln in jax_lines if "Dice:" in ln]

    jm, jp = jax_load_model(path)
    jax_register = build_eval_register_fn(jm)
    register = build_register_seg_fn(enable_fast_warp(load_model(path, device="cpu"))
                                     if fast_warp else load_model(path, device="cpu"))
    for (mov, fix), score in zip(utils.read_pair_list(pairs), scores):
        mv, fx, ms = (utils.load_volfile(p, np_var=v, add_batch_axis=True,
                                         add_feat_axis=True).astype(np.float32)
                      for p, v in ((mov, "vol"), (fix, "vol"), (mov, "seg")))
        _, ref_warp, ref_seg = jax_register(jp, jnp.asarray(mv), jnp.asarray(fx),
                                            jnp.asarray(ms))
        _, warp_, seg = register(*map(torch.from_numpy, (mv, fx, ms)))
        assert np.abs(np.asarray(ref_warp)).max() > 0.5
        np.testing.assert_array_equal(seg.numpy(), np.asarray(ref_seg))
        true_seg = utils.load_volfile(fix, np_var="seg")
        ref_dice = jax_utils.dice(np.asarray(ref_seg).squeeze(), true_seg)
        assert 0.3 < np.mean(ref_dice) < 1.0
        assert score == pytest.approx(np.mean(ref_dice), abs=1e-6)


def test_utils_match_jax(tmp_path):
    _, pairs = _blob_data(tmp_path)
    for kw in (dict(), dict(prefix="a/", suffix=".npz")):
        assert utils.read_pair_list(pairs, **kw) == jax_utils.read_pair_list(pairs, **kw)
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 4, size=(2, 9, 9, 9))
    for kw in (dict(), dict(labels=[1, 3, 7]), dict(include_zero=True)):
        np.testing.assert_array_equal(utils.dice(a, b, **kw), jax_utils.dice(a, b, **kw))


def test_cli_register_fast_warp(tmp_path):
    """--fast-warp writes the warp of the plain path and the moved image of
    the fast-warp model (test_vxm_fast_warp_matches_jax_phase_warp holds
    that to JAX), which differs from the gather's."""
    files, _ = _blob_data(tmp_path)
    path = _jax_checkpoint(tmp_path)
    outs = {}
    for name, flag in (("gather", []), ("fast", ["--fast-warp"])):
        moved, warp_ = str(tmp_path / f"moved_{name}.npz"), str(tmp_path / f"warp_{name}.npz")
        register_cli.main(["--moving", files[0], "--fixed", files[1], "--model", path,
                           "--moved", moved, "--warp", warp_, "--device", "cpu"] + flag)
        outs[name] = (utils.load_volfile(moved), utils.load_volfile(warp_))
    np.testing.assert_array_equal(outs["fast"][1], outs["gather"][1])
    mv, fx = (torch.from_numpy(utils.load_volfile(f, add_batch_axis=True, add_feat_axis=True))
              for f in files[:2])
    with torch.inference_mode():
        ref = enable_fast_warp(load_model(path, device="cpu"))(mv, fx)["y_source"]
    np.testing.assert_array_equal(outs["fast"][0], ref.numpy().squeeze())
    assert np.abs(outs["fast"][0] - outs["gather"][0]).max() > 1e-3


def test_cli_test_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the GPU default runs")
    _, pairs = _blob_data(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main(["--model", CHECKPOINT, "--pairs", pairs, "--img-suffix", "",
                       "--seg-prefix", ""])
    assert test_cli.parse_args(["--model", "m", "--pairs", "p"]).device == "cuda"


def test_cli_test_refuses_hypermorph(tmp_path):
    """HyperMorph is not ported: its checkpoint raises, whatever --hyper says."""
    _, pairs = _blob_data(tmp_path)
    jm, jp = jax_load_model(CHECKPOINT)
    path = str(tmp_path / "hyper.npz")
    jax_save_model(path, jm.clone(inshape=(16, 16, 16), dtype=jnp.float32, hyper=True), jp)
    with pytest.raises(NotImplementedError, match="HyperMorph"):
        test_cli.main(["--model", path, "--pairs", pairs, "--img-suffix", "",
                       "--seg-prefix", "", "--hyper", "0.3", "--device", "cpu"])
