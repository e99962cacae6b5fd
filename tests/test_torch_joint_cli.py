"""Serving SynthMorph's joint model in the PyTorch port against the JAX
package on the CPU: a JAX-saved ``HyperVxmJoint`` checkpoint (built as
``tests/test_scripts.py`` builds one) through the port's ``cli/register``
and ``cli/test`` and through ``scripts/register.py`` and ``scripts/test.py``;
``register_pair``, ``build_joint_register_fn`` and
``resolve_registration_model`` against JAX's; and a port-saved checkpoint
in JAX's ``load_model``.

Scans are 16^3 blobs with a three-label segmentation, as the repository's
verification recipe makes them; the model is narrow, with 8 affine
features (fewer than 4 landmarks make the 3-D fit singular). Tolerances
relative to the largest magnitude: 1e-4 on the warp and the moved image,
which follow the detector's fit (as ``tests/test_torch_joint.py``;
measured 2.1e-6), and the Dice scores printed equal.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten, unflatten
from voxelmorph_tpu import registration as jax_registration
from voxelmorph_tpu.models import HyperVxmJoint as JaxJoint
from voxelmorph_tpu.models import TemplateCreation as JaxTemplate
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu_torch import registration
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import test as test_cli
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.atlas import TemplateCreation
from voxelmorph_tpu_torch.models.synthmorph import HyperVxmJoint
from voxelmorph_tpu_torch.py.utils import load_volfile

SHAPE = (16, 16, 16)
FIT_RTOL = 1e-4
SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
CFG = dict(in_shape=SHAPE, int_steps=1, hyp_units=(2,), enc_nf=(2,), dec_nf=(2,), add_nf=(2,),
           aff_num_feat=8, aff_enc_nf=(4,))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scans(tmp_path, n=4):
    """Blob scans (npz with 'vol' and a three-label 'seg') and a pair list."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in SHAPE], indexing="ij")
    files = []
    for i in range(n):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        files.append(str(tmp_path / f"scan{i}.npz"))
        np.savez(files[-1], vol=np.exp(-d2 / 18).astype(np.float32),
                 seg=(d2 < 9).astype(np.int32) + (d2 < 20) + (g[0] > 12))
    (tmp_path / "pairs.txt").write_text(f"{files[0]} {files[1]}\n{files[2]} {files[3]}\n")
    return files


@pytest.fixture
def joint_checkpoint(tmp_path):
    """A JAX HyperVxmJoint checkpoint of flax's init on the first scan."""
    files = _scans(tmp_path)
    mv = np.load(files[0])["vol"][None, ..., None]
    hyp = np.full((1, 1), 0.5, np.float32)
    model = JaxJoint(**CFG)
    params = jax.jit(lambda k: model.init(k, hyp, mv, mv))(jax.random.PRNGKey(0))["params"]
    path = str(tmp_path / "joint.npz")
    jax_save_model(path, model, jax.device_get(params))
    return path, files


def test_register_matches_the_jax_script(tmp_path, joint_checkpoint):
    """cli/register --hyper 0.3 writes the moved scan and the warp of
    scripts/register.py; another --hyper, another warp."""
    model, files = joint_checkpoint
    outputs = {}
    for name, main in (("jax", _script("register").main), ("port", register_cli.main)):
        args = ["--moving", files[0], "--fixed", files[1], "--model", model, "--hyper", "0.3",
                "--moved", str(tmp_path / f"{name}_moved.nii.gz"),
                "--warp", str(tmp_path / f"{name}_warp.nii.gz")]
        main(args + (["--device", "cpu"] if name == "port" else []))
        outputs[name] = [load_volfile(str(tmp_path / f"{name}_{k}.nii.gz"))
                         for k in ("moved", "warp")]
    assert outputs["port"][1].shape == (*SHAPE, 3)
    for ours, ref, key in zip(outputs["port"], outputs["jax"], ("moved", "warp")):
        assert np.isfinite(ours).all()
        assert_rel_close(ours, ref, FIT_RTOL, key)
    register_cli.main(["--moving", files[0], "--fixed", files[1], "--model", model,
                       "--hyper", "0.9", "--moved", str(tmp_path / "m9.nii.gz"),
                       "--warp", str(tmp_path / "w9.nii.gz"), "--device", "cpu"])
    assert np.abs(load_volfile(str(tmp_path / "w9.nii.gz")) - outputs["port"][1]).max() > 0


def test_dice_matches_the_jax_script(tmp_path, joint_checkpoint, capsys):
    """cli/test --hyper 0.3 prints scripts/test.py's Dice for every pair."""
    model, _ = joint_checkpoint
    args = ["--model", model, "--pairs", str(tmp_path / "pairs.txt"), "--img-suffix", "",
            "--seg-prefix", "", "--hyper", "0.3"]
    _script("test").main(args)
    ref = [ln.split("Dice: ")[1] for ln in capsys.readouterr().out.splitlines() if "Dice:" in ln]
    scores = test_cli.main([*args, "--device", "cpu"])
    ours = [ln.split("Dice: ")[1] for ln in capsys.readouterr().out.splitlines()
            if "Dice:" in ln]
    assert len(scores) == 2 and len(ours) == len(ref) == 3
    assert ours == ref


def test_registration_api_matches_jax(joint_checkpoint):
    """register_pair and build_joint_register_fn give JAX's
    build_joint_register_fn outputs; resolve_registration_model passes the
    joint model through (inshape re-targets only the VxmDense family), as
    it does any other class; enable_fast_warp passes it through."""
    path, files = joint_checkpoint
    jm, params = jax_load_model(path)
    model = modelio.load_model(path, device="cpu")
    assert registration.resolve_registration_model(model, inshape=(8, 8, 8)) is model
    assert jax_registration.resolve_registration_model(jm, params, inshape=(8, 8, 8))[0] is jm
    assert registration.enable_fast_warp(model) is model
    template = TemplateCreation(SHAPE, nb_unet_features=[[4], [4]])
    assert registration.resolve_registration_model(template, inshape=(8, 8, 8)) is template
    jax_template = JaxTemplate(SHAPE, nb_unet_features=[[4], [4]])
    assert jax_registration.resolve_registration_model(jax_template, {}, (8, 8, 8))[0] \
        is jax_template

    mv, fx = (np.load(f)["vol"][None, ..., None].astype(np.float32) for f in files[:2])
    hyp = np.full((1, 1), 0.3, np.float32)
    ref_moved, ref_warp = jax_registration.build_joint_register_fn(jm)(params, hyp, mv, fx)
    moved, warp = registration.register_pair(model, mv, fx, hyper=0.3)
    assert_rel_close(warp, np.asarray(ref_warp), FIT_RTOL, "warp")
    assert_rel_close(moved, np.asarray(ref_moved), FIT_RTOL, "moved")
    fn_moved, fn_warp = registration.build_joint_register_fn(model)(
        torch.from_numpy(hyp), torch.from_numpy(mv), torch.from_numpy(fx))
    np.testing.assert_array_equal(fn_warp.numpy(), warp)
    np.testing.assert_array_equal(fn_moved.numpy(), moved)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port-saved HyperVxmJoint (the port's seeded init) loads in JAX's
    load_model, and JAX's forward of it gives the port's."""
    model = HyperVxmJoint(**CFG, generator=torch.Generator().manual_seed(3)).eval()
    path = str(tmp_path / "port.npz")
    modelio.save_model(path, model)
    jm, params = jax_load_model(path)
    assert type(jm).__name__ == "HyperVxmJoint" and tuple(jm.aff_enc_nf) == (4,)
    ours = modelio.params_to_jax(dict(model.named_parameters()))
    for key, val in flatten(jax.device_get(params)).items():
        np.testing.assert_array_equal(val, ours[key], err_msg=key)
    mv, fx = (np.load(f)["vol"][None, ..., None].astype(np.float32)
              for f in _scans(tmp_path)[:2])
    hyp = np.full((1, 1), 0.5, np.float32)
    ref = jm.apply({"params": unflatten(ours)}, hyp, mv, fx)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (hyp, mv, fx)))
    assert_rel_close(out["tot_1"].numpy(), np.asarray(ref["tot_1"]), FIT_RTOL, "tot_1")
