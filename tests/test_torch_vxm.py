"""The PyTorch VxmDense serving path against the JAX package on the CPU.

JAX params are carried across with ``params_from_jax``; inputs come from
numpy seeds. In float32, tolerances are 1e-4 absolute on images in [0, 1]
and on U-Net features, and 1e-3 absolute on flows in voxels (measured:
<= 5e-6 on images, <= 2e-6 on features, <= 9e-6 on flows of up to 3.9
voxels; convolutions sum in another order on the two sides). Every compared
pos_flow is at least half a voxel in size, so a zero, sign-flipped or
misplaced flow fails. The bfloat16 tolerances are in their own test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelmorph_tpu.models import VxmDense as JaxVxmDense
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models.unet import build_feature_lists as jax_build_feature_lists
from voxelmorph_tpu.registration import register_pair as jax_register_pair
from voxelmorph_tpu.registration import resolve_registration_model as jax_resolve
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.models.modelio import load_model, params_from_jax, read_checkpoint
from voxelmorph_tpu_torch.models.unet import build_feature_lists
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.py.utils import load_volfile
from voxelmorph_tpu_torch.registration import register_pair, resolve_registration_model

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "artifacts_r4",
                          "probs_ncc_0050.npz")
IMAGE_TOL = 1e-4
FEATURE_TOL = 1e-4
FLOW_TOL = 1e-3
MIN_FLOW = 0.5  # voxels: the least max|pos_flow| a comparison may rest on
IMAGE_KEYS = ("y_source", "y_target")
FEATURE_KEYS = ("unet_out",)
FLOW_KEYS = ("pos_flow", "neg_flow", "preint_flow", "postint_flow", "svf", "flow_params")


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(size=(1, *shape, 1)).astype(np.float32) for _ in range(2))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "||"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _compare(jax_out, torch_out):
    for key in ("pos_flow", "neg_flow"):
        if key in jax_out:
            assert np.abs(np.asarray(jax_out[key])).max() >= MIN_FLOW, key
    compared = 0
    for keys, tol in ((IMAGE_KEYS, IMAGE_TOL), (FEATURE_KEYS, FEATURE_TOL),
                      (FLOW_KEYS, FLOW_TOL)):
        for key in keys:
            if key in jax_out:
                np.testing.assert_allclose(torch_out[key].numpy(), np.asarray(jax_out[key]),
                                           rtol=0, atol=tol, err_msg=key)
                compared += 1
    return compared


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_probs=True, bidir=True),
    dict(svf_resolution=2, reg_field="warp"),
], ids=["plain", "probs-bidir", "svf2"])
def test_small_random_vxm_matches_jax(kw):
    shape = (32, 32, 32)
    cfg = dict(inshape=shape, nb_unet_features=[[4, 8], [8, 4]], int_steps=2, **kw)
    src, trg = _pair(1, shape)
    jm = JaxVxmDense(**cfg)
    params = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(trg))["params"])
    # the flow head's own init, N(0, 1e-5), gives flows of ~1e-4 voxels;
    # N(0, 0.3) gives flows of a few voxels, which the comparison can see
    kernel = params["flow"]["kernel"]
    params["flow"] = dict(params["flow"], kernel=jnp.asarray(
        np.random.default_rng(3).normal(0.0, 0.3, kernel.shape).astype(np.float32)))
    ref = jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(trg), train=False)

    model = VxmDense(**cfg).eval()
    model.load_state_dict(params_from_jax(_flatten(params)))
    with torch.inference_mode():
        out = model(torch.from_numpy(src), torch.from_numpy(trg))
    assert _compare(ref, out) >= 6
    np.testing.assert_allclose(out["reg"].numpy(), np.asarray(ref["reg"]), rtol=0, atol=FLOW_TOL)


def test_checkpoint_matches_jax():
    """The committed full-width checkpoint, in float32, re-targeted to 32^3."""
    shape = (32, 32, 32)
    src, trg = _pair(2, shape)
    jm, jp = jax_load_model(CHECKPOINT)
    jm, jp = jax_resolve(jm.clone(dtype=jnp.float32), jp, shape)
    ref = jm.apply({"params": jp}, jnp.asarray(src), jnp.asarray(trg), train=False)

    model = resolve_registration_model(
        load_model(CHECKPOINT, device="cpu", dtype=torch.float32), shape)
    with torch.inference_mode():
        out = model(torch.from_numpy(src), torch.from_numpy(trg))
    assert _compare(ref, out) == 7


# bfloat16: both sides round every conv output and bias add to bfloat16, but
# the convolutions accumulate in another order, so single roundings differ
# by one bf16 step and the differences grow through the U-Net. Measured at
# 32^3: 6.7e-3 voxels on pos_flow, 4.0e-3 on y_source. The tolerances sit
# between that and the bfloat16-vs-float32 gap of the JAX package itself
# (3.7e-2 and 2.6e-2), so a model that skips or misplaces a cast fails.
BF16_FLOW_TOL = 1.5e-2
BF16_IMAGE_TOL = 1e-2


def test_checkpoint_bfloat16_matches_jax():
    """The committed checkpoint in its own dtype (bfloat16), at 32^3."""
    shape = (32, 32, 32)
    src, trg = _pair(2, shape)
    jm, jp = jax_load_model(CHECKPOINT)
    assert jm.dtype == jnp.bfloat16
    refs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        m, p = jax_resolve(jm.clone(dtype=dt), jp, shape)
        refs[dt] = m.apply({"params": p}, jnp.asarray(src), jnp.asarray(trg), train=False)

    model = resolve_registration_model(load_model(CHECKPOINT, device="cpu"), shape)
    assert model.dtype == torch.bfloat16
    with torch.inference_mode():
        out = model(torch.from_numpy(src), torch.from_numpy(trg))
    for key, tol in (("pos_flow", BF16_FLOW_TOL), ("y_source", BF16_IMAGE_TOL)):
        ref = np.asarray(refs[jnp.bfloat16][key], dtype=np.float32)
        gap = np.abs(np.asarray(refs[jnp.float32][key]) - ref).max()
        assert gap > 2 * tol, (key, gap)  # the tolerance can tell the dtypes apart
        np.testing.assert_allclose(out[key].numpy(), ref, rtol=0, atol=tol, err_msg=key)


def test_load_model_reads_config():
    name, config, flat = read_checkpoint(CHECKPOINT)
    assert name == "VxmDense" and not any(k.startswith("__") for k in flat)
    model = load_model(CHECKPOINT, device="cpu")
    assert model.inshape == (160, 192, 224) and model.dtype == torch.bfloat16
    assert model.use_probs and model.int_steps == 7 and model.int_resolution == 2
    state = params_from_jax(flat)
    k = flat["unet||enc_conv_0_0||conv||kernel"]  # (3, 3, 3, ci, co)
    w = state["unet.enc_conv_0_0.conv.weight"].numpy()  # (co, ci, 3, 3, 3)
    assert w.shape == (16, 2, 3, 3, 3)
    np.testing.assert_array_equal(w[5, 1, 0, 2, 1], k[0, 2, 1, 1, 5])


@pytest.mark.parametrize("spec", [None, (8, 3), ([4, 8, 8], [8, 8, 4, 4])])
def test_build_feature_lists_matches_jax(spec):
    if isinstance(spec, tuple) and isinstance(spec[0], int):
        args = dict(nb_features=spec[0], nb_levels=spec[1], feat_mult=2)
    else:
        args = dict(nb_features=None if spec is None else list(spec))
    assert build_feature_lists(**args) == jax_build_feature_lists(**args)


def _blob_scans(tmp_path, shape=(16, 16, 16)):
    """Two Gaussian-blob scans, as in the repository's verification recipe."""
    rng = np.random.default_rng(1)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in shape], indexing="ij")
    files = []
    for i in range(2):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        path = tmp_path / f"scan{i}.npz"
        np.savez(path, vol=np.exp(-d2 / 18).astype(np.float32), seg=(d2 < 9).astype(np.int32))
        files.append(str(path))
    return files


def test_cli_register_matches_jax(tmp_path):
    """The port's register CLI against the JAX register_pair, on the committed
    checkpoint's weights saved at 16^3 in float32."""
    moving, fixed = _blob_scans(tmp_path)
    jm, jp = jax_load_model(CHECKPOINT)
    jm = jm.clone(inshape=(16, 16, 16), dtype=jnp.float32)
    ckpt = str(tmp_path / "model.npz")
    jax_save_model(ckpt, jm, jp)

    out_moved, out_warp = str(tmp_path / "moved.nii.gz"), str(tmp_path / "warp.nii.gz")
    register_cli.main(["--moving", moving, "--fixed", fixed, "--model", ckpt,
                       "--moved", out_moved, "--warp", out_warp, "--device", "cpu"])

    mv = load_volfile(moving, add_batch_axis=True, add_feat_axis=True)
    fx = load_volfile(fixed, add_batch_axis=True, add_feat_axis=True)
    ref_moved, ref_warp = jax_register_pair(*jax_load_model(ckpt), mv, fx)
    np.testing.assert_allclose(load_volfile(out_moved), np.squeeze(ref_moved),
                               rtol=0, atol=IMAGE_TOL)
    np.testing.assert_allclose(load_volfile(out_warp), np.squeeze(ref_warp),
                               rtol=0, atol=FLOW_TOL)
    # the port's API gives the same arrays as its CLI wrote
    moved, warp = register_pair(load_model(ckpt, device="cpu"), mv, fx)
    np.testing.assert_array_equal(np.squeeze(moved), load_volfile(out_moved))
    assert warp.shape == (1, 16, 16, 16, 3)
