"""The port's affine algebra, affine ``transform``, ``compose`` and warp CLI
against the JAX package on the CPU.

Inputs are made with numpy from seeds. Tolerances, each relative to the
largest magnitude of the compared quantity: 1e-5 on values and 1e-4 on
gradients (float32; the matrix products and scatter-adds sum in other
orders). The warp CLI is held to ``scripts/warp.py`` on the blob volumes of
the repository's verification recipe.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu.ops import affine as jax_affine
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu.py.utils import load_volfile as jax_load_volfile
from voxelmorph_tpu_torch.cli import warp as warp_cli
from voxelmorph_tpu_torch.ops import affine, warp
from voxelmorph_tpu_torch.py.utils import load_volfile, save_volfile

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _affine(seed, ndims, rows=None, scale=0.1, shift=2.0):
    """A random affine near the identity, ``(rows, ndims + 1)``."""
    rng = np.random.default_rng(seed)
    rows = ndims if rows is None else rows
    mat = np.eye(ndims + 1, dtype=np.float32)[:rows]
    mat[:ndims, :ndims] += scale * rng.normal(size=(ndims, ndims))
    mat[:ndims, -1] = shift * rng.normal(size=ndims)
    return mat.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_matrix_helpers_match_jax():
    rng = np.random.default_rng(0)
    for ndims in (2, 3):
        for rows in (ndims, ndims + 1):
            mat = _affine(ndims + rows, ndims, rows)
            batch = np.stack([mat, _affine(7, ndims, rows)])
            for name in ("make_square_affine", "affine_add_identity", "affine_remove_identity",
                         "invert_affine"):
                for m in (mat, batch):
                    ref = np.asarray(getattr(jax_affine, name)(jnp.asarray(m)))
                    ours = getattr(affine, name)(_t(m)).numpy()
                    assert ours.shape == ref.shape, name
                    assert_rel_close(ours, ref, OUT_RTOL, name)
            factor = float(rng.uniform(0.5, 2))
            assert_rel_close(affine.rescale_affine(_t(mat), factor).numpy(),
                             np.asarray(jax_affine.rescale_affine(jnp.asarray(mat), factor)),
                             OUT_RTOL, "rescale_affine")
    assert affine.is_affine_shape((3, 4)) and affine.is_affine_shape((4, 4))
    assert affine.is_affine_shape((2, 3)) and not affine.is_affine_shape((8, 8, 3))
    assert not affine.is_affine_shape((5, 1))
    for bad in ((3, 5), (2, 4), (5, 4)):
        with pytest.raises(ValueError):
            affine.is_affine_shape(bad)
        with pytest.raises(ValueError):
            jax_affine.is_affine_shape(bad)


@pytest.mark.parametrize("ndims,rows,shift_center,batch,warp_right", [
    (2, 2, True, (), False), (2, 3, False, (), False), (3, 3, True, (), False),
    (3, 4, False, (), False), (3, 3, True, (2,), False), (3, 4, False, (2, 2), False),
    (3, 3, True, (), True), (2, 2, False, (2,), True)])
def test_affine_to_dense_shift_matches_jax(ndims, rows, shift_center, batch, warp_right):
    shape = (7, 6, 5)[:ndims]
    mats = np.stack([_affine(i, ndims, rows) for i in range(int(np.prod(batch)))]) \
        .reshape(*batch, rows, ndims + 1)
    right = None
    if warp_right:
        right = np.random.default_rng(5).normal(size=(*batch, *shape, ndims)).astype(np.float32)
    ref = jax_affine.affine_to_dense_shift(
        jnp.asarray(mats), shape, shift_center=shift_center,
        warp_right=None if right is None else jnp.asarray(right))
    ours = affine.affine_to_dense_shift(_t(mats), shape, shift_center=shift_center,
                                        warp_right=None if right is None else _t(right))
    assert tuple(ours.shape) == (*batch, *shape, ndims) == ref.shape
    assert_rel_close(ours.numpy(), np.asarray(ref), OUT_RTOL)
    with pytest.raises(ValueError, match="does not match"):
        affine.affine_to_dense_shift(_t(mats), (4,) * (5 - ndims))


@pytest.mark.parametrize("rows", [3, 4])
@pytest.mark.parametrize("shift_center,shape", [(True, None), (False, None),
                                                (False, (9, 7, 8))])
@pytest.mark.parametrize("channel_axis", [True, False])
def test_transform_with_an_affine_matches_jax(rows, shift_center, shape, channel_axis):
    """Values and gradients in the volume and the matrix; ``shape`` resizes
    the output grid; a volume without a channel axis comes back without one."""
    rng = np.random.default_rng(rows)
    vol = rng.normal(size=(8, 9, 7, 2) if channel_axis else (8, 9, 7)).astype(np.float32)
    mat = _affine(rows, 3, rows, scale=0.15, shift=1.5)
    w = rng.normal(size=((*shape,) if shape else vol.shape[:3]) + vol.shape[3:])
    w = w.astype(np.float32)

    def jfn(v, m):
        return jnp.sum(jax_warp.transform(v, m, shift_center=shift_center, shape=shape) * w)

    ref, (ref_dv, ref_dm) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(vol),
                                                                    jnp.asarray(mat))
    ref_out = jax_warp.transform(jnp.asarray(vol), jnp.asarray(mat),
                                 shift_center=shift_center, shape=shape)
    v, m = _t(vol).requires_grad_(), _t(mat).requires_grad_()
    out = warp.transform(v, m, shift_center=shift_center, shape=shape)
    dv, dm = torch.autograd.grad((out * _t(w)).sum(), (v, m))
    assert tuple(out.shape) == ref_out.shape
    assert_rel_close(out.detach().numpy(), np.asarray(ref_out), OUT_RTOL, "values")
    assert_rel_close(dv.numpy(), np.asarray(ref_dv), GRAD_RTOL, "d vol")
    assert_rel_close(dm.numpy(), np.asarray(ref_dm), GRAD_RTOL, "d matrix")


def test_transform_refuses_shape_with_shift_center():
    vol, mat = torch.zeros(4, 4, 4, 1), _t(_affine(0, 3))
    with pytest.raises(ValueError, match="shift_center"):
        warp.transform(vol, mat, shape=(4, 4, 4))
    with pytest.raises(ValueError, match="shift_center"):
        jax_warp.transform(jnp.zeros((4, 4, 4, 1)), jnp.asarray(_affine(0, 3)), shape=(4, 4, 4))


def _dense(seed, shape, ndims, scale):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(*shape, ndims))).astype(np.float32)


COMPOSE_CASES = {
    # affine-affine stays a matrix
    "affine-affine": lambda: [_affine(1, 3), _affine(2, 3, 4)],
    # a dense transform densifies the affine on its right
    "affine-dense": lambda: [_affine(3, 3, scale=0.05, shift=0.7), _dense(4, (7, 8, 6), 3, 0.8)],
    # an affine on the left folds the dense transform through warp_right
    "dense-affine": lambda: [_dense(5, (7, 8, 6), 3, 0.8), _affine(6, 3, 4, scale=0.05)],
    "dense-dense": lambda: [_dense(7, (7, 8, 6), 3, 0.8), _dense(8, (7, 8, 6), 3, 0.8)],
    "dense-affine-dense": lambda: [_dense(9, (7, 8, 6), 3, 0.6), _affine(10, 3, scale=0.05),
                                   _dense(11, (7, 8, 6), 3, 0.6)],
}


@pytest.mark.parametrize("case", list(COMPOSE_CASES))
def test_compose_matches_jax(case):
    trfs = COMPOSE_CASES[case]()
    w = np.random.default_rng(12).normal(size=jax_warp.compose(
        [jnp.asarray(t) for t in trfs]).shape).astype(np.float32)
    ref = jax_warp.compose([jnp.asarray(t) for t in trfs])
    ref_grads = jax.grad(lambda ts: jnp.sum(jax_warp.compose(ts) * w))(
        [jnp.asarray(t) for t in trfs])
    ts = [_t(t).requires_grad_() for t in trfs]
    ours = warp.compose(ts)
    grads = torch.autograd.grad((ours * _t(w)).sum(), ts)
    assert tuple(ours.shape) == ref.shape
    assert_rel_close(ours.detach().numpy(), np.asarray(ref), OUT_RTOL, "values")
    for i, (g, rg) in enumerate(zip(grads, ref_grads)):
        assert_rel_close(g.numpy(), np.asarray(rg), GRAD_RTOL, f"gradient {i}")
    with pytest.raises(ValueError, match="empty"):
        warp.compose([])


def _blob_files(tmp_path):
    """Two blob scans of the verification recipe, a dense warp as NIfTI with
    an affine of its own, and 3x4 and 4x4 affine matrices as npy."""
    rng = np.random.default_rng(1)
    shape = (16, 16, 16)
    g = np.meshgrid(*[np.arange(s, dtype=float) for s in shape], indexing="ij")
    files = []
    for i in range(2):
        c = [8 + rng.uniform(-2.5, 2.5) for _ in range(3)]
        d2 = sum((x - cc) ** 2 for x, cc in zip(g, c))
        path = str(tmp_path / f"scan{i}.npz")
        np.savez(path, vol=np.exp(-d2 / 18).astype(np.float32), seg=(d2 < 9).astype(np.int32))
        files.append(path)
    nifti_affine = np.diag([1.5, 1.0, 2.0, 1.0])
    nifti_affine[:3, 3] = [4.0, -3.0, 7.5]
    save_volfile(_dense(2, shape, 3, 1.7), str(tmp_path / "warp.nii.gz"), nifti_affine)
    np.save(tmp_path / "affine34.npy", _affine(3, 3, scale=0.1, shift=1.5))
    np.save(tmp_path / "affine44.npy", _affine(4, 3, 4, scale=0.1, shift=1.5))
    return files, nifti_affine


def _jax_warp_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_warp_script", os.path.join(ROOT, "scripts", "warp.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("warp_file", ["warp.nii.gz", "affine34.npy", "affine44.npy"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_warp_cli_matches_the_jax_script(tmp_path, warp_file, interp):
    files, nifti_affine = _blob_files(tmp_path)
    jax_out, ours = str(tmp_path / "jax.nii.gz"), str(tmp_path / "ours.nii.gz")
    args = ["--moving", files[0], "--warp", str(tmp_path / warp_file), "--interp", interp]
    _jax_warp_script().main([*args, "--moved", jax_out])
    warp_cli.main([*args, "--moved", ours, "--device", "cpu"])
    ref, ref_affine = jax_load_volfile(jax_out, ret_affine=True)
    out, out_affine = load_volfile(ours, ret_affine=True)
    assert out.shape == ref.shape == (16, 16, 16)
    if interp == "nearest":
        # a coordinate within rounding of .5 may pick the other neighbour
        assert np.mean(out == ref) >= 0.999
    else:
        assert_rel_close(out, ref, OUT_RTOL)
    np.testing.assert_allclose(out_affine, ref_affine)
    if warp_file.endswith(".nii.gz"):
        np.testing.assert_allclose(out_affine, nifti_affine)
    # the transform moved the image
    assert np.abs(out - load_volfile(files[0])).max() > 0.1


def test_warp_cli_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the GPU default runs")
    files, _ = _blob_files(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warp_cli.main(["--moving", files[0], "--warp", str(tmp_path / "affine34.npy"),
                       "--moved", str(tmp_path / "out.nii.gz")])
