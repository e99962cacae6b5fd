"""The port's layers, affine parameter algebra, augmentation and image ops,
and small interp/model helpers against the JAX package on the CPU.

Inputs are made with numpy from seeds. The random draws of the JAX package
are repeated here (its key splits and ``jax.random`` calls, read from its
source) and fed to the port's deterministic maps, which must give the JAX
function's result exactly. Tolerances, relative to the largest magnitude of
the compared quantity: exact where both sides take the same float32
operations in the same order; ``MATH_RTOL`` (1e-6) where the two libraries'
trigonometric, square-root or small matrix routines may round differently;
``WARP_RTOL`` (1e-5) on warps, resizes and integrations, whose sums and
matrix products run in other orders; ``SOLVE_RTOL`` (1e-5) on results of
matrix inversions and factorisations iterated or chained (Cholesky, then
an inverse and an angle decomposition; 20 Denman-Beavers inversions).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu import layers as jlayers
from voxelmorph_tpu.models import vxm as jvxm
from voxelmorph_tpu.ops import affine as jaffine
from voxelmorph_tpu.ops import augment as jaugment
from voxelmorph_tpu.ops import image as jimage
from voxelmorph_tpu.ops import interp as jinterp
from voxelmorph_tpu_torch import layers
from voxelmorph_tpu_torch.models import vxm
from voxelmorph_tpu_torch.ops import affine, augment, image, interp

MATH_RTOL = 1e-6
WARP_RTOL = 1e-5
SOLVE_RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _same(got, ref):
    assert np.array_equal(_np(got), np.asarray(ref)), (got, ref)


def _params(seed, ndims, batch=(4,)):
    """Random (shift, rot, scale, shear) params near the identity."""
    rng = np.random.default_rng(seed)
    n_rot = 1 if ndims == 2 else 3
    shift = rng.normal(scale=3, size=(*batch, ndims))
    rot = rng.uniform(-40, 40, size=(*batch, n_rot))
    scale = 1 + rng.normal(scale=0.1, size=(*batch, ndims))
    shear = rng.normal(scale=0.05, size=(*batch, n_rot))
    return np.concatenate([shift, rot, scale, shear], -1).astype(np.float32)


@pytest.mark.parametrize("ndims", [2, 3])
@pytest.mark.parametrize("deg", [True, False])
def test_angles_to_rotation_matrix_matches_jax(ndims, deg):
    rng = np.random.default_rng(ndims)
    n = 1 if ndims == 2 else 3
    for ang in (rng.uniform(-90, 90, size=(5, n)).astype(np.float32),
                rng.uniform(-90, 90, size=(2, 3, n - 1 or 1)).astype(np.float32),
                np.float32(30.0), [10.0] * n):
        got = affine.angles_to_rotation_matrix(ang if isinstance(ang, list) else
                                               torch.as_tensor(ang), deg=deg, ndims=ndims)
        ref = jaffine.angles_to_rotation_matrix(ang if isinstance(ang, list) else
                                                jnp.asarray(ang), deg=deg, ndims=ndims)
        assert got.shape == ref.shape
        assert_rel_close(_np(got), ref, MATH_RTOL, "rotation")


@pytest.mark.parametrize("ndims", [2, 3])
@pytest.mark.parametrize("shift_scale,last_row,keep", [(False, False, None), (True, True, None),
                                                       (False, True, 4), (True, False, 1)])
def test_params_to_affine_matrix_matches_jax(ndims, shift_scale, last_row, keep):
    par = _params(ndims, ndims)
    if shift_scale:
        par[..., -2 * (ndims - 1) - ndims:-(1 if ndims == 2 else 3)] -= 1
    if keep is not None:
        par = par[..., :keep]
    got = affine.params_to_affine_matrix(torch.as_tensor(par), shift_scale=shift_scale,
                                         last_row=last_row, ndims=ndims)
    ref = jaffine.params_to_affine_matrix(jnp.asarray(par), shift_scale=shift_scale,
                                          last_row=last_row, ndims=ndims)
    assert got.shape == ref.shape
    assert_rel_close(_np(got), ref, MATH_RTOL, "params_to_affine_matrix")


@pytest.mark.parametrize("ndims", [2, 3])
def test_matrix_to_params_round_trip_matches_jax(ndims):
    """rotation_matrix_to_angles and affine_matrix_to_params (with a
    negative determinant and a gimbal-locked rotation) against JAX."""
    par = _params(ndims + 10, ndims)
    par[0, ndims + (1 if ndims == 2 else 3)] *= -1  # a reflection
    mat = jaffine.params_to_affine_matrix(jnp.asarray(par), ndims=ndims)
    got = affine.affine_matrix_to_params(torch.as_tensor(np.array(mat)))
    ref = jaffine.affine_matrix_to_params(mat)
    assert_rel_close(_np(got), ref, SOLVE_RTOL, "affine_matrix_to_params")
    rots = [np.asarray(jaffine.angles_to_rotation_matrix(
        jnp.asarray(par[:, ndims:ndims + (1 if ndims == 2 else 3)]), ndims=ndims))]
    if ndims == 3:
        rots.append(np.asarray(jaffine.angles_to_rotation_matrix(
            jnp.asarray([[20.0, 90.0, 15.0]]), ndims=3)))
    for rot in rots:
        got = affine.rotation_matrix_to_angles(torch.as_tensor(rot))
        ref = jaffine.rotation_matrix_to_angles(jnp.asarray(rot))
        assert_rel_close(_np(got), ref, SOLVE_RTOL, "rotation_matrix_to_angles")


@pytest.mark.parametrize("weighted", [None, "flat", "channel"])
def test_fit_affine_matches_jax(weighted):
    rng = np.random.default_rng(5)
    target = rng.normal(scale=10, size=(2, 30, 3)).astype(np.float32)
    mat = np.asarray(jaffine.params_to_affine_matrix(jnp.asarray(_params(7, 3, (2,)))))
    source = (np.einsum("bij,bmj->bmi", mat[..., :-1], target) + mat[:, None, :, -1]
              + rng.normal(scale=0.1, size=target.shape)).astype(np.float32)
    w = None
    if weighted:
        w = rng.uniform(0.5, 1.5, size=(2, 30) if weighted == "flat" else (2, 30, 1))
        w = w.astype(np.float32)
    got = affine.fit_affine(torch.as_tensor(source), torch.as_tensor(target),
                            None if w is None else torch.as_tensor(w))
    ref = jaffine.fit_affine(jnp.asarray(source), jnp.asarray(target),
                             None if w is None else jnp.asarray(w))
    assert_rel_close(_np(got), ref, SOLVE_RTOL, "fit_affine")


@pytest.mark.parametrize("shape,shift_center,last_row", [((8, 9, 10), True, True),
                                                         ((8, 9, 10), False, False),
                                                         ((12, 7), False, True)])
def test_flip_matrix_from_jax_draws(shape, shift_center, last_row):
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        bits = (jax.random.normal(key, (len(shape),)) > 0).astype(jnp.float32)
        got = augment.flip_matrix_from_bits(torch.as_tensor(np.asarray(bits)), shape,
                                            shift_center, last_row)
        _same(got, jaugment.draw_flip_matrix(key, shape, shift_center, last_row))
    got = augment.draw_flip_matrix(torch.Generator().manual_seed(0), shape, shift_center,
                                   last_row)
    assert got.shape == (len(shape) + last_row, len(shape) + 1)
    assert set(np.abs(np.diag(_np(got)[:len(shape)])).tolist()) == {1.0}


@pytest.mark.parametrize("ndims,last_row", [(3, True), (2, False), (3, False)])
def test_swap_matrix_from_jax_draws(ndims, last_row):
    for seed in range(4):
        ref = np.asarray(jaugment.draw_swap_matrix(jax.random.PRNGKey(seed), ndims, last_row))
        perm = torch.as_tensor(np.argmax(ref[:ndims, :ndims], axis=1))
        _same(augment.swap_matrix_from_permutation(perm, ndims, last_row), ref)
    got = _np(augment.draw_swap_matrix(torch.Generator().manual_seed(1), ndims, last_row))
    assert np.array_equal(np.sort(got[:ndims, :ndims], axis=0)[::-1][0], np.ones(ndims))


@pytest.mark.parametrize("ndims", [2, 3])
@pytest.mark.parametrize("normal,shift_scale,concat", [(False, False, True), (True, True, True),
                                                       (True, False, False)])
def test_affine_params_from_jax_draws(ndims, normal, shift_scale, concat):
    """The JAX function's draws (its four key splits, uniform in [-1, 1) or
    normal, the scales' normal truncated at 2) through the port's map give
    the JAX function's params."""
    n = 1 if ndims == 2 else 3
    lims = dict(shift=[5.0] * ndims, rot=20.0, scale=0.1, shear=[0.02] * n)
    normals = dict(normal_shift=normal, normal_rot=False, normal_scale=normal,
                   normal_shear=normal)
    key = jax.random.PRNGKey(ndims + 2 * normal)
    keys = dict(zip(("shift", "rot", "scale", "shear"), jax.random.split(key, 4)))
    draws = {}
    for k, m in dict(shift=ndims, rot=n, scale=ndims, shear=n).items():
        shape = (3, m)
        if normals[f"normal_{k}"] and k == "scale":
            d = jax.random.truncated_normal(keys[k], -2.0, 2.0, shape, jnp.float32)
        elif normals[f"normal_{k}"]:
            d = jax.random.normal(keys[k], shape, jnp.float32)
        else:
            d = jax.random.uniform(keys[k], shape, jnp.float32, minval=-1.0, maxval=1.0)
        draws[k] = torch.as_tensor(np.asarray(d))
    got = augment.affine_params_from_draws(draws, shift_scale=shift_scale, ndims=ndims,
                                           concat=concat, **lims)
    ref = jaugment.draw_affine_params(key, shift_scale=shift_scale, ndims=ndims,
                                      batch_shape=(3,), concat=concat, **lims, **normals)
    for g, r in zip(got if not concat else [got], ref if not concat else [ref]):
        _same(g, r)
    drawn = augment.draw_affine_params(torch.Generator().manual_seed(3), ndims=ndims,
                                       batch_shape=(3,), shift_scale=shift_scale, **lims,
                                       **normals, concat=True)
    assert drawn.shape == (3, 2 * ndims + 2 * n)
    if not normal:
        assert drawn[:, :ndims].abs().max() <= 5.0


@pytest.mark.parametrize("sigma,shape", [(1.0, (9, 10, 11, 2)), (0.7, (12, 13, 1)),
                                         (2.5, (8, 9, 7, 1))])
def test_gaussian_blur_matches_jax(sigma, shape):
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    got = image.gaussian_blur(torch.as_tensor(x), sigma)
    ref = jimage.gaussian_blur(jnp.asarray(x), sigma)
    assert_rel_close(_np(got), ref, MATH_RTOL, "gaussian_blur")
    got = image.gaussian_blur(torch.as_tensor(x), torch.tensor(sigma / 2), max_sigma=sigma)
    ref = jimage.gaussian_blur(jnp.asarray(x), jnp.float32(sigma / 2), max_sigma=sigma)
    assert_rel_close(_np(got), ref, MATH_RTOL, "gaussian_blur, a tensor sigma")


@pytest.mark.parametrize("scales,isotropic,nch", [([4, 8], True, 1), (2, False, 3),
                                                  ([1, 16], True, 2)])
def test_multiscale_noise_from_jax_draws(scales, isotropic, nch):
    shape, max_std = (10, 12, 9), 2.0
    key = jax.random.PRNGKey(7)
    draws, k = [], key
    for scale in (scales if isinstance(scales, list) else [scales]):
        k, k_std, k_noise = jax.random.split(k, 3)
        small = tuple(max(int(math.ceil(s / scale)), 2) for s in shape)
        std_shape = (1,) * (len(shape) + 1) if isotropic else (1, 1, 1, nch)
        std = jax.random.uniform(k_std, std_shape, jnp.float32, 0.0, max_std)
        noise = jax.random.normal(k_noise, (*small, nch), jnp.float32)
        draws.append((torch.as_tensor(np.asarray(std)), torch.as_tensor(np.asarray(noise))))
    got = image.multiscale_noise_from_draws(draws, shape)
    ref = jimage.draw_multiscale_noise(key, shape, scales, max_std, nch, isotropic)
    assert got.shape == ref.shape
    assert_rel_close(_np(got), ref, WARP_RTOL, "multiscale noise")
    drawn = image.draw_multiscale_noise(torch.Generator().manual_seed(0), shape, scales,
                                        max_std, nch, isotropic)
    assert drawn.shape == (*shape, nch) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("normalize,shift_center", [(True, True), (False, False), (True, False)])
def test_barycenter_matches_jax(normalize, shift_center):
    feat = np.random.default_rng(2).uniform(size=(2, 7, 8, 9, 3)).astype(np.float32) ** 4
    got = image.barycenter(torch.as_tensor(feat), normalize, shift_center)
    ref = jimage.barycenter(jnp.asarray(feat), normalize, shift_center)
    assert_rel_close(_np(got), ref, MATH_RTOL, "barycenter")


def test_sqrtm_matches_jax():
    mat = np.asarray(jaffine.params_to_affine_matrix(jnp.asarray(_params(3, 3, (3,))),
                                                     last_row=True))
    got = image.sqrtm(torch.as_tensor(mat))
    ref = jimage.sqrtm(jnp.asarray(mat))
    assert_rel_close(_np(got), ref, SOLVE_RTOL, "sqrtm")
    assert_rel_close(_np(got @ got), mat, SOLVE_RTOL, "sqrtm squared")


def test_grid_helpers_match_jax():
    for shape in ((4, 5, 6), (7, 3)):
        for g, r in zip(interp.ndgrid(shape, stacked=False), jinterp.ndgrid(shape, stacked=False)):
            _same(g, r)
        for g, r in zip(interp.volshape_to_meshgrid(shape), jinterp.volshape_to_meshgrid(shape)):
            _same(g, r)
        _same(interp.ndgrid(shape), jinterp.ndgrid(shape))
    with pytest.raises(ValueError):
        interp.volshape_to_meshgrid((3, 3), indexing="xy")
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(6, 7, 8, 2)).astype(np.float32)
    pts = rng.uniform(-1, 8, size=(50, 3)).astype(np.float32)
    for method in ("linear", "nearest"):
        got = interp.point_interpn(torch.as_tensor(vol), torch.as_tensor(pts), method)
        ref = jinterp.point_interpn(jnp.asarray(vol), jnp.asarray(pts), method)
        assert_rel_close(_np(got), ref, MATH_RTOL, f"point_interpn {method}")


@pytest.mark.parametrize("factor", [2.0, 0.5, 1])
def test_rescale_flow_batched_and_single_match_jax(factor):
    flow = np.random.default_rng(6).normal(size=(2, 6, 7, 5, 3)).astype(np.float32)
    got = vxm.rescale_flow(torch.as_tensor(flow), factor)
    ref = jvxm.rescale_flow(jnp.asarray(flow), factor)
    assert_rel_close(_np(got), ref, WARP_RTOL, "rescale_flow batched")
    got = vxm.rescale_flow(torch.as_tensor(flow[0]), factor, batched=False)
    ref = jvxm.rescale_flow(jnp.asarray(flow[0]), factor, batched=False)
    assert_rel_close(_np(got), ref, WARP_RTOL, "rescale_flow single")


def _vol_flow(seed, shape=(9, 10, 8), nch=2, batch=2, scale=1.5):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(batch, *shape, nch)).astype(np.float32)
    flow = rng.normal(scale=scale, size=(batch, *shape, len(shape))).astype(np.float32)
    return vol, flow


def _affines(seed, batch=2, ndims=3, rows=None):
    par = _params(seed, ndims, (batch,))
    par[..., :ndims] *= 0.3
    mat = np.asarray(jaffine.params_to_affine_matrix(jnp.asarray(par), ndims=ndims))
    return mat if rows is None or rows == ndims else np.asarray(
        jaffine.make_square_affine(jnp.asarray(mat)))


def _layer_cases():
    vol, flow = _vol_flow(1)
    aff = _affines(2)
    vel = _vol_flow(3, nch=1, scale=0.3)[1]
    return [
        ("SpatialTransformer dense", dict(), (vol, flow)),
        ("SpatialTransformer nearest", dict(interp_method="nearest"), (vol, flow)),
        ("SpatialTransformer fill", dict(fill_value=0.5), (vol, flow)),
        ("SpatialTransformer single", dict(single_transform=True), (vol, flow)),
        ("SpatialTransformer affine", dict(), (vol, aff)),
        ("SpatialTransformer affine shape", dict(shift_center=False, shape=(7, 8, 6)),
         (vol, aff)),
        ("VecInt ss", dict(int_steps=5), vel),
        ("VecInt quadrature", dict(method="quadrature", int_steps=4), vel),
        ("VecInt ode", dict(method="ode", int_steps=3), vel),
        ("RescaleTransform dense", (2.0,), flow),
        ("RescaleTransform affine", (0.5,), aff),
        ("ComposeTransform", dict(), [aff, flow, _affines(5)]),
        ("AddIdentity flat", (), _params(4, 3, (2,))[:, :12] * 0.1),
        ("AddIdentity flat 2d", (), _params(4, 2, (2,)) * 0.1),
        ("AddIdentity matrices", (), aff - np.eye(3, 4, dtype=np.float32)),
        ("InvertAffine", (), _affines(6, rows=4)),
        ("ParamsToAffineMatrix", dict(last_row=True), _params(8, 3, (2,))),
        ("ParamsToAffineMatrix 2d", dict(ndims=2, deg=False), _params(8, 2, (2,)) * 0.02),
        ("AffineToDenseShift", ((9, 10, 8),), aff),
        ("Resize", (0.5,), vol),
        ("Resize nearest", (2, "nearest"), vol[..., :1]),
    ]


@pytest.mark.parametrize("case", range(len(_layer_cases())),
                         ids=[c[0] for c in _layer_cases()])
def test_layer_matches_jax(case):
    name, cfg, inputs = _layer_cases()[case]
    cls = name.split()[0]
    args, kwargs = (cfg, {}) if isinstance(cfg, tuple) else ((), cfg)
    ours, theirs = getattr(layers, cls)(*args, **kwargs), getattr(jlayers, cls)(*args, **kwargs)
    if isinstance(inputs, tuple):
        got = ours(tuple(torch.as_tensor(x) for x in inputs))
        ref = theirs(tuple(jnp.asarray(x) for x in inputs))
    elif isinstance(inputs, list):
        got = ours([torch.as_tensor(x) for x in inputs])
        ref = theirs([jnp.asarray(x) for x in inputs])
    else:
        got, ref = ours(torch.as_tensor(inputs)), theirs(jnp.asarray(inputs))
    assert tuple(got.shape) == tuple(ref.shape)
    assert_rel_close(_np(got), ref, WARP_RTOL, name)


def test_layers_are_parameterless_modules():
    draw = layers.DrawAffineParams(shift=3.0, rot=10.0, scale=0.1, shear=0.01)
    par = draw(torch.Generator().manual_seed(0), 5)
    assert par.shape == (5, 12) and par[:, :3].abs().max() <= 3.0
    assert layers.VecIntegration is layers.VecInt
    for name in layers.__all__:
        cls = getattr(layers, name)
        assert issubclass(cls, torch.nn.Module) and name in jlayers.__all__
    with pytest.raises(ValueError):
        layers.VecInt()(torch.zeros(1, 4, 4, 4, 2))
