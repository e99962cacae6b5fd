"""The rest of the port's ``ops/warp.py`` against the JAX package on the CPU:
channelwise ``transform`` and ``batch_transform``, every method of
``integrate_vec``, the point-cloud ops and ``jacobian_determinant``.

Inputs are made with numpy from seeds. Tolerances, each relative to the
largest magnitude of the compared quantity: 1e-5 on values and 1e-4 on
gradients (float32; the scatter-adds sum in other orders). ``integrate_vec``
is also held to the golden fixtures as ``tests/test_golden.py`` holds the
JAX package (rtol and atol 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu.py import utils as jax_utils
from voxelmorph_tpu_torch.ops import warp
from voxelmorph_tpu_torch.ops.interp import resize
from voxelmorph_tpu_torch.py import utils

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth(seed, shape, ndims, scale):
    """A smooth random field of about ``scale`` voxels: coarse noise,
    linearly upsampled."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(*[3] * len(shape), ndims)).astype(np.float32)
    field = resize(torch.from_numpy(coarse), [s / 3 for s in shape], new_shape=shape)
    return (scale * field.numpy()).astype(np.float32)


def _value_and_grads(jax_fn, torch_fn, arrays, w):
    """Outputs and gradients of sum(fn(*arrays) * w) on both sides."""
    ref_out, vjp = jax.jit(lambda *a: jax.vjp(jax_fn, *a))(*map(jnp.asarray, arrays))
    ref_grads = vjp(jnp.asarray(w))
    ts = [_t(a).requires_grad_() for a in arrays]
    out = torch_fn(*ts)
    # an input the output does not depend on (nearest's shift) has zeros,
    # as in JAX
    grads = torch.autograd.grad((out * _t(w)).sum(), ts, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ts)]
    return (out.detach().numpy(), [g.numpy() for g in grads],
            np.asarray(ref_out), [np.asarray(g) for g in ref_grads])


@pytest.mark.parametrize("interp,fill", [("linear", None), ("linear", 0.5), ("nearest", None)])
def test_channelwise_transform_matches_jax(interp, fill):
    """(*S, C, N) shifts: each channel is warped by its own field."""
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(7, 8, 6, 3)).astype(np.float32)
    shift = (2.0 * rng.normal(size=(7, 8, 6, 3, 3))).astype(np.float32)
    w = rng.normal(size=vol.shape).astype(np.float32)
    kw = dict(interp_method=interp, fill_value=fill)
    out, grads, ref_out, ref_grads = _value_and_grads(
        lambda v, s: jax_warp.transform(v, s, **kw), lambda v, s: warp.transform(v, s, **kw),
        (vol, shift), w)
    assert out.shape == ref_out.shape == vol.shape
    assert_rel_close(out, ref_out, OUT_RTOL, "values")
    assert_rel_close(grads[0], ref_grads[0], GRAD_RTOL, "d vol")
    if interp == "linear":
        assert_rel_close(grads[1], ref_grads[1], GRAD_RTOL, "d shift")
    else:
        assert not grads[1].any() and not ref_grads[1].any()
    # one channel warped alone by its field gives that channel
    single = warp.transform(_t(vol[..., 1]), _t(shift[..., 1, :]), **kw)
    np.testing.assert_array_equal(single.detach().numpy(), out[..., 1])


@pytest.mark.parametrize("channelwise", [False, True])
def test_batch_transform_matches_jax(channelwise):
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(2, 7, 8, 6, 2)).astype(np.float32)
    shape = (2, 7, 8, 6, 2, 3) if channelwise else (2, 7, 8, 6, 3)
    shift = (2.0 * rng.normal(size=shape)).astype(np.float32)
    w = rng.normal(size=vol.shape).astype(np.float32)
    out, grads, ref_out, ref_grads = _value_and_grads(
        jax_warp.batch_transform, warp.batch_transform, (vol, shift), w)
    assert out.shape == ref_out.shape == vol.shape
    assert_rel_close(out, ref_out, OUT_RTOL, "values")
    assert_rel_close(grads[0], ref_grads[0], GRAD_RTOL, "d vol")
    assert_rel_close(grads[1], ref_grads[1], GRAD_RTOL, "d shift")
    with pytest.raises(ValueError, match="rank"):
        warp.batch_transform(_t(vol), _t(shift[0, ..., 0]))


INTEGRATE_CASES = [
    # (method, nb_steps, time_dep, kwargs)
    ("ss", 7, False, {}),
    ("scaling_and_squaring", 4, False, {}),
    ("ss", 0, False, {}),
    ("ss", 2, True, {}),
    ("quadrature", 5, False, {}),
    ("quadrature", 1, False, {}),
    ("quadrature", 4, True, {}),
    ("ode", 3, False, {}),
    ("ode", 2, False, dict(out_time_pt=0.6)),
]


@pytest.mark.parametrize("method,nb_steps,time_dep,kw", INTEGRATE_CASES,
                         ids=[f"{m}-{n}{'-time_dep' if t else ''}{'-half' if k else ''}"
                              for m, n, t, k in INTEGRATE_CASES])
def test_integrate_vec_matches_jax(method, nb_steps, time_dep, kw):
    shape = (9, 8, 7)
    if time_dep:
        steps = 2 ** nb_steps if method == "ss" else nb_steps
        vec = np.stack([_smooth(10 + i, shape, 3, 2.5) for i in range(steps)])
    else:
        vec = _smooth(3, shape, 3, 3.0)
    w = np.random.default_rng(4).normal(size=vec.shape[-4:]).astype(np.float32)
    kw = dict(kw, method=method, nb_steps=nb_steps, time_dep=time_dep)
    out, grads, ref_out, ref_grads = _value_and_grads(
        lambda v: jax_warp.integrate_vec(v, **kw), lambda v: warp.integrate_vec(v, **kw),
        (vec,), w)
    assert out.shape == ref_out.shape == vec.shape[-4:]
    assert np.abs(ref_out).max() > 1.0  # displacements of voxels
    assert_rel_close(out, ref_out, OUT_RTOL, "values")
    assert_rel_close(grads[0], ref_grads[0], GRAD_RTOL, "d vec")
    # remat changes memory, not values or gradients
    v = _t(vec).requires_grad_()
    plain = warp.integrate_vec(v, remat=False, **kw)
    g_plain, = torch.autograd.grad((plain * _t(w)).sum(), v)
    np.testing.assert_array_equal(plain.detach().numpy(), out)
    np.testing.assert_array_equal(g_plain.numpy(), grads[0])


def test_integrate_vec_raises_where_jax_does():
    vec = torch.zeros(4, 4, 4, 3)
    for kw in (dict(method="ss", nb_steps=-1), dict(method="quadrature", nb_steps=0),
               dict(method="ode", nb_steps=0), dict(method="ode", time_dep=True),
               dict(method="ss", nb_steps=3, time_dep=True)):
        with pytest.raises(AssertionError):
            jax_warp.integrate_vec(jnp.asarray(vec.numpy()), **kw)
        with pytest.raises(ValueError):
            warp.integrate_vec(vec, **kw)
    with pytest.raises(ValueError, match="method"):
        jax_warp.integrate_vec(jnp.zeros((4, 4, 4, 3)), method="euler")
    with pytest.raises(ValueError, match="method"):
        warp.integrate_vec(vec, method="euler")


@pytest.mark.parametrize("method,key", [("ss", "integrate_ss7"),
                                        ("quadrature", "integrate_quad5")])
def test_integrate_vec_matches_the_golden_fixtures(method, key):
    gold = np.load(FIXTURES)
    nb_steps = 7 if method == "ss" else 5
    out = warp.integrate_vec(_t(gold["vec"]), method=method, nb_steps=nb_steps)
    assert np.abs(gold[key]).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), gold[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("extra", [False, True])
def test_point_spatial_transformer_matches_jax(extra):
    rng = np.random.default_rng(5)
    trf = _smooth(6, (9, 8, 7), 3, 2.0)
    pts = rng.uniform(-1.0, [9.0, 8.0, 7.0], size=(40, 3)).astype(np.float32)
    if extra:
        pts = np.concatenate([pts, rng.uniform(size=(40, 1)).astype(np.float32)], -1)
    w = rng.normal(size=pts.shape).astype(np.float32)
    out, grads, ref_out, ref_grads = _value_and_grads(
        lambda p, t: jax_warp.point_spatial_transformer(p, t, sdt_vol_resize=1.5),
        lambda p, t: warp.point_spatial_transformer(p, t, sdt_vol_resize=1.5), (pts, trf), w)
    assert out.shape == ref_out.shape == pts.shape
    assert_rel_close(out, ref_out, OUT_RTOL, "values")
    assert_rel_close(grads[0], ref_grads[0], GRAD_RTOL, "d points")
    assert_rel_close(grads[1], ref_grads[1], GRAD_RTOL, "d trf")
    if extra:
        np.testing.assert_array_equal(out[:, -1], pts[:, -1])
    with pytest.raises(ValueError, match="coordinates"):
        warp.point_spatial_transformer(_t(pts[:, :2]), _t(trf))


@pytest.mark.parametrize("vol_shape,pts_dims,absolute", [
    ((9, 8, 7, 2), 3, True), ((9, 8, 7), 3, False), ((9, 8, 7, 4), 4, True)])
def test_value_at_location_matches_jax(vol_shape, pts_dims, absolute):
    """Points over the spatial axes, over a volume without channels, and
    over every axis (spatial and label): the last gains a singleton axis."""
    rng = np.random.default_rng(7)
    vol = rng.normal(size=vol_shape).astype(np.float32)
    pts = rng.uniform(0.0, np.array(vol_shape[:pts_dims]) - 1, size=(30, pts_dims))
    pts = pts.astype(np.float32)
    kw = dict(force_post_absolute_val=absolute)
    ref = jax_warp.value_at_location(jnp.asarray(vol), jnp.asarray(pts), **kw)
    w = rng.normal(size=ref.shape).astype(np.float32)
    out, grads, ref_out, ref_grads = _value_and_grads(
        lambda v, p: jax_warp.value_at_location(v, p, **kw),
        lambda v, p: warp.value_at_location(v, p, **kw), (vol, pts), w)
    assert out.shape == ref_out.shape
    assert_rel_close(out, ref_out, OUT_RTOL, "values")
    assert_rel_close(grads[0], ref_grads[0], GRAD_RTOL, "d vol")
    assert_rel_close(grads[1], ref_grads[1], GRAD_RTOL, "d points")


@pytest.mark.parametrize("shape", [(9, 8, 7), (10, 9)])
def test_jacobian_determinant_matches_jax(shape):
    disp = _smooth(8, shape, len(shape), 1.5)
    w = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    out, grads, ref_out, ref_grads = _value_and_grads(
        jax_warp.jacobian_determinant, warp.jacobian_determinant, (disp,), w)
    assert out.shape == ref_out.shape == shape
    assert ref_out.min() < 0.6 and ref_out.max() > 1.5  # shrinking and growth
    assert_rel_close(out, ref_out, OUT_RTOL, "values")
    assert_rel_close(grads[0], ref_grads[0], GRAD_RTOL, "d disp")
    # the numpy version of each package
    np_ref = jax_utils.jacobian_determinant(disp.astype(np.float64))
    assert_rel_close(utils.jacobian_determinant(disp.astype(np.float64)), np_ref, 1e-12, "numpy")
    assert_rel_close(out, np_ref, OUT_RTOL, "torch vs numpy")
    for fn in (warp.jacobian_determinant, utils.jacobian_determinant):
        with pytest.raises(ValueError, match="2D or 3D"):
            fn(_t(np.zeros((5, 1), np.float32)) if fn is warp.jacobian_determinant
               else np.zeros((5, 1)))
