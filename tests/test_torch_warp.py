"""The PyTorch port's warp ops against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages. The bounded-warp
plain version is held against the Pallas kernel itself, run by the Pallas
interpreter. Tolerance: 1e-5 absolute everywhere (float32; the two sides
differ only in the order of floating-point additions).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelmorph_tpu.models.vxm import rescale_flow as jax_rescale_flow
from voxelmorph_tpu.ops import interp as jax_interp
from voxelmorph_tpu.ops import pallas_interp
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu_torch.models.vxm import rescale_flow
from voxelmorph_tpu_torch.ops import interp, warp
from voxelmorph_tpu_torch.ops.warp_bounded import warp_bounded, windowed_transform

ATOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures.npz")


def _bounded_case(seed, shape, nch, halo, batch=None):
    """Volume and shifts within +-halo, with border bands pushed across the
    volume's edges so that clamping binds."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    vol = rng.normal(size=(*lead, *shape, nch)).astype(np.float32)
    shift = rng.uniform(-halo, halo, size=(*lead, *shape, 3)).astype(np.float32)
    for axis in range(3):
        lo = [slice(None)] * shift.ndim
        hi = [slice(None)] * shift.ndim
        lo[len(lead) + axis] = slice(0, 2)
        hi[len(lead) + axis] = slice(-2, None)
        lo[-1] = hi[-1] = axis
        shift[tuple(lo)] = -halo
        shift[tuple(hi)] = halo
    return vol, shift


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("nch", [1, 3])
def test_windowed_transform_matches_pallas_kernel(monkeypatch, halo, nch):
    monkeypatch.setattr(pallas_interp, "_INTERPRET", True)
    vol, shift = _bounded_case(halo * 10 + nch, (6, 7, 9), nch, halo)
    ref = np.asarray(pallas_interp.warp_bounded(jnp.asarray(vol), jnp.asarray(shift), halo))
    ours = windowed_transform(torch.from_numpy(vol), torch.from_numpy(shift), halo).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("halo", [1, 2])
def test_windowed_transform_matches_jax_windowed(halo):
    vol, shift = _bounded_case(3, (5, 8, 6), 2, halo)
    ref = np.asarray(jax_warp.windowed_transform(jnp.asarray(vol), jnp.asarray(shift), halo))
    ours = windowed_transform(torch.from_numpy(vol), torch.from_numpy(shift), halo).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_warp_bounded_cpu_tensor_takes_plain_version():
    vol, shift = _bounded_case(7, (5, 6, 7), 3, 1, batch=2)
    v, s = torch.from_numpy(vol), torch.from_numpy(shift)
    before = warp_bounded.launches
    out = warp_bounded(v, s, 1)
    assert warp_bounded.launches == before == 0
    assert torch.equal(out, windowed_transform(v, s, 1))
    # output dtype is promoted as the JAX wrapper promotes it
    assert warp_bounded(v.to(torch.bfloat16), s, 1).dtype == torch.float32


@pytest.mark.parametrize("vol_shape,shift_shape,halo", [
    ((1, 4, 4, 4, 5), (1, 4, 4, 4, 3), 1),   # too many channels
    ((1, 4, 4, 4, 2), (1, 4, 4, 3, 3), 1),   # spatial mismatch
    ((4, 4, 4, 2), (4, 4, 4, 3), 1),         # no batch axis
    ((1, 4, 4, 4, 2), (1, 4, 4, 4, 3), 0),   # halo out of range
])
def test_warp_bounded_rejects_bad_inputs(vol_shape, shift_shape, halo):
    with pytest.raises(ValueError):
        warp_bounded(torch.zeros(vol_shape), torch.zeros(shift_shape), halo)


def test_ndgrid_matches_jax():
    np.testing.assert_array_equal(interp.ndgrid((3, 4, 5)).numpy(),
                                  np.asarray(jax_interp.ndgrid((3, 4, 5))))


@pytest.mark.parametrize("method,fill", [("linear", None), ("nearest", None),
                                         ("linear", 0.5), ("nearest", -1.0)])
@pytest.mark.parametrize("nch", [1, 2])
def test_interpn_matches_jax(method, fill, nch):
    rng = np.random.default_rng(11)
    vol = rng.normal(size=(6, 7, 8, nch)).astype(np.float32)
    loc = rng.uniform(-2, 9, size=(5, 4, 3, 3)).astype(np.float32)
    ref = np.asarray(jax_interp.interpn(jnp.asarray(vol), jnp.asarray(loc),
                                        interp_method=method, fill_value=fill))
    ours = interp.interpn(torch.from_numpy(vol), torch.from_numpy(loc),
                          interp_method=method, fill_value=fill).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


# (halo, max|shift|) pairs that pick each tier: halo-1 kernel, full-halo
# kernel or gather, on both sides
TIERS = [(None, 1.7), (1, 0.8), (1, 1.7), (2, 1.7), (2, 2.6)]


@pytest.mark.parametrize("window_halo,scale", TIERS)
def test_transform_matches_jax(window_halo, scale):
    rng = np.random.default_rng(int(scale * 10))
    vol = rng.normal(size=(6, 7, 8, 2)).astype(np.float32)
    shift = rng.uniform(-scale, scale, size=(6, 7, 8, 3)).astype(np.float32)
    ref = np.asarray(jax_warp.transform(jnp.asarray(vol), jnp.asarray(shift),
                                        window_halo=window_halo))
    ours = warp.transform(torch.from_numpy(vol), torch.from_numpy(shift),
                          window_halo=window_halo).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window_halo,scale", TIERS)
def test_transform_batched_matches_jax(window_halo, scale):
    rng = np.random.default_rng(int(scale * 10) + 1)
    vols = rng.normal(size=(2, 6, 7, 8, 3)).astype(np.float32)
    shifts = rng.uniform(-scale, scale, size=(2, 6, 7, 8, 3)).astype(np.float32)
    ref = np.asarray(jax_warp.transform_batched(jnp.asarray(vols), jnp.asarray(shifts),
                                                window_halo=window_halo))
    ours = warp.transform_batched(torch.from_numpy(vols), torch.from_numpy(shifts),
                                  window_halo=window_halo).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window_halo", [1, 2])
def test_integrate_vec_batched_matches_jax(window_halo):
    """Early steps take the kernel tiers, later ones the gather."""
    rng = np.random.default_rng(17)
    vec = rng.uniform(-6, 6, size=(2, 7, 6, 8, 3)).astype(np.float32)
    ref = np.asarray(jax_warp.integrate_vec_batched(jnp.asarray(vec), nb_steps=5,
                                                    window_halo=window_halo))
    ours = warp.integrate_vec_batched(torch.from_numpy(vec), nb_steps=5,
                                      window_halo=window_halo).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("factor", [0.5, 2.0, 1.5])
def test_resize_matches_jax(method, factor):
    rng = np.random.default_rng(19)
    vol = rng.normal(size=(6, 7, 5, 2)).astype(np.float32)
    ref = np.asarray(jax_interp.resize(jnp.asarray(vol), factor, interp_method=method))
    ours = interp.resize(torch.from_numpy(vol), factor, interp_method=method).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_rescale_flow_matches_jax(factor):
    rng = np.random.default_rng(23)
    flow = rng.normal(size=(2, 8, 6, 4, 3)).astype(np.float32)
    ref = np.asarray(jax_rescale_flow(jnp.asarray(flow), factor))
    ours = rescale_flow(torch.from_numpy(flow), factor).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("key,kwargs", [
    ("transform_linear", dict(window_halo=None)),
    ("transform_nearest", dict(interp_method="nearest")),
    ("transform_fill", dict(fill_value=0.0)),
])
def test_transform_golden(key, kwargs):
    g = np.load(FIXTURES)
    ours = warp.transform(torch.from_numpy(g["vol"]), torch.from_numpy(g["shift"]),
                          **kwargs).numpy()
    np.testing.assert_allclose(ours, g[key], rtol=0, atol=ATOL)


def test_integrate_golden():
    g = np.load(FIXTURES)
    ours = warp.integrate_vec_batched(torch.from_numpy(g["vec"])[None], nb_steps=7,
                                      window_halo=None)[0].numpy()
    np.testing.assert_allclose(ours, g["integrate_ss7"], rtol=0, atol=ATOL)


def test_resolve_halo(monkeypatch):
    monkeypatch.delenv("VXM_WINDOW_HALO", raising=False)
    assert warp._resolve_halo("auto", "cpu") is None
    assert warp._resolve_halo("auto", "cuda") == 1
    assert warp._resolve_halo(2, "cpu") == 2
    monkeypatch.setenv("VXM_WINDOW_HALO", "2")
    assert warp._resolve_halo("auto", "cpu") == 2
    monkeypatch.setenv("VXM_WINDOW_HALO", "0")
    assert warp._resolve_halo("auto", "cuda") is None
