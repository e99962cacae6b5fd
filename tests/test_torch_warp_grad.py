"""Gradients of the PyTorch port's warp ops and max pool against the JAX package.

The bounded warp's plain backward (``warp_bounded_bwd_plain``, what the CUDA
kernel computes) is held to the Pallas backward kernel itself, run by the
Pallas interpreter, and to its plain reference ``_warp_cf_bwd_ref``, within
1e-5 absolute (float32, the two differ in the order of additions). Autograd
of ``interpn`` is held to ``jax.grad`` of the JAX function within 1e-4
absolute (measured: <= 2.4e-7; the sums run in other orders), with
coordinates beyond and exactly on the volume's edges; ``test_torch_warp_tiers_grad.py`` does the same for
the warps on each tier.

One difference is by design: on its kernel tiers the port follows the
Pallas backward kernel, whose strict interior mask gives a zero shift
gradient where ``x + shift`` lies exactly on 0 or dim - 1, and whose weight
derivative is 0 at an integer displacement. On the CPU the JAX package
differentiates the shifted-slice forward by autodiff instead, which passes a
gradient at those points. ``test_exact_edge_follows_the_pallas_kernel``
shows where the two differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, bounded_case
from voxelmorph_tpu.models import unet as jax_unet
from voxelmorph_tpu.ops import interp as jax_interp
from voxelmorph_tpu.ops import pallas_interp
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu_torch.models.unet import max_pool
from voxelmorph_tpu_torch.ops import interp
from voxelmorph_tpu_torch.ops.warp_bounded import (warp_bounded, warp_bounded_bwd,
                                                   warp_bounded_bwd_plain)

KERNEL_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _cf(x):
    return jnp.moveaxis(jnp.asarray(x), -1, 0)


def _from_cf(x):
    return np.moveaxis(np.asarray(x), 0, -1)


@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("nch", [1, 3])
def test_bwd_plain_matches_pallas_kernel(monkeypatch, halo, nch):
    monkeypatch.setattr(pallas_interp, "_INTERPRET", True)
    vol, shift = bounded_case(halo * 10 + nch, (6, 7, 9), nch, halo)
    g = np.random.default_rng(5).normal(size=vol.shape).astype(np.float32)
    dvol_k, dshift_k = pallas_interp._bwd_impl_pallas(_cf(vol), jnp.asarray(shift), _cf(g), halo)
    dvol_r, dshift_r = pallas_interp._warp_cf_bwd_ref(halo, (_cf(vol), jnp.asarray(shift)), _cf(g))
    dvol, dshift = warp_bounded_bwd_plain(*(torch.from_numpy(a)[None] for a in (vol, shift, g)),
                                          halo)
    for ours, kernel, ref, name in ((dvol[0], _from_cf(dvol_k), _from_cf(dvol_r), "dvol"),
                                    (dshift[0], dshift_k, dshift_r, "dshift")):
        assert_close(ours.numpy(), kernel, KERNEL_ATOL, f"{name} vs the Pallas kernel")
        assert_close(ours.numpy(), ref, KERNEL_ATOL, f"{name} vs _warp_cf_bwd_ref")


def test_warp_bounded_gradcheck():
    """The CPU autograd Function (plain forward and backward) in float64."""
    rng = np.random.default_rng(7)
    vol = torch.from_numpy(rng.normal(size=(1, 3, 3, 4, 2))).requires_grad_()
    # random shifts stay away from the kinks of the clamp and the tent weights
    shift = torch.from_numpy(rng.uniform(-0.95, 0.95, size=(1, 3, 3, 4, 3))).requires_grad_()
    assert torch.autograd.gradcheck(lambda v, s: warp_bounded(v, s, 1), (vol, shift))


def test_warp_bounded_backward_runs_the_plain_version_on_cpu():
    vol, shift = bounded_case(3, (5, 6, 7), 3, 1, batch=2)
    v = torch.from_numpy(vol).requires_grad_()
    s = torch.from_numpy(shift).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(4).normal(size=vol.shape).astype(np.float32))
    before = warp_bounded_bwd.launches
    dv, ds = torch.autograd.grad(warp_bounded(v, s, 1), (v, s), g)
    assert warp_bounded_bwd.launches == before == 0
    ref_v, ref_s = warp_bounded_bwd_plain(v.detach(), s.detach(), g, 1)
    assert torch.equal(dv, ref_v) and torch.equal(ds, ref_s)
    # each gradient comes back in its input's dtype
    vb = v.detach().to(torch.bfloat16).requires_grad_()
    dvb, dsb = torch.autograd.grad(warp_bounded(vb, s, 1).sum(), (vb, s))
    assert dvb.dtype == torch.bfloat16 and dsb.dtype == torch.float32


def test_exact_edge_follows_the_pallas_kernel():
    """Where the coordinate lies exactly on an edge, the port's dshift is the
    Pallas kernel's zero; JAX's autodiff of the plain forward passes a
    gradient there. Everywhere else the two agree."""
    halo = 1
    vol, shift = bounded_case(21, (6, 7, 8), 2, halo)
    g = np.random.default_rng(6).normal(size=vol.shape).astype(np.float32)
    v = torch.from_numpy(vol)[None].requires_grad_()
    s = torch.from_numpy(shift)[None].requires_grad_()
    _, ds = torch.autograd.grad(warp_bounded(v, s, halo), (v, s), torch.from_numpy(g)[None])
    ds = ds[0].numpy()
    ref = jax.grad(lambda sh: jnp.sum(jax_warp.windowed_transform(jnp.asarray(vol), sh, halo)
                                      * g))(jnp.asarray(shift))
    ref = np.asarray(ref)

    grid = np.stack(np.meshgrid(*[np.arange(n, dtype=np.float32) for n in vol.shape[:3]],
                                indexing="ij"), -1)
    raw = grid + shift
    top = np.array(vol.shape[:3], np.float32) - 1
    on_edge = (raw == 0) | (raw == top)
    d = np.clip(raw, 0, top) - grid
    kink = on_edge | (d == np.round(d))  # integer displacements too
    assert on_edge.sum() > 50
    assert np.all(ds[on_edge] == 0)
    assert np.abs(ref[on_edge]).max() > 0.1  # autodiff's gradient at the edge
    assert_close(np.where(kink, 0, ds), np.where(kink, 0, ref), GRAD_ATOL, "off the edges")


# exact-edge coordinates: on 0 and on dim - 1 along each axis, and beyond
EDGE_LOCS = [[0, 0, 0], [5, 6, 7], [0, 6, 3.5], [5, 1.5, 0], [-1, 6, 7], [2.5, 3.5, 7],
             [0, 2.25, 9.0]]


@pytest.mark.parametrize("method,fill", [("linear", None), ("linear", 0.5), ("nearest", None)])
@pytest.mark.parametrize("nch", [1, 3])
def test_interpn_grad_matches_jax(method, fill, nch):
    rng = np.random.default_rng(nch + 31)
    vol = rng.normal(size=(6, 7, 8, nch)).astype(np.float32)
    loc = rng.uniform(-2, 9, size=(4, 4, 3, 3)).astype(np.float32)
    loc.reshape(-1, 3)[:len(EDGE_LOCS)] = EDGE_LOCS
    w = rng.normal(size=(4, 4, 3, nch)).astype(np.float32)

    def f(v, l):
        return jnp.sum(jax_interp.interpn(v, l, interp_method=method, fill_value=fill) * w)

    ref_v, ref_l = jax.grad(f, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(loc))
    v = torch.from_numpy(vol).requires_grad_()
    l = torch.from_numpy(loc).requires_grad_()
    out = interp.interpn(v, l, interp_method=method, fill_value=fill)
    dv, dl = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (v, l), allow_unused=True)
    assert_close(dv.numpy(), ref_v, GRAD_ATOL, "dvol")
    if method == "nearest":
        assert (dl is None or not dl.any()) and not np.asarray(ref_l).any()
    else:
        assert_close(dl.numpy(), ref_l, GRAD_ATOL, "dloc")


@pytest.mark.parametrize("shape", [(1, 4, 6, 4, 3), (2, 5, 7, 6, 2)], ids=["even", "odd"])
@pytest.mark.parametrize("constant", [True, False], ids=["constant", "ties"])
def test_max_pool_grad_splits_ties_as_jax(shape, constant):
    rng = np.random.default_rng(sum(shape))
    if constant:  # every window is one eight-way tie
        x = np.full(shape, 0.25, np.float32)
    else:  # coarse values make ties common
        x = np.round(rng.uniform(0, 2, size=shape)).astype(np.float32)
    out_shape = (shape[0], *(s // 2 for s in shape[1:4]), shape[4])
    g = rng.normal(size=out_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_unet._max_pool(a, 2, 3), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    ours = torch.autograd.grad(max_pool(xt, 2, 3), xt,
                               torch.from_numpy(np.moveaxis(g, -1, 1).copy()))[0]
    ours = np.moveaxis(ours.numpy(), 1, -1)
    assert_close(ours, ref, 1e-6, "max-pool gradient")
    if constant:
        # the window's gradient split in eight, zero past the last whole window
        even = tuple(slice(0, 2 * (s // 2)) for s in shape[1:4])
        np.testing.assert_array_equal(ours[(slice(None), *even)],
                                      np.repeat(np.repeat(np.repeat(g, 2, 1), 2, 2), 2, 3) / 8)
        assert ours.sum() == pytest.approx(g.sum(), rel=1e-5)
