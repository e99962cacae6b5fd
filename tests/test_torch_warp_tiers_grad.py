"""Gradients of the PyTorch port's warps against the JAX package, tier by tier.

Autograd of ``transform``, ``transform_batched`` and ``integrate_vec_batched``
is held to ``jax.grad`` of the JAX function that computes each tier (the
shifted-slice ``windowed_transform`` for the kernel tiers, the gather
otherwise), within 1e-4 absolute (measured: <= 1.9e-6; the sums run in other
orders). On the CPU the port's kernel tiers run the plain backward of the
bounded warp, the formulation of its CUDA kernel; random shifts keep the
coordinates off the edges and off integer displacements, where the two
formulations differ by design (see ``test_torch_warp_grad.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from voxelmorph_tpu.ops import warp as jax_warp
from voxelmorph_tpu_torch.ops import warp

GRAD_ATOL = 1e-4


# (halo, max|shift|) pairs that pick each tier: halo-1 kernel, full-halo
# kernel or gather
TIERS = [(None, 1.7), (1, 0.8), (1, 1.7), (2, 1.7), (2, 2.6)]
# the single-volume warp takes the batched warp's kernel path on the CPU
SINGLE_TIERS = [(None, 1.7), (1, 0.8), (1, 1.7)]
# one shape for the warps, their shifts and their fields, so that the JAX
# operations compiled for one test serve the next
SHAPE = (6, 7, 8, 3)


def _tier(window_halo, max_shift):
    """The halo of the kernel tier that a warp takes, or None for the gather:
    the rule of both packages' ``_tiered_windowed_switch``."""
    if window_halo is None:
        return None
    return next((h for h in sorted({1, window_halo}) if max_shift <= h), None)


def _jax_tier_fn(halo, batched):
    """The JAX function that computes a warp on a tier: the shifted-slice
    ``windowed_transform`` or the gather. (``jax.grad`` of the tiered
    ``lax.switch`` itself takes minutes to compile on the CPU.)"""
    if halo is None:
        fn = lambda v, s: jax_warp.transform(v, s, window_halo=None)
    else:
        fn = lambda v, s: jax_warp.windowed_transform(v, s, halo)
    return jax.vmap(fn) if batched else fn


def _grads_vs_jax(jax_fn, torch_fn, arrays, w):
    ref = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ours = torch.autograd.grad((torch_fn(*ts) * torch.from_numpy(w)).sum(), ts)
    for k, (o, r) in enumerate(zip(ours, ref)):
        assert_close(o.numpy(), r, GRAD_ATOL, f"gradient of argument {k}")


@pytest.mark.parametrize("window_halo,scale", SINGLE_TIERS)
def test_transform_grad_matches_jax(window_halo, scale):
    rng = np.random.default_rng(int(scale * 10) + 40)
    vol = rng.normal(size=SHAPE).astype(np.float32)
    shift = rng.uniform(-scale, scale, size=SHAPE).astype(np.float32)
    w = rng.normal(size=vol.shape).astype(np.float32)
    tier = _tier(window_halo, np.abs(shift).max())
    _grads_vs_jax(_jax_tier_fn(tier, batched=False),
                  lambda v, s: warp.transform(v, s, window_halo=window_halo), (vol, shift), w)


@pytest.mark.parametrize("window_halo,scale", TIERS)
def test_transform_batched_grad_matches_jax(window_halo, scale):
    rng = np.random.default_rng(int(scale * 10) + 41)
    vols = rng.normal(size=(2, *SHAPE)).astype(np.float32)
    shifts = rng.uniform(-scale, scale, size=(2, *SHAPE)).astype(np.float32)
    w = rng.normal(size=vols.shape).astype(np.float32)
    tier = _tier(window_halo, np.abs(shifts).max())
    _grads_vs_jax(_jax_tier_fn(tier, batched=True),
                  lambda v, s: warp.transform_batched(v, s, window_halo=window_halo),
                  (vols, shifts), w)


@pytest.mark.parametrize("window_halo", [None, 2])
def test_integrate_vec_batched_grad_matches_jax(window_halo):
    """Scaling and squaring whose early steps take the kernel tiers and later
    ones the gather; the JAX reference runs each step on the tier that
    ``integrate_vec_batched`` picks for it."""
    rng = np.random.default_rng(43)
    nb_steps = 5
    vec = rng.uniform(-6, 6, size=(2, *SHAPE)).astype(np.float32)
    w = rng.normal(size=vec.shape).astype(np.float32)
    steps = []
    v = jnp.asarray(vec) / 2.0 ** nb_steps
    for _ in range(nb_steps):
        steps.append(_jax_tier_fn(_tier(window_halo, float(jnp.abs(v).max())), batched=True))
        v = v + steps[-1](v, v)
    if window_halo is not None:
        assert len({id(f) for f in steps}) > 1  # both kernel and gather tiers

    def integrate(u):
        u = u / 2.0 ** nb_steps
        for step in steps:
            u = u + step(u, u)
        return u

    _grads_vs_jax(integrate,
                  lambda u: warp.integrate_vec_batched(u, nb_steps=nb_steps,
                                                       window_halo=window_halo),
                  (vec,), w)
