"""The port's wide-channel gather against the JAX package's on the CPU.

``interpn`` of a multi-channel volume whose corner table (V * 2^N * C values
of the compute dtype) passes ``_CORNER_TABLE_BYTES_LIMIT`` takes another
path in the JAX package (``_linear_gather_wide``): the +1 corner's flat index
is clipped to the last voxel instead of wrapping, and the coordinate gradient
passes in full at exactly 0 and dim - 1 (the table path's clip passes half).
The tests lower the limit in both packages for their duration (the JAX
package is called eagerly, on shapes no other test uses, so that it decides
with the lowered limit) and compare values, d vol and d loc at coordinates
inside, exactly on the edges, beyond them and at the last flat voxel, within
1e-5 of each quantity's largest magnitude (values) and 1e-4 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close
from voxelmorph_tpu.ops import interp as jax_interp
from voxelmorph_tpu_torch.ops import interp

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
SHAPE = (5, 6, 7)


def _case(seed, nch):
    """A volume and locations: random ones inside and beyond the volume,
    and points exactly on 0 or dim - 1 in some axes, among them the last
    flat voxel and a top edge in z whose +1 corner is the next row."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(*SHAPE, nch)).astype(np.float32)
    top = np.array(SHAPE, np.float32) - 1
    inside = rng.uniform(0, top, size=(20, 3))
    beyond = rng.uniform(-2, top + 2, size=(20, 3))
    exact = np.array([[0, 2.5, 3.2], [1.5, 0, 0], [4, 2.2, 1.7], [2.1, 5, 6], [4, 5, 6],
                      [2, 3, 6], [0, 0, 0], [4, 5, 3.5], [-1, 5, 6], [4, 7, 6.5]])
    loc = np.concatenate([inside, beyond, exact]).astype(np.float32)
    return vol, loc


def _both(vol, loc, fill_value, w):
    """Values and (d vol, d loc) of sum(interpn(vol, loc) * w) in JAX and
    in the port."""
    ref, vjp = jax.vjp(lambda v, l: jax_interp.interpn(v, l, fill_value=fill_value),
                       jnp.asarray(vol), jnp.asarray(loc))
    ref_dvol, ref_dloc = vjp(jnp.asarray(w))
    v = torch.from_numpy(vol).requires_grad_()
    l = torch.from_numpy(loc).requires_grad_()
    out = interp.interpn(v, l, fill_value=fill_value)
    dvol, dloc = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (v, l))
    return ((out.detach().numpy(), dvol.numpy(), dloc.numpy()),
            (np.asarray(ref), np.asarray(ref_dvol), np.asarray(ref_dloc)))


@pytest.fixture
def wide_spy(monkeypatch):
    """Count the port's calls of the wide path."""
    calls = []
    real = interp._linear_gather_wide

    def spy(*args):
        calls.append(args[1])
        return real(*args)

    monkeypatch.setattr(interp, "_linear_gather_wide", spy)
    return calls


def _lower_limits(monkeypatch, limit):
    monkeypatch.setattr(jax_interp, "_CORNER_TABLE_BYTES_LIMIT", limit)
    monkeypatch.setattr(interp, "_CORNER_TABLE_BYTES_LIMIT", limit)


@pytest.mark.parametrize("fill_value", [None, 0.25])
@pytest.mark.parametrize("nch", [2, 5])
def test_wide_path_matches_jax(monkeypatch, wide_spy, fill_value, nch):
    vol, loc = _case(nch, nch)
    w = np.random.default_rng(10 + nch).normal(size=(len(loc), nch)).astype(np.float32)
    _lower_limits(monkeypatch, 0)
    ours, ref = _both(vol, loc, fill_value, w)
    assert wide_spy == [SHAPE]
    for name, a, b in zip(("values", "d vol", "d loc"), ours, ref):
        assert a.shape == b.shape, name
        assert_rel_close(a, b, GRAD_RTOL if name != "values" else OUT_RTOL, name)

    # the JAX table path differs exactly where the wide path has its own
    # rules: the coordinate gradient on the edges and at the last voxel
    monkeypatch.setattr(jax_interp, "_CORNER_TABLE_BYTES_LIMIT", 1 << 30)
    _, vjp = jax.vjp(lambda v, l: jax_interp.interpn(v, l, fill_value=fill_value),
                     jnp.asarray(vol), jnp.asarray(loc))
    table_dloc = np.asarray(vjp(jnp.asarray(w))[1])
    differs = np.abs(table_dloc - ours[2]).max(axis=-1) > 1e-3
    assert differs[40:].sum() >= 5 and not differs[:20].any()


@pytest.mark.parametrize("fill_value", [None, 0.25])
def test_table_path_is_unchanged(wide_spy, fill_value):
    """Under the default limit both packages take the corner table, with its
    rules (the +1 corner wraps, half the coordinate gradient on the edges)."""
    vol, loc = _case(3, 3)
    w = np.random.default_rng(13).normal(size=(len(loc), 3)).astype(np.float32)
    ours, ref = _both(vol, loc, fill_value, w)
    assert wide_spy == []
    for name, a, b in zip(("values", "d vol", "d loc"), ours, ref):
        assert_rel_close(a, b, GRAD_RTOL if name != "values" else OUT_RTOL, name)


def test_the_limit_counts_the_corner_table_bytes(monkeypatch, wide_spy):
    """V * 2^N * C * itemsize: a table of exactly the limit stays on the
    table path, one byte more takes the wide path; one channel never does."""
    vol, loc = _case(4, 3)
    table_bytes = int(np.prod(SHAPE)) * 8 * 3 * 4
    for limit, wide in ((table_bytes, False), (table_bytes - 1, True)):
        _lower_limits(monkeypatch, limit)
        wide_spy.clear()
        interp.interpn(torch.from_numpy(vol), torch.from_numpy(loc))
        assert bool(wide_spy) == wide
    _lower_limits(monkeypatch, 0)
    wide_spy.clear()
    interp.interpn(torch.from_numpy(vol[..., :1]), torch.from_numpy(loc))
    assert wide_spy == []
