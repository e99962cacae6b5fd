"""The port's 3x3x3 conv (``ops/conv3.py``) against the JAX package's Pallas
conv on the CPU.

The JAX side runs ``pallas_conv`` through the Pallas interpreter, the port
its plain version (what a CPU tensor runs; the CUDA kernel is held to it on
the card by ``chip_smoke.py`` and on the CPU by
``test_torch_kernel_emulation.py``). Inputs come from numpy seeds.
Tolerances, float32: 2e-5 on the forward and 3e-4 on the gradients, the JAX
package's own for its kernel against XLA (``tests/test_pallas.py``; the two
sides sum in other orders); bfloat16: one bf16 step, 2^-7 of |y|,
elementwise. The model-level checks are in ``test_torch_conv3_model.py``.
"""

import itertools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from voxelmorph_tpu.ops import pallas_conv
from voxelmorph_tpu_torch.ops import conv3

FWD_ATOL = 2e-5
GRAD_ATOL = 3e-4
BF16_STEP = 2.0 ** -7

# (D, H, W, ci, co) of the full-width U-Net's 11 convs, 160x192x224
FULL_WIDTH = [(160, 192, 224, 2, 16), (80, 96, 112, 16, 32), (40, 48, 56, 32, 32),
              (20, 24, 28, 32, 32), (10, 12, 14, 32, 32), (20, 24, 28, 64, 32),
              (40, 48, 56, 64, 32), (80, 96, 112, 64, 32), (160, 192, 224, 48, 32),
              (160, 192, 224, 32, 16), (160, 192, 224, 16, 16)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_conv, "_INTERPRET", True)


def _assert_allclose(actual, expected, tol, name):
    """Within ``tol`` absolute plus ``tol`` relative, as tests/test_pallas.py
    holds the Pallas conv to XLA; what is compared is at least 10 x tol."""
    expected = np.asarray(expected)
    assert np.abs(expected).max() >= 10 * tol, name
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol, err_msg=name)


def _conv_case(batch, ci=2, co=4, shape=(8, 8, 32), seed=5):
    """tests/test_pallas.py's case: x channels-last, kernel, bias, cotangent."""
    rng = np.random.default_rng(seed + batch)
    x = rng.normal(size=(batch, *shape, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    g = rng.normal(size=(batch, *shape, co)).astype(np.float32)
    return x, k, b, g


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("batch", [1, 3])
def test_conv3_same_matches_pallas_kernel(interpret, batch, slope):
    x, k, b, g = _conv_case(batch)
    ref = pallas_conv.conv3_same(*map(jnp.asarray, (x, k, b)), act_slope=slope)
    ref_grads = jax.grad(lambda *a: jnp.sum(pallas_conv.conv3_same(*a, act_slope=slope) * g),
                         argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, b)))
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    out = conv3.conv3_same(xt, kt, bt, act_slope=slope)
    _assert_allclose(out.detach().numpy(), ref, FWD_ATOL, "forward")
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (xt, kt, bt))
    for name, ours, theirs in zip(("dx", "dkernel", "dbias"), grads, ref_grads):
        _assert_allclose(ours.numpy(), theirs, GRAD_ATOL, name)
    # the channels-first entry point is the same function
    out_cf = conv3.conv3_same_cf(xt.detach().movedim(-1, 1).contiguous(), kt.detach(),
                                 bt.detach(), act_slope=slope)
    _assert_allclose(out_cf.movedim(1, -1).numpy(), ref, FWD_ATOL, "channels-first")
    assert conv3.conv3_same_cf.launches == 0


def _rn32(v):
    """The rational ``v`` rounded to the nearest float32 (ties to even),
    exactly, where it is not below float32's normal range."""
    if v == 0:
        return 0.0
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    e += Fraction(2) ** (e + 1) <= v
    e -= Fraction(2) ** e > v
    q = v / Fraction(2) ** (e - 23)
    n, r = divmod(q.numerator, q.denominator)
    n += 2 * r > q.denominator or (2 * r == q.denominator and n % 2 == 1)
    return sign * float(n * Fraction(2) ** (e - 23))


def test_fma_is_float32_fma_exactly():
    """The chain version's FMA (float64 with the sum rounded to odd) rounds
    each w * x + acc of float32 values once, as fmaf does: on random values,
    and on sums just past a float32 tie whose float64 rounding lands on the
    tie (acc = 2^k (1 + m 2^-23), w x = 2^(k-24) (1 + 2^-36)), where
    rounding the float64 sum to float32 picks the wrong side."""
    rng = np.random.default_rng(7)
    n = 400
    k = rng.integers(-20, 20, size=n).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], size=n)
    w = np.concatenate([2.0 ** (k - 24) * (1 + 2.0 ** -12), rng.normal(size=n)])
    x = np.concatenate([sign * (1 - 2.0 ** -12 + 2.0 ** -24),
                        rng.normal(size=n) * 2.0 ** rng.integers(-3, 3, size=n)])
    acc = np.concatenate([sign * 2.0 ** k * (1 + rng.integers(0, 2 ** 20, size=n) * 2.0 ** -23),
                          rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, size=n)])
    w, x, acc = (a.astype(np.float32) for a in (w, x, acc))
    got = conv3._fma(torch.from_numpy(w.astype(np.float64) * x),
                     torch.from_numpy(acc.astype(np.float64))).numpy()
    want = np.array([_rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                     for a, b, c in zip(w, x, acc)])
    np.testing.assert_array_equal(got, want)
    # the float64 sum rounded to float32 misses some of the ties
    assert ((w.astype(np.float64) * x + acc).astype(np.float32)[:n] != want[:n]).sum() > n // 4


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("batch,ci,co,shape", [(1, 2, 4, (8, 8, 32)), (2, 6, 12, (4, 8, 16))])
def test_fma_chain_within_tolerance_of_plain_and_pallas_kernel(interpret, batch, ci, co, shape,
                                                               slope):
    """conv3_fma_chain, the float32 CUDA-core kernel's plain version (each
    output one chain of FMAs in cuDNN's order), against conv3_same_cf_plain
    and the Pallas kernel in interpret mode: the same float32 products
    summed in other orders, within conv3.kernel_tolerance of each."""
    x, k, b, _ = _conv_case(batch, ci, co, shape)
    ref = torch.from_numpy(np.asarray(pallas_conv.conv3_same(
        *map(jnp.asarray, (x, k, b)), act_slope=slope))).movedim(-1, 1)
    xt, kt, bt = (torch.from_numpy(a) for a in (x, k, b))
    chain = conv3.conv3_fma_chain(xt.movedim(-1, 1), kt, bt, slope)
    plain = conv3.conv3_same_cf_plain(xt.movedim(-1, 1), kt, bt, slope)
    assert chain.dtype == torch.float32 and chain.shape == plain.shape == ref.shape
    for other, name in ((plain, "plain"), (ref, "pallas")):
        err = (chain - other).abs()
        assert (err <= conv3.kernel_tolerance(other, bt, False)).all(), (name, err.max())
    assert not torch.equal(chain, plain)  # another order of sums
    # the planes argument computes those output planes alone
    planes = [0, shape[0] - 1]
    assert torch.equal(conv3.conv3_fma_chain(xt.movedim(-1, 1), kt, bt, slope, planes=planes),
                       chain[:, :, planes])


@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("batch", [1, 3])
def test_conv3_same_bfloat16_within_one_step(interpret, batch, slope):
    x, k, b, _ = _conv_case(batch)
    ref = np.asarray(pallas_conv.conv3_same(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, k, b)), act_slope=slope), np.float32)
    out = conv3.conv3_same(torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
                           torch.from_numpy(b), act_slope=slope)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert np.abs(ref).max() > 1.0
    assert (err <= BF16_STEP * np.abs(ref)).all(), err.max()


def _jax_takes(ci, co, D, H, W, dtype):
    """Whether JAX's conv3_same takes the shape (it returns None where it
    declines), traced without running."""
    out = jax.eval_shape(lambda x, k, b: pallas_conv.conv3_same(x, k, b),
                         jax.ShapeDtypeStruct((1, D, H, W, ci), dtype),
                         jax.ShapeDtypeStruct((3, 3, 3, ci, co), dtype),
                         jax.ShapeDtypeStruct((co,), dtype))
    return out is not None


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_jax_kernel_takes_matches_jax(dtype):
    small = [(8, 8, 32, 2, 4), (8, 8, 28, 2, 4), (8, 8, 32, 3, 4), (32, 32, 32, 48, 32),
             (16, 16, 16, 64, 32), (8, 8, 8, 32, 32), (4, 4, 4, 32, 32), (2, 2, 2, 32, 32),
             (16, 16, 16, 2, 16), (12, 8, 16, 8, 8)]
    nbytes = jnp.dtype(dtype).itemsize
    answers = []
    for D, H, W, ci, co in FULL_WIDTH + small:
        ours = conv3.jax_kernel_takes(ci, co, D, H, W, nbytes, nbytes)
        assert ours == _jax_takes(ci, co, D, H, W, dtype), (D, H, W, ci, co)
        answers.append(ours)
    # the full-width U-Net: 8 of 11 convs taken, and both answers occur
    assert sum(answers[:len(FULL_WIDTH)]) == 8 and not all(answers[len(FULL_WIDTH):])


@pytest.mark.parametrize("shape,nd", [((2, 7, 9, 11, 3), 3), ((2, 9, 11, 3), 2)],
                         ids=["3d", "2d"])
def test_lean_dw_matches_jax(shape, nd):
    """tests/test_pallas.py's test_lean_dw_conv_matches_autodiff cases."""
    rng = np.random.default_rng(17 + nd)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(*((3,) * nd), 3, 5)) * 0.2).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    g = rng.normal(size=(*shape[:-1], 5)).astype(np.float32)
    ref = pallas_conv.conv3_same_lean_dw(*map(jnp.asarray, (x, k, b)), 0.2)
    ref_grads = jax.grad(lambda *a: jnp.sum(pallas_conv.conv3_same_lean_dw(*a, 0.2) * g),
                         argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, b)))
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    out = conv3.conv3_same_lean_dw(xt, kt, bt, 0.2)
    assert_close(out.detach().numpy(), np.asarray(ref), 1e-5, "forward")
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (xt, kt, bt))
    for name, ours, theirs in zip(("dx", "dkernel", "dbias"), grads, ref_grads):
        assert_close(ours.numpy(), np.asarray(theirs), 2e-4, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tile_plan_fills_the_card_at_full_width(dtype):
    """Every conv of the full-width U-Net, forward and input gradient, gets
    a persistent plan whose tile is its team's rows of 16 voxels (the rows
    a warp owns at that width, or 1), whose shared memory fits an H100, and
    whose grid gives each of the 132 SMs a block with a tile: at every conv
    from 40x48x56 up, and at 20x24x28 where the weights stay resident (a
    tile of one warpgroup's 4 rows). Where they stream at 20x24x28 (float32),
    each SM gets at most one tile, both warpgroups on its 8 rows (120
    tiles): two teams there would each stream the weights for a tile of
    their own, which made the conv slower on an H100. 10x12x14 has 120 rows
    of 16 voxels, fewer than the SMs, and gets the smallest tiles, one
    warpgroup's 4 rows."""
    for D, H, W, ci, co in FULL_WIDTH:
        for c_in, c_out in ((ci, co), (co, ci)):
            mf, n, tz, ty, txf, hs, ws, team_warps, blocks = conv3.tile_plan(
                1, c_in, c_out, D, H, W, dtype)
            assert n == conv3.block_width(c_out) and mf in (conv3.rows_per_warp(dtype, n), 1)
            assert team_warps in (4, 8) and tz * ty * txf == team_warps * mf
            assert ws != 1 and (ws == 0 or team_warps == 8 or mf == 1)
            tiles = -(-D // tz) * -(-H // ty) * -(-W // (16 * txf)) * -(-c_out // n)
            assert blocks == min(tiles, 132)
            if D * H * W >= 40 * 48 * 56 or (D * H * W >= 20 * 24 * 28 and ws == 0):
                assert tiles >= 132, (D, H, W, c_in, c_out)
            elif D * H * W >= 20 * 24 * 28:
                assert (mf, team_warps, tiles) == (1, 8, 120), (D, H, W, c_in, c_out)
            else:
                assert (mf, team_warps) == (1, 4), (D, H, W, c_in, c_out)
            halo = (tz + 2) * (ty + 2) * (16 * txf + 2)
            nchunks = -(-c_in // conv3._KC[dtype])
            assert conv3.smem_bytes(halo, n, nchunks, hs, ws, dtype, -(-c_out // n),
                                    8 // team_warps) <= 232448


def _shifted_dw_db_channels_first(x, gf):
    """The weight gradient over channels-first storage, as it was computed
    before it read channels-last: the reference the new version is held to."""
    B, ci, *S = x.shape
    co = gf.shape[1]
    nd = len(S)
    xpad, gpad = [], []
    for axis in reversed(range(nd)):
        xpad += [1, 2] if axis == 0 else [1, 1]
        gpad += [0, 0] if axis == 0 else [0, 2]
    xp = torch.nn.functional.pad(x.float(), xpad).reshape(B, ci, -1)
    gp = torch.nn.functional.pad(gf.float(), gpad)
    n = gp[0, 0].numel()
    gflat = gp.reshape(B, co, n).transpose(1, 2)
    strides = [1] * nd
    for axis in reversed(range(nd - 1)):
        strides[axis] = strides[axis + 1] * (S[axis + 1] + 2)
    taps = []
    for tap in itertools.product(range(3), repeat=nd):
        off = sum(t * s for t, s in zip(tap, strides))
        taps.append(torch.matmul(xp[:, :, off:off + n], gflat).sum(0))
    dw = torch.stack(taps, 0).reshape(*((3,) * nd), ci, co)
    return dw, gf.float().sum(dim=(0, *range(2, nd + 2)))


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("spatial", [(11,), (7, 9), (5, 6, 7)], ids=["1d", "2d", "3d"])
def test_shifted_dw_db_reads_channels_last(spatial, layout):
    """dw and db over N = 1, 2, 3 spatial axes from tensors in either
    layout (channels-last: the storage of ``(B, *S, C)``, as the conv
    kernel's outputs and the lean-dw path's inputs lie), against the
    channels-first computation, within 1e-6 of each one's largest entry."""
    rng = np.random.default_rng(len(spatial))
    x = torch.from_numpy(rng.normal(size=(2, *spatial, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, *spatial, 3)).astype(np.float32))
    if layout == "channels_last":
        x, g = x.movedim(-1, 1), g.movedim(-1, 1)
    else:
        x, g = x.movedim(-1, 1).contiguous(), g.movedim(-1, 1).contiguous()
    dw, db = conv3._shifted_dw_db(x, g)
    ref_dw, ref_db = _shifted_dw_db_channels_first(x.contiguous(), g.contiguous())
    assert dw.shape == ref_dw.shape and db.shape == ref_db.shape
    for ours, ref in ((dw, ref_dw), (db, ref_db)):
        assert (ours - ref).abs().max() <= 1e-6 * ref.abs().max()
