"""The gather kernels of ``csrc/warp_gather.cu``, run on the CPU under emulation.

The source is compiled for the CPU against ``tests/cuda_emulation/`` (as in
``test_torch_kernel_emulation.py``), whose warps exchange values through a
barrier of their 32 threads. In the backward, a lane whose +x corner is the
next lane's x corner (a smooth field) hands its dvol term to that lane,
which adds both with one atomic, and a thread's z corners take the terms of
the +z corners of the output below in its column where they are the same
voxels; elsewhere (a rough field, the edge of a warp) each term is added
alone. Built with ``VXM_GATHER_COUNT``, the kernel counts its atomic adds
and its merged terms; one test holds the package's build (no counts) to the
counting one. Both kernels must compute the plain version of
``ops/warp_gather.py``: the forward and dshift bit for bit (compared as bit
patterns, so that -0 counts, and NaN where the plain version has NaN),
dvol, whose atomic adds sum in another order, within ``DVOL_RTOL`` of its
largest magnitude. The last test holds the emulated kernels against the
JAX package's ``interpn`` and its ``jax.vjp``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernel_emulation import _compile
from torch_parity import assert_rel_close
from voxelmorph_tpu.ops import interp as jax_interp
from voxelmorph_tpu_torch.ops import interp
from voxelmorph_tpu_torch.ops import warp_gather as wg

# the gather's dvol against autograd's: the same float32 products summed in
# another order (atomic adds, some of terms merged between lanes and planes,
# against index_put's)
DVOL_RTOL = 1e-6
# (batch, spatial, channels): blocks of 32 x 8 outputs over 2 planes,
# ragged in x (a warp with 1 to 8 lanes inside), y and z, several each way
SHAPES = [(1, (5, 9, 33), 1), (2, (9, 17, 35), 3), (1, (6, 10, 40), 2), (2, (5, 8, 34), 4)]
# the emulated kernels against the JAX package on the CPU (XLA's gather
# and scatter-add, its own order of products and sums), each output
# relative to its largest magnitude; measured: 0 forward, 1.8e-7 dvol and
# 1.3e-7 dshift (one channel: JAX's hand-written VJP of its gather)
JAX_RTOL = 1e-6


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _compile(tmp_path_factory, "warp_gather", [], 2, ["VXM_GATHER_COUNT=1"])


@pytest.fixture(scope="module")
def package_lib(tmp_path_factory):
    return _compile(tmp_path_factory, "warp_gather", [], 2)


def _entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = wg._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _run(lib, vol, shift, g, wide=False, with_dvol=True):
    """The forward and backward kernels, unpredicated: (out, dvol or None,
    dshift, the forward's counter [ran] and the backward's [ran, atomic
    adds, merged terms])."""
    B, D, H, W, C = vol.shape
    work = torch.zeros(4, dtype=torch.int32)
    fi, bi = 0, 1
    out = torch.full_like(vol, float("nan"))
    assert _entry(lib, "vxm_warp_gather_fwd")(
        vol.data_ptr(), shift.data_ptr(), out.data_ptr(), B, D, H, W, C, int(wide), None, 0,
        work[fi:].data_ptr(), None) == 0
    dvol = torch.zeros_like(vol) if with_dvol else None
    dshift = torch.full_like(shift, float("nan"))
    assert _entry(lib, "vxm_warp_gather_bwd")(
        vol.data_ptr(), shift.data_ptr(), g.data_ptr(),
        None if dvol is None else dvol.data_ptr(), dshift.data_ptr(), B, D, H, W, C,
        int(wide), None, 0, work[bi:].data_ptr(), None) == 0
    return out, dvol, dshift, work[fi:fi + 1].tolist(), work[bi:bi + 3].tolist()


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    """NaN at the same elements and every other element the same bit
    pattern, -0 included. (A NaN's sign and payload are not compared: on
    the CPU they follow the operand order of x86's NaN rules, on the card
    every NaN is the same.)"""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def _assert_equals_plain(vol, shift, g, out, dvol, dshift):
    ref = wg.warp_gather_plain(vol, shift)
    ref_vol, ref_shift = wg.warp_gather_bwd_plain(vol, shift, g)
    assert _same_bits(out, ref)
    assert _same_bits(dshift, ref_shift)
    assert ref_shift.abs().max() > 1
    if dvol is not None:
        assert_rel_close(dvol, ref_vol, DVOL_RTOL, "gather dvol")


def _smooth(rng, batch, spatial, amplitude):
    """A smooth displacement of up to about ``amplitude`` voxels: a sum of
    random sinusoids along each axis."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in spatial], indexing="ij")
    shift = np.zeros((batch, *spatial, 3), np.float32)
    for b in range(batch):
        for d in range(3):
            for axis, s in enumerate(spatial):
                phase, period = rng.uniform(0, 2 * np.pi), rng.uniform(1.5, 3) * s
                shift[b, ..., d] += np.sin(2 * np.pi * grids[axis] / period + phase)
    return amplitude / 3 * shift


def _case(seed, batch, spatial, nch):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((batch, *spatial, nch), dtype=np.float32)
    g = rng.standard_normal((batch, *spatial, nch), dtype=np.float32)
    return rng, torch.from_numpy(vol), torch.from_numpy(g)


@pytest.mark.parametrize("batch,spatial,nch,wide", [
    (*case, wide) for case in SHAPES for wide in (False, True)[:1 + (case[2] > 1)]])
def test_merged_and_unmerged_adds_in_one_launch(lib, batch, spatial, nch, wide, monkeypatch):
    """A smooth field of up to 3 voxels, whose neighbouring lanes merge
    their shared corners' terms, with a patch of jumps of up to 40 voxels
    in the last sample, whose lanes add their own: each output's 8 terms
    added once, by its own add or merged into a neighbour's."""
    if wide:  # interpn's wide-channel path, which takes more than one channel
        monkeypatch.setattr(interp, "_CORNER_TABLE_BYTES_LIMIT", 0)
        assert wg.is_wide(spatial, nch)
    rng, vol, g = _case(nch, batch, spatial, nch)
    shift = _smooth(rng, batch, spatial, 3.0)
    patch = (-1, slice(4, 8), slice(8, 16), slice(0, 32))
    shift[patch] = rng.uniform(-40, 40, size=shift[patch].shape)
    shift = torch.from_numpy(shift)
    out, dvol, dshift, fwd_work, bwd_work = _run(lib, vol, shift, g, wide)
    _assert_equals_plain(vol, shift, g, out, dvol, dshift)
    outputs = vol.numel() // nch
    ran, adds, merged = bwd_work
    assert fwd_work == [1] and ran == 1
    assert adds + merged == 8 * outputs and 0 < merged < 4 * outputs


@pytest.mark.parametrize("batch,spatial,nch", SHAPES)
def test_edges_exactly_and_beyond(lib, batch, spatial, nch):
    """Coordinates exactly on 0 and on dim - 1, where the clamp's gradient
    takes its edge value and the +1 corner its wrapped voxel, and beyond
    both, on a rough field (up to 6 voxels)."""
    rng, vol, g = _case(10 + nch, batch, spatial, nch)
    shift = rng.uniform(-6, 6, size=(batch, *spatial, 3)).astype(np.float32)
    for axis, dim in enumerate(spatial):
        pos = np.arange(dim, dtype=np.float32).reshape([-1 if a == axis else 1 for a in range(3)])
        idx = [slice(None)] * 5
        idx[4] = axis
        for rows, target in ((slice(0, 2), 0.0), (slice(2, 4), float(dim - 1)),
                             (slice(4, 5), -3.0), (slice(5, 6), float(dim + 2))):
            idx[1 + (axis + 1) % 3] = rows
            shift[tuple(idx)] = np.broadcast_to(target - pos, shift[tuple(idx)].shape)
    shift = torch.from_numpy(shift)
    loc = interp.ndgrid(spatial) + shift
    for axis, dim in enumerate(spatial):
        assert (loc[..., axis] == 0).any() and (loc[..., axis] == dim - 1).any()
    out, dvol, dshift, fwd_work, bwd_work = _run(lib, vol, shift, g)
    _assert_equals_plain(vol, shift, g, out, dvol, dshift)
    assert fwd_work == [1] and bwd_work[0] == 1
    assert bwd_work[1] + bwd_work[2] == 8 * vol.numel() // nch


@pytest.mark.parametrize("nch,wide", [(1, False), (2, False), (3, False), (4, False),
                                      (2, True), (3, True), (4, True)])
def test_negative_zero_inf_and_nan_at_zero_weight_corners(lib, nch, wide, monkeypatch):
    """Negative values, zeros, and inf and NaN at the voxels that the
    top-edge corners (weight exactly 0) wrap to: plane 0 (the +1 corner of
    z = D - 1) and column 0 (of x = W - 1). Forward and dshift bit-equal,
    NaN and -0 included."""
    if wide:
        monkeypatch.setattr(interp, "_CORNER_TABLE_BYTES_LIMIT", 0)
    spatial = (6, 9, 34)
    rng, vol, g = _case(20 + nch, 1, spatial, nch)
    vol = -vol.abs()
    vol[0, :, :, 7:9] = -0.0
    vol[0, 0, 2:5, 3:6, 0] = float("inf")
    vol[0, 0, 6:8, 10:12, -1] = float("-inf")
    vol[0, 1:4, 1:3, 0, 0] = float("nan")
    vol[0, -1, -1, -1, 0] = float("nan")  # the wide path's clipped corner
    shift = rng.uniform(-1.5, 1.5, size=(1, *spatial, 3)).astype(np.float32)
    shift[0, -3:, :, :, 0] = 3.0  # z clamped to D - 1
    shift[0, :, :, -4:, 2] = 4.5  # x clamped to W - 1
    shift[0, :, 3:5, :, 1:] = 0.0
    shift[0, :-3, 3:5, :, 0] = 0.0  # integer coordinates: -0 times weight 1
    shift = torch.from_numpy(shift)
    out, dvol, dshift, _, _ = _run(lib, vol, shift, g, wide)
    ref = wg.warp_gather_plain(vol, shift)
    ref_vol, ref_shift = wg.warp_gather_bwd_plain(vol, shift, g)
    assert torch.isnan(ref).any() and torch.isnan(ref_shift).any()
    assert (_bits(ref) == _bits(torch.tensor(-0.0))).any()
    assert _same_bits(out, ref)
    assert _same_bits(dshift, ref_shift)
    assert_rel_close(dvol, ref_vol, DVOL_RTOL, "gather dvol")


@pytest.mark.parametrize("batch,spatial,nch", SHAPES)
def test_null_dvol_computes_the_same_dshift(lib, batch, spatial, nch):
    """With a null dvol the backward adds nothing anywhere (it counts no
    add), and dshift is bit-equal to the backward's with dvol."""
    rng, vol, g = _case(30 + nch, batch, spatial, nch)
    shift = torch.from_numpy(_smooth(rng, batch, spatial, 4.0))
    _, dvol, dshift, _, _ = _run(lib, vol, shift, g)
    _, none, dshift_alone, _, bwd_work = _run(lib, vol, shift, g, with_dvol=False)
    assert none is None and bwd_work == [1, 0, 0]
    assert _same_bits(dshift_alone, dshift)
    ref_vol, ref_shift = wg.warp_gather_bwd_plain(vol, shift, g)
    assert _same_bits(dshift_alone, ref_shift)
    assert_rel_close(dvol, ref_vol, DVOL_RTOL, "gather dvol")


@pytest.mark.parametrize("batch,spatial,nch", SHAPES[:2])
def test_kernels_against_the_jax_package(lib, batch, spatial, nch):
    """The emulated kernels against voxelmorph_tpu.ops.interp.interpn and
    its jax.vjp on the same numpy inputs, sample by sample, within
    JAX_RTOL of each output's largest magnitude."""
    rng, vol, g = _case(40 + nch, batch, spatial, nch)
    shift = _smooth(rng, batch, spatial, 3.0)
    shift[0, 1:3] += rng.uniform(-5, 5, size=(2, *spatial[1:], 3)).astype(np.float32)
    shift = torch.from_numpy(shift)
    out, dvol, dshift, _, _ = _run(lib, vol, shift, g)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in spatial],
                                indexing="ij"), -1)
    for b in range(batch):
        fn = lambda v, s: jax_interp.interpn(v, jnp.asarray(grid) + s)  # noqa: E731
        ref, vjp = jax.vjp(fn, jnp.asarray(vol[b].numpy()), jnp.asarray(shift[b].numpy()))
        ref_vol, ref_shift = vjp(jnp.asarray(g[b].numpy()))
        for got, want, name in ((out[b], ref, "forward"), (dvol[b], ref_vol, "dvol"),
                                (dshift[b], ref_shift, "dshift")):
            assert_rel_close(got.numpy(), np.asarray(want), JAX_RTOL, name)


@pytest.mark.parametrize("batch,spatial,nch", SHAPES)
def test_package_build_equals_the_counting_build(lib, package_lib, batch, spatial, nch):
    """The package's build, which counts nothing past the launches that
    ran, computes what the counting build computes."""
    rng, vol, g = _case(50 + nch, batch, spatial, nch)
    shift = _smooth(rng, batch, spatial, 3.0)
    shift[0, :2] += rng.uniform(-5, 5, size=shift[0, :2].shape).astype(np.float32)
    shift = torch.from_numpy(shift)
    out, dvol, dshift, _, _ = _run(lib, vol, shift, g)
    pout, pdvol, pdshift, fwd_work, bwd_work = _run(package_lib, vol, shift, g)
    assert fwd_work == [1] and bwd_work == [1, 0, 0]
    assert _same_bits(pout, out) and _same_bits(pdshift, dshift)
    assert_rel_close(pdvol, dvol, DVOL_RTOL, "dvol, package build")


@pytest.mark.parametrize("batch,spatial,nch", [
    (3, (3, 9, 33), 1), (3, (4, 17, 65), 2), (4, (5, 8, 31), 3), (3, (1, 1, 70), 4)])
def test_every_tile_of_every_sample_once(lib, batch, spatial, nch):
    """The flat grid's blocks, decoded into (x, y) tiles and plane-runs of
    each sample, cover every output once: every output and dshift element
    written (the buffers start NaN) and bit-equal to the plain version,
    each output's 8 dvol terms added once."""
    rng, vol, g = _case(60 + nch, batch, spatial, nch)
    shift = _smooth(rng, batch, spatial, 2.0)
    shift[-1] += rng.uniform(-4, 4, size=shift[-1].shape).astype(np.float32)
    shift = torch.from_numpy(shift)
    out, dvol, dshift, fwd_work, bwd_work = _run(lib, vol, shift, g)
    assert not torch.isnan(out).any() and not torch.isnan(dshift).any()
    _assert_equals_plain(vol, shift, g, out, dvol, dshift)
    assert fwd_work == [1] and bwd_work[0] == 1
    assert bwd_work[1] + bwd_work[2] == 8 * vol.numel() // nch


@pytest.mark.parametrize("name", ["vxm_warp_gather_fwd", "vxm_warp_gather_bwd"])
def test_a_launch_of_more_than_2_to_the_31_blocks_is_refused(lib, name):
    """The grid is one-dimensional, so a launch takes at most 2^31 - 1
    blocks (tiles of 32 x 8 x 2 outputs); past that the entry point
    returns cudaErrorInvalidValue (1) before it touches a buffer."""
    fn = _entry(lib, name)
    tensors = [None] * (3 if name.endswith("fwd") else 5)
    if name.endswith("bwd"):
        tensors[-1] = 1  # a dshift pointer: the backward refuses a null one first
    B, D, H, W = 2 ** 22, 2 ** 10, 8, 32  # 2^22 samples of 2^9 tiles each
    assert fn(*tensors, B, D, H, W, 1, 0, None, 0, None, None) == 1


def test_wrapper_refuses_a_strided_output():
    """The kernels write their outputs as contiguous buffers: a strided one
    (such as empty_like of a strided shift) is refused, not written in the
    wrong order."""
    like = torch.zeros(1, 2, 3, 4, 3)
    strided = torch.zeros(3, 1, 2, 3, 4).movedim(0, -1)
    assert strided.shape == like.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        wg._check_out(strided, like, "dshift")
    with pytest.raises(ValueError, match="float32"):
        wg._check_out(like.double(), like, "dvol")
    wg._check_out(strided.contiguous(), like, "dshift")
