"""The tiered warp's predicated kernels, run on the CPU under emulation.

On CUDA tensors ``ops.warp`` computes the tier index of the JAX package's
``lax.switch`` (``sum(max|d| > h for h in {1, H})``) on the device and
launches every branch with it: the halo-1 and halo-H bounded kernels of
``csrc/warp_bounded.cu`` and the gather kernel of ``csrc/warp_gather.cu``,
each running only where the word names it. Here the sources are compiled
for the CPU against ``tests/cuda_emulation/`` (as in
``test_torch_kernel_emulation.py``) and launched as the tiered warp launches
them, at each tier, with fields of max|d| <= 1, <= H and > H, coordinates
exactly on 0 and dim - 1, and 1 to 4 channels. Each kernel writes its own
NaN-filled buffer (the gather's dvol, which it adds into, zeroed where the
gather is named): the branches not named must leave theirs untouched, and
the named one must equal its plain version, bit for bit (the bounded
kernels, the gather's forward and its dshift) or, for the gather's dvol,
whose atomic scatter-adds sum in another order, within ``DVOL_RTOL`` of its
largest magnitude. The device work counters must count the named kernel
once and the others never.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_kernel_emulation import _compile
from torch_parity import assert_rel_close, bounded_case
from voxelmorph_tpu_torch.ops import interp
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.ops import warp_bounded as wb
from voxelmorph_tpu_torch.ops import warp_gather as wg

# the full halo H of the tiers {1, H}
HALO = 2
# the gather's dvol against autograd's: the same float32 products summed
# in another order (atomic adds in any order against index_put's)
DVOL_RTOL = 1e-6
# (batch, spatial, channels): partial tiles and ragged z runs, as in the
# kernel emulation's cases
SHAPES = [(1, (6, 9, 34), 1), (2, (5, 7, 33), 3), (1, (7, 10, 35), 2), (1, (5, 6, 34), 4)]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return (_compile(tmp_path_factory, "warp_bounded", ["tile"], 2),
            _compile(tmp_path_factory, "warp_gather", [], 2))


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _field(tier, batch, spatial, nch, seed):
    """vol and a shift whose max|d| is <= 1 (tier 0), in (1, HALO] (tier 1)
    or above HALO (tier 2), with bands across every edge and coordinates
    exactly on 0 and dim - 1."""
    bound = {0: 1, 1: HALO, 2: HALO + 2}[tier]
    vol, shift = bounded_case(seed, spatial, nch, bound, batch=batch)
    if tier == 2:
        # exact edge coordinates of the gather: x + shift == 0 and dim - 1
        for axis, dim in enumerate(spatial):
            idx = [slice(None)] * 5
            idx[1 + axis], idx[4] = 3, axis
            shift[tuple(idx)] = -3.0
            idx[1 + axis] = 1
            shift[tuple(idx)] = float(dim - 2)
    shift = torch.from_numpy(shift)
    assert int(warp_ops.tier_index(shift, (1, HALO))) == tier
    return torch.from_numpy(vol), shift


def _branches():
    """(name, halo) of each branch in launch order: the tier each serves is
    its position."""
    return [("bounded", 1), ("bounded", HALO), ("gather", None)]


@pytest.mark.parametrize("tier", [0, 1, 2])
@pytest.mark.parametrize("batch,spatial,nch", SHAPES)
def test_predicated_forward_runs_only_the_named_branch(libs, tier, batch, spatial, nch):
    bounded_lib, gather_lib = libs
    vol, shift = _field(tier, batch, spatial, nch, seed=10 * tier + nch)
    word = warp_ops.tier_index(shift, (1, HALO))
    work = torch.zeros(len(wb.WORK_SLOTS), dtype=torch.int32)
    fwd = _fn(bounded_lib, "vxm_warp_bounded_fwd", wb._ARGTYPES["vxm_warp_bounded_fwd"])
    gfwd = _fn(gather_lib, "vxm_warp_gather_fwd", wg._ARGTYPES["vxm_warp_gather_fwd"])
    outs = []
    for serve, (kind, halo) in enumerate(_branches()):
        out = torch.full_like(vol, float("nan"))
        if kind == "bounded":
            err = fwd(vol.data_ptr(), shift.data_ptr(), out.data_ptr(), batch, *spatial, nch,
                      halo, word.data_ptr(), serve, work[0:].data_ptr(), None)
        else:
            err = gfwd(vol.data_ptr(), shift.data_ptr(), out.data_ptr(), batch, *spatial, nch, 0,
                       word.data_ptr(), serve, work[2:].data_ptr(), None)
        assert err == 0
        outs.append(out)
    for serve, out in enumerate(outs):
        if serve != tier:
            assert torch.isnan(out).all(), f"branch {serve} wrote at tier {tier}"
    plain = (wg.warp_gather_plain(vol, shift) if tier == 2
             else wb.windowed_transform(vol, shift, _branches()[tier][1]))
    assert torch.equal(outs[tier], plain)
    assert work.tolist() == [int(tier < 2), 0, int(tier == 2), 0]


@pytest.mark.parametrize("tier", [0, 1, 2])
@pytest.mark.parametrize("batch,spatial,nch", SHAPES)
def test_predicated_backward_runs_only_the_named_branch(libs, tier, batch, spatial, nch):
    bounded_lib, gather_lib = libs
    vol, shift = _field(tier, batch, spatial, nch, seed=10 * tier + nch + 5)
    g = torch.from_numpy(np.random.default_rng(nch).normal(size=vol.shape).astype(np.float32))
    word = warp_ops.tier_index(shift, (1, HALO))
    work = torch.zeros(len(wb.WORK_SLOTS), dtype=torch.int32)
    bwd = _fn(bounded_lib, "vxm_warp_bounded_bwd", wb._ARGTYPES["vxm_warp_bounded_bwd"])
    gbwd = _fn(gather_lib, "vxm_warp_gather_bwd", wg._ARGTYPES["vxm_warp_gather_bwd"])
    grads = []
    for serve, (kind, halo) in enumerate(_branches()):
        # the gather adds into its dvol: zeroed where it is named
        dvol = torch.full_like(vol, 0.0 if kind == "gather" and serve == tier else float("nan"))
        dshift = torch.full_like(shift, float("nan"))
        ptrs = (vol.data_ptr(), shift.data_ptr(), g.data_ptr(), dvol.data_ptr(), dshift.data_ptr())
        if kind == "bounded":
            err = bwd(*ptrs, batch, *spatial, nch, halo, word.data_ptr(), serve,
                      work[1:].data_ptr(), None)
        else:
            err = gbwd(*ptrs, batch, *spatial, nch, 0, word.data_ptr(), serve,
                       work[3:].data_ptr(), None)
        assert err == 0
        grads.append((dvol, dshift))
    for serve, (dvol, dshift) in enumerate(grads):
        if serve != tier:
            assert torch.isnan(dvol).all() and torch.isnan(dshift).all()
    dvol, dshift = grads[tier]
    if tier == 2:
        ref_vol, ref_shift = wg.warp_gather_bwd_plain(vol, shift, g)
        assert_rel_close(dvol, ref_vol, DVOL_RTOL, "gather dvol")
    else:
        ref_vol, ref_shift = wb.warp_bounded_bwd_plain(vol, shift, g, _branches()[tier][1])
        assert torch.equal(dvol, ref_vol)
    assert ref_shift.abs().max() > 1
    assert torch.equal(dshift, ref_shift)
    assert work.tolist() == [0, int(tier < 2), 0, int(tier == 2)]


@pytest.mark.parametrize("nch", [2, 3])
def test_gather_kernel_wide_channel_path(libs, nch, monkeypatch):
    """With the wide flag the kernel takes interpn's wide-channel rules (the
    +1 corner clipped to the last voxel, the coordinate gradient masked to
    [0, dim - 1] with no half at the edges): bit-equal to interpn forced
    onto that path."""
    _, gather_lib = libs
    monkeypatch.setattr(interp, "_CORNER_TABLE_BYTES_LIMIT", 0)
    spatial = (5, 6, 33)
    assert wg.is_wide(spatial, nch) and not wg.is_wide(spatial, 1)
    vol, shift = _field(2, 1, spatial, nch, seed=40 + nch)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=vol.shape).astype(np.float32))
    out = torch.full_like(vol, float("nan"))
    gfwd = _fn(gather_lib, "vxm_warp_gather_fwd", wg._ARGTYPES["vxm_warp_gather_fwd"])
    assert gfwd(vol.data_ptr(), shift.data_ptr(), out.data_ptr(), 1, *spatial, nch, 1,
                None, 0, None, None) == 0
    assert torch.equal(out, wg.warp_gather_plain(vol, shift))
    dvol, dshift = torch.zeros_like(vol), torch.full_like(shift, float("nan"))
    gbwd = _fn(gather_lib, "vxm_warp_gather_bwd", wg._ARGTYPES["vxm_warp_gather_bwd"])
    assert gbwd(vol.data_ptr(), shift.data_ptr(), g.data_ptr(), dvol.data_ptr(),
                dshift.data_ptr(), 1, *spatial, nch, 1, None, 0, None, None) == 0
    ref_vol, ref_shift = wg.warp_gather_bwd_plain(vol, shift, g)
    assert_rel_close(dvol, ref_vol, DVOL_RTOL, "wide dvol")
    assert torch.equal(dshift, ref_shift)


def test_tier_index_is_the_jax_switch_index():
    """The device index equals the JAX package's, on the field's dtype:
    exactly on a halo stays below it."""
    import jax.numpy as jnp

    for max_d in (0.0, 0.5, 1.0, np.nextafter(np.float32(1), np.float32(2)), 2.0, 2.5, 7.0):
        for halos in ((1,), (1, 2), (1, 4)):
            shift = torch.zeros(1, 2, 2, 2, 3)
            shift[0, 1, 0, 1, 2] = -float(max_d)
            ref = sum(jnp.int32(jnp.max(jnp.abs(shift.numpy())) > float(h)) for h in halos)
            got = warp_ops.tier_index(shift, halos)
            assert got.dtype == torch.int32 and int(got) == int(ref)
