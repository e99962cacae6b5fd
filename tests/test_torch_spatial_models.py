"""Spatial sharding (the mesh's 'space' axis) of the semi-supervised,
point-cloud, SynthMorph and HyperMorph models against the JAX package's
GSPMD mesh on the CPU, and the slab pieces they add: the hyper conv block
on exchanged slabs and ``slab_of``.

The scenarios of ``tests/torch_spatial_models_ranks.py``'s "models" group
run twice, in this process (one rank, unsharded) and in a gloo world of
four processes started once for the module, at (24, 8, 8) with a two-pool
U-Net: two steps on (1, 4) (slabs 8/8/4/4) of each class, and on (2, 2)
at batch 2 of VxmDenseSemiSupervisedSeg and HyperVxmDense, each held to
JAX's ``Trainer(spatial_shard=True)`` on 4 of its devices and to the port
in one process (``tests/spatial_models_parity.py`` has the tolerances).
The segmentations, SDTs and surface points arrive whole (not as slabs);
SynthMorph's label maps too, its synthesis running whole on every rank on
draws replayed from JAX's keys, its images cut to slabs for the U-Net.
"""

import copy

import numpy as np
import pytest
import torch

import spatial_models_parity as parity
from test_torch_spatial import _Hub, _on_threads, _ThreadSpace
from voxelmorph_tpu_torch.models.unet import ConvBlock
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

GROUP = "models"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return parity.launch(GROUP, tmp_path_factory.mktemp("spatial_models"))


@pytest.mark.parametrize("scenario,name,mesh_shape,batch", [
    ("semi_seg", "semi_seg", (1, 4), 1), ("semi_seg_grid", "semi_seg", (2, 2), 2),
    ("pointcloud", "pointcloud", (1, 4), 1), ("synthmorph", "synthmorph", (1, 4), 1),
    ("hyper", "hyper", (1, 4), 1), ("hyper_grid", "hyper", (2, 2), 2)])
def test_sharded_steps_match_jax_and_one_process(runs, scenario, name, mesh_shape, batch):
    """Two steps of each class's recipe on the mesh: the losses, params and
    the moved image of an eval forward after them, against JAX's spatially
    sharded Trainer and the port in one process."""
    parity.hold(runs, scenario, name, mesh_shape, batch)


@pytest.mark.parametrize("scenario", [s[0] for s in parity.ranks.GROUPS[GROUP]])
def test_ranks_end_bit_equal(runs, scenario):
    parity.assert_ranks_alike(runs, scenario)


@pytest.mark.parametrize("scenario", ["semi_seg", "pointcloud", "synthmorph", "hyper"])
def test_no_parameter_is_used_whole(runs, scenario):
    """These classes use every parameter on the slabs alone (the MLP of
    HyperVxmDense reaches the loss through the slabs' generated kernels):
    each gradient of the first sharded step is one process's."""
    got, one = runs[4][scenario]["grads"], runs[1][scenario]["grads"]
    for n, g in one.items():
        scale = np.abs(g).max()
        assert np.abs(got[n] - g).max() <= parity.GRAD_RTOL * scale, n


def test_sharded_eval_forward_matches_jax(runs):
    """The eval forwards on slabs: HyperVxmDense at batch 2 on (2, 2) (its
    source and target as slabs of 12 planes, lambda whole) and
    SynthMorphDense on (1, 4) (the label maps whole, the images cut for the
    U-Net), gathered, against JAX's forward on arrays sharded over its mesh
    and against one process."""
    parity.hold_serving(runs, GROUP)


# (ndims, do_res, in, out): a hyper block, one with a resfix HyperConv (the
# widths differ) and one adding its input, a 2-D block
HYPER_BLOCKS = [(3, False, 6, 8), (3, True, 6, 8), (3, True, 6, 6), (2, False, 6, 8)]


@pytest.mark.parametrize("ndims,do_res,cin,cout", HYPER_BLOCKS)
def test_hyper_conv_block_on_exchanged_slabs_matches_the_volume(ndims, do_res, cin, cout):
    """A hyper ConvBlock on each of four slabs (8/8/4/4 of 24 planes)
    widened by halo_exchange, its HyperConvs convolving without padding the
    first spatial dim: the output, and the gradients of the input, the
    embedding and the generators' weights of a random cotangent, against
    the block on the whole volume (the slabs' gradients summed)."""
    rng = np.random.default_rng(7)
    spatial = (24, 8, 16)[:ndims]
    x = torch.from_numpy(rng.normal(size=(2, cin, *spatial)).astype(np.float32))
    hyp = torch.from_numpy(rng.uniform(size=(2, 3)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(2, cout, *spatial)).astype(np.float32))
    block = ConvBlock(cin, cout, ndims, do_res=do_res, hyper=True, nb_hyp_units=3,
                      generator=torch.Generator().manual_seed(1))
    whole_x, whole_h = x.clone().requires_grad_(), hyp.clone().requires_grad_()
    whole = block(whole_x, whole_h)
    whole.backward(gy)
    bounds = mesh_lib.slab_bounds(24, 4, 4)
    hub = _Hub(4)

    def rank(i):
        lo, hi = bounds[i]
        mine = copy.deepcopy(block)
        mine.zero_grad()
        xs, hs = x[:, :, lo:hi].clone().requires_grad_(), hyp.clone().requires_grad_()
        ext = mesh_lib.halo_exchange(xs, 1, 2, _ThreadSpace(hub, 4, i, 24, 4))
        out = mine(ext, hs, 24)
        out.backward(gy[:, :, lo:hi])
        return out.detach(), xs.grad, hs.grad, {n: p.grad for n, p in mine.named_parameters()}

    parts = _on_threads(4, rank)

    def close(a, b, label):
        scale = b.abs().max()
        assert scale > 0 and (a - b).abs().max() <= 1e-5 * scale, label

    close(torch.cat([p[0] for p in parts], 2), whole.detach(), "output")
    close(torch.cat([p[1] for p in parts], 2), whole_x.grad, "input gradient")
    close(sum(p[2] for p in parts), whole_h.grad, "embedding gradient")
    for name, p in block.named_parameters():
        close(sum(part[3][name] for part in parts), p.grad, name)


def test_slab_of_on_threads():
    """slab_of gives each of four ranks its slab (8/8/4/4 of 24 planes in
    units of 4) of a tensor whole on each, and its backward the whole
    cotangent on every rank, the sum of the ranks' slabs of it: the adjoint
    of gather_space."""
    rng = np.random.default_rng(8)
    field = torch.from_numpy(rng.normal(size=(2, 24, 4, 4, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=field.shape).astype(np.float32))
    bounds = mesh_lib.slab_bounds(24, 4, 4)
    hub = _Hub(4)

    def rank(i):
        lo, hi = bounds[i]
        whole = field.clone().requires_grad_()
        part = mesh_lib.slab_of(whole, 1, 4, _ThreadSpace(hub, 4, i, None, 1))
        part.backward(g[:, lo:hi])
        return part.detach(), whole.grad

    results = _on_threads(4, rank)
    assert torch.equal(torch.cat([part for part, _ in results], 1), field)
    for _, grad in results:
        assert torch.equal(grad, g)
    # outside spatial: the tensor itself
    assert mesh_lib.slab_of(field, 1, 4) is field
