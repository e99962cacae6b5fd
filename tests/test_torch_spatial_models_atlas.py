"""Spatial sharding (the mesh's 'space' axis) of the atlas models, instance
optimisation and SynthMorph's joint model against the JAX package's GSPMD
mesh on the CPU.

The scenarios of ``tests/torch_spatial_models_ranks.py``'s "atlas" group
run twice, in this process (one rank, unsharded) and in a gloo world of
four processes started once for the module, at (24, 8, 8): two steps on
(1, 4) of TemplateCreation (and on (2, 2) at batch 2),
ConditionalTemplateCreation, InstanceDense, ProbAtlasSegmentation (its stat
convs on the U-Net's slabs, and with ``stat_post_warp`` on slabs of the
warped atlas and the image) and HyperVxmJoint (its deformable stage on
4/4/2/2-plane slabs of the half-resolution pair), each held to JAX's
``Trainer(spatial_shard=True)`` on 4 of its devices and to the port in one
process (``tests/spatial_models_parity.py`` has the tolerances); and
ProbAtlasSegmentation in conv-kernel mode (the kernel's plain version on
the CPU: JAX's pallas_call has no GSPMD rule) against one process. These
classes use parameters whole on every rank of a row (the template's atlas,
the conditional template's decoder, the instance flow, the joint model's
affine detector): their reduced gradients must be one process's, averaged
over 'space', not summed.
"""

import numpy as np
import pytest
import torch

import spatial_models_parity as parity
from voxelmorph_tpu_torch.models import modelio

GROUP = "atlas"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return parity.launch(GROUP, tmp_path_factory.mktemp("spatial_atlas"))


@pytest.mark.parametrize("scenario,name,mesh_shape,batch", [
    ("template", "template", (1, 4), 1), ("template_grid", "template", (2, 2), 2),
    ("cond_template", "cond_template", (1, 4), 1), ("instance", "instance", (1, 4), 1),
    ("prob_atlas", "prob_atlas", (1, 4), 1), ("prob_atlas_post", "prob_atlas_post", (1, 4), 1)])
def test_sharded_steps_match_jax_and_one_process(runs, scenario, name, mesh_shape, batch):
    """Two steps of each class's recipe on the mesh: the losses, params,
    MeanStream's buffers and the moved image of an eval forward after them,
    against JAX's spatially sharded Trainer and the port in one process."""
    parity.hold(runs, scenario, name, mesh_shape, batch)


def test_joint_sharded_steps_match_jax_and_one_process(runs):
    """HyperVxmJoint on (1, 4): its first sharded step's loss and gradients
    against JAX's sharded step's and one process's (within 1e-4 of each
    tensor's largest entry), and two steps' losses and moved image against
    JAX's spatially sharded Trainer and the port in one process. Its params
    after Adam's steps are not held: the untrained detector's dead
    features have gradients of the order of Adam's eps, whose update
    lr g / (|g| + eps) follows their rounding in sign and size (measured:
    22 of 1768627 weights of affine.detector.add_1 apart by up to 1.2e-5
    after one step, within 1e-4 of the gradients' largest entries, where
    JAX's sharded and one-device Trainers agree bit for bit)."""
    parity.hold(runs, "joint", "joint", (1, 4), 1, jax_reference="gradients")


def test_joint_sharded_eval_forward_matches_jax(runs):
    """HyperVxmJoint's eval forward on (1, 4) from the case's params (the
    images whole, its deformable stage on 4/4/2/2-plane slabs of the
    half-resolution pair), its moved image gathered, against JAX's forward
    on arrays sharded over its mesh and against one process."""
    parity.hold_serving(runs, GROUP, train_kwarg=False)


def test_prob_atlas_conv_kernel_matches_one_process(runs):
    """ProbAtlasSegmentation in conv-kernel mode on (1, 4): the U-Net's and
    the stat ConvBlocks' convs on exchanged slabs, against one process; no
    input or cotangent copied to channels-last."""
    parity.hold(runs, "prob_atlas_conv", "prob_atlas", (1, 4), 1, jax_reference=None)
    assert runs[4]["prob_atlas_conv"]["layout_copies"] == 0


@pytest.mark.parametrize("scenario", [s[0] for s in parity.ranks.GROUPS[GROUP]])
def test_ranks_end_bit_equal(runs, scenario):
    parity.assert_ranks_alike(runs, scenario)


def _whole(name):
    """The state-dict names of model ``name``'s whole_parameters."""
    net = parity.ranks.build(name)
    ids = {id(p) for p in net.whole_parameters()}
    return [n for n, p in net.named_parameters() if id(p) in ids]


@pytest.mark.parametrize("scenario,name,expected", [
    ("template", "template", ["atlas"]), ("template_grid", "template", ["atlas"]),
    ("cond_template", "cond_template", ["pheno_dense.weight", "atlas_gen.weight"]),
    ("instance", "instance", ["flow"]),
    ("joint", "joint", ["affine.detector.enc_0_0.weight", "affine.detector.feat.weight"])])
def test_whole_parameters_take_one_process_gradient(runs, scenario, name, expected):
    """Each parameter used whole on every rank of a row has, after DDP's
    reduction, the gradient of one process at the same params (within
    1e-4 of its largest entry), not four (or two) times it."""
    names = _whole(name)
    assert set(expected) <= set(names)
    parity.assert_whole_gradients(runs, scenario, names)


@pytest.mark.parametrize("scenario,name", [("prob_atlas", "prob_atlas"),
                                           ("prob_atlas_post", "prob_atlas_post")])
def test_prob_atlas_uses_no_parameter_whole(runs, scenario, name):
    """ProbAtlasSegmentation runs its stat convs on slabs in both variants:
    no whole parameter, and every gradient of the first sharded step is one
    process's (the VALID convs' too, gathered at their own extents)."""
    assert _whole(name) == []
    got, one = runs[4][scenario]["grads"], runs[1][scenario]["grads"]
    for n, g in one.items():
        scale = np.abs(g).max()
        assert np.abs(got[n] - g).max() <= parity.GRAD_RTOL * scale, n


def test_template_stream_folds_in_the_global_batch(runs):
    """MeanStream's count after two steps at batch 2 on (2, 2): every rank of
    the grid counts the global batch once (4 samples), not once per rank of
    its row."""
    for out in runs["ranks"]:
        state = modelio.state_to_jax(parity.ranks.build("template"), {
            k: torch.from_numpy(v)
            for k, v in out["template_grid"]["params"].items()})
        assert float(state["stream||mean_stream||count"]) == 4.0
