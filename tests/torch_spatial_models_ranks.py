"""The spatial-sharding scenarios of every model class but VxmDense
(``tests/test_torch_spatial_models.py`` and
``tests/test_torch_spatial_models_atlas.py``).

Each scenario trains one model class on a mesh whose 'space' axis is > 1
(or in one process, unsharded) and returns numpy results. A test runs every
scenario of its group in one process (a world of one rank) and in each rank
of a gloo world of four, started as

    python tests/torch_spatial_models_ranks.py GROUP RANK WORLD STORE DIR

which joins the world through the ``file://`` store ``STORE``, reads the
case from ``DIR/case.pkl`` (made with numpy and the JAX package in the test
process: the params in the JAX layout, the batches, SynthMorph's synthesis
draws replayed from JAX's keys) and writes its results to
``DIR/rank{RANK}.pkl``. The volumes are (24, 8, 8) with a two-pool U-Net,
so that (1, 4) cuts them into uneven slabs of 8/8/4/4 planes and (2, 2)
into 12/12; HyperVxmJoint's deformable stage cuts its half-resolution
(12, 4, 4) pair in units of 2, as 4/4/2/2. The loss terms are written once
for both packages (``terms``: each takes a package's ``losses`` module and
``LossTerm`` class). The module imports torch, numpy and the port only.
"""

import os
import pickle
import sys

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from voxelmorph_tpu_torch import losses  # noqa: E402
from voxelmorph_tpu_torch import models  # noqa: E402
from voxelmorph_tpu_torch.models import modelio  # noqa: E402
from voxelmorph_tpu_torch.models import synthmorph  # noqa: E402
from voxelmorph_tpu_torch.ops import conv3  # noqa: E402
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from voxelmorph_tpu_torch.training import LossTerm, Trainer  # noqa: E402

SHAPE = (24, 8, 8)
FEATS = [[4, 4], [4, 4, 4]]
LR = 1e-3
# InstanceDense's flow parameter is scaled by 1000: at 1e-3 Adam's first
# step moves every displacement by a voxel, onto the integer crossings
# where the warps' derivatives jump, and the second step's gradients there
# part the packages; 1e-4, as chip_smoke.py's phase 10 takes it
INSTANCE_LR = 1e-4
STEPS = 2
LABELS = 3
POINTS = 16
SYNTH_LABELS = [0, 1, 2, 3]
# LabelsToImageConfig's fields for SynthMorph (both packages)
SYNTH_CFG = dict(in_shape=SHAPE, in_label_list=SYNTH_LABELS, warp_std=2.0, warp_res=[8],
                 warp_int_steps=2, bias_res=[8])

# the model of each scenario: its class's name and constructor fields
# (the JAX module's, but for SynthMorph's cfg, made per package)
MODELS = {
    "semi_seg": ("VxmDenseSemiSupervisedSeg", dict(
        inshape=SHAPE, nb_labels=LABELS, nb_unet_features=FEATS, int_steps=1,
        bidir_labels=True)),
    "pointcloud": ("VxmDenseSemiSupervisedPointCloud", dict(
        inshape=SHAPE, nb_surface_points=POINTS, nb_labels_sample=2, nb_unet_features=FEATS,
        int_steps=1)),
    "synthmorph": ("SynthMorphDense", dict(nb_unet_features=FEATS, int_steps=1)),
    "hyper": ("HyperVxmDense", dict(inshape=SHAPE, nb_hyp_layers=2, nb_hyp_units=4,
                                    nb_unet_features=FEATS, int_steps=1)),
    "template": ("TemplateCreation", dict(inshape=SHAPE, nb_unet_features=FEATS, int_steps=1,
                                          mean_cap=4)),
    "cond_template": ("ConditionalTemplateCreation", dict(
        inshape=SHAPE, pheno_input_shape=(2,), nb_unet_features=FEATS, conv_nb_features=4,
        extra_conv_layers=1, int_steps=1)),
    "instance": ("InstanceDense", dict(inshape=SHAPE, int_steps=1)),
    "prob_atlas": ("ProbAtlasSegmentation", dict(
        inshape=SHAPE, nb_labels=LABELS, nb_unet_features=FEATS, stat_nb_feats=4,
        int_steps=1, init_mu=[0.2, 0.5, 0.8], init_sigma=[0.2, 0.2, 0.2])),
    "prob_atlas_post": ("ProbAtlasSegmentation", dict(
        inshape=SHAPE, nb_labels=LABELS, nb_unet_features=FEATS, stat_nb_feats=4,
        int_steps=1, stat_post_warp=True)),
    "joint": ("HyperVxmJoint", dict(in_shape=SHAPE, hyp_units=(4,), enc_nf=(4,), dec_nf=(4,),
                                    add_nf=(4,), int_steps=1, return_moved=True,
                                    aff_num_feat=16, aff_enc_nf=(4,))),
}

# (scenario, model, mesh shape, batch, conv-kernel mode)
GROUPS = {
    "models": [("semi_seg", "semi_seg", (1, 4), 1, False),
               ("semi_seg_grid", "semi_seg", (2, 2), 2, False),
               ("pointcloud", "pointcloud", (1, 4), 1, False),
               ("synthmorph", "synthmorph", (1, 4), 1, False),
               ("hyper", "hyper", (1, 4), 1, False),
               ("hyper_grid", "hyper", (2, 2), 2, False)],
    "atlas": [("template", "template", (1, 4), 1, False),
              ("template_grid", "template", (2, 2), 2, False),
              ("cond_template", "cond_template", (1, 4), 1, False),
              ("instance", "instance", (1, 4), 1, False),
              ("prob_atlas", "prob_atlas", (1, 4), 1, False),
              ("prob_atlas_conv", "prob_atlas", (1, 4), 1, True),
              ("prob_atlas_post", "prob_atlas_post", (1, 4), 1, False),
              ("joint", "joint", (1, 4), 1, False)],
}
# the sharded eval forwards: (scenario, model, mesh shape, batch, the output
# compared)
SERVE = {"models": [("serve_hyper", "hyper", (2, 2), 2, "y_source"),
                    ("serve_synthmorph", "synthmorph", (1, 4), 1, "y_source")],
         "atlas": [("serve_joint", "joint", (1, 4), 1, "moved_1")]}


def synth_config(pkg):
    """The SynthMorph synthesis config in a package's synthmorph module."""
    return pkg.LabelsToImageConfig(**SYNTH_CFG)


def build(name, generator=None):
    """The port's model of scenario model ``name``."""
    cls_name, fields = MODELS[name]
    if name == "synthmorph":
        fields = dict(fields, cfg=synth_config(synthmorph))
    return getattr(models, cls_name)(**fields, generator=generator)


def terms(name, L, T):
    """The loss terms of model ``name`` in a package: its ``losses`` module
    ``L`` and ``LossTerm`` class ``T``; weights and lambdas use only what
    torch tensors and JAX arrays share."""
    grad = T("reg", L.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=1, name="grad")
    if name == "semi_seg":
        return [T("y_source", L.MSE().loss, target_index=0), grad,
                T("y_seg_source", L.Dice().loss, weight=0.5, target_index=2, name="dice"),
                T("y_seg_target", L.Dice().loss, weight=0.5, target_index=3, name="dice_t")]
    if name == "pointcloud":
        return [T("y_source", L.MSE().loss, weight=0.5, target_index=0),
                T("y_target", L.MSE().loss, weight=0.5, target_index=1),
                T("reg", L.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=2,
                  name="grad"),
                T("subj_dt_value", L.MSE().loss, weight=0.25, target_index=3, name="subj_dt"),
                T("atl_dt_value", L.MSE().loss, weight=0.25, target_index=4, name="atl_dt")]
    if name == "synthmorph":
        dice = L.Dice()
        return [T("pred_map", lambda t, p: dice.loss(t, p) + 1.0, target_output_key="map_2",
                  name="dice"),
                T("pos_flow", L.Grad("l2", loss_mult=1.0).loss, target_output_key="pos_flow",
                  name="grad"),
                T("y_source", L.NCC().loss, weight=0.25, target_output_key="image_2",
                  name="ncc")]
    if name == "hyper":
        # scripts/train_hypermorph.py's: MSE at sigma 0.05 by 1 - lambda,
        # Grad-l2 by lambda
        def image(t, p):
            return ((t - p) ** 2).reshape(p.shape[0], -1).mean(-1) / 0.05 ** 2

        return [T("y_source", image, weight=lambda i, o: 1.0 - i[-1][..., 0], target_index=0),
                T("reg", L.Grad("l2", loss_mult=2).loss, weight=lambda i, o: i[-1][..., 0],
                  target_index=1, name="grad")]
    if name == "template":
        return [T("y_source", L.NCC().loss, weight=0.7, target_index=0),
                T("y_target", L.NCC().loss, weight=0.3, target_output_key="atlas_tensor",
                  name="neg_img"),
                T("mean_stream", L.MSE().loss, weight=1.0, target_index=1, name="mean_stream"),
                T("pos_flow", L.Grad("l2", loss_mult=2).loss, weight=1.0, target_index=2,
                  name="grad")]
    if name == "cond_template":
        return [T("y_source", L.MSE().loss, weight=1.0, target_index=0),
                T("mean_stream", L.MSE().loss, weight=1.0, target_index=1, name="mean_stream"),
                T("pos_flow", L.Grad("l2", loss_mult=2).loss, weight=1.0, target_index=2,
                  name="grad"),
                T("y_target", L.MSE().loss, weight=0.5, target_output_key="atlas_tensor",
                  name="neg_img")]
    if name == "instance":
        return [T("y_source", L.MSE().loss, weight=1.0, target_index=0), grad]
    if name.startswith("prob_atlas"):
        # scripts/train_unsupervised_seg.py's: the negative log-marginal
        # over the image's foreground, Grad-l2 at 10
        def weight(inputs, out):
            m = (inputs[0] > 0) * 1.0
            return -m / m.mean()

        return [T("loss_vol", lambda _, p: p.mean(-1)[..., None], weight=weight,
                  target_index=0, name="nll"),
                T("flow", L.Grad("l2", loss_mult=2).loss, weight=10.0, target_index=1,
                  name="grad")]
    if name == "joint":
        return [T("moved_1", L.MSE().loss, target_index=0),
                T("svf_1", L.Grad("l2").loss, weight=0.01, target_index=1, name="grad")]
    raise KeyError(name)


def lr(name):
    return INSTANCE_LR if name == "instance" else LR


def model(case, name):
    """The port's model ``name`` with the case's (JAX) params and state."""
    net = build(name)
    modelio.load_weights(net, case["params"][name], case["state"].get(name))
    return net


def mesh(shape):
    """The mesh of ``shape`` over a world of several ranks; None (the
    Trainer's default, one rank) in one process."""
    return mesh_lib.make_mesh(shape) if mesh_lib.world()[1] > 1 else None


def state(net):
    return {k: v.detach().cpu().numpy().copy() for k, v in net.state_dict().items()}


class _Draws:
    """SynthMorphDense's draws replayed from the case (JAX's keys): step
    ``i`` of a run takes ``draws[i]``, the global batch's, of which each
    rank keeps its rows (``draw_rows``)."""

    def __init__(self, draws):
        self.draws, self.step = draws, 0
        self.original = models.SynthMorphDense.draw

    def __enter__(self):
        def draw(net, generator, batch, device):
            d = self.draws[self.step]
            return {"share": None,
                    "src": mesh_lib.draw_rows(lambda n: d["src"][:n], batch),
                    "trg": mesh_lib.draw_rows(lambda n: d["trg"][:n], batch)}

        models.SynthMorphDense.draw = draw
        return self

    def __exit__(self, *exc):
        models.SynthMorphDense.draw = self.original


def train(case, scenario, name, mesh_shape, batch, conv):
    """STEPS steps of model ``name`` on the first ``batch`` rows of its
    case: the losses, the params and buffers after them, every parameter's
    reduced gradient of the first step (from the case's params), the
    moved image of an eval forward after the steps (gathered) and, in
    conv-kernel mode, the conv's layout copies."""
    net = model(case, name)
    grid = mesh(mesh_shape)
    trainer = Trainer(net, terms(name, losses, LossTerm), lr=lr(name), device="cpu", mesh=grid)
    inputs, targets = (tuple(a[:batch] for a in part) for part in case["batch"][name])
    conv3.set_pallas_conv(conv)
    conv3.conv3_same_cf.layout_copies = 0
    replay = _Draws(case["draws"]) if name == "synthmorph" else None
    try:
        losses_, grads = [], None
        for step in range(STEPS):
            if replay is not None:
                replay.step = step
                with replay:
                    losses_.append(float(trainer.train_step(inputs, targets)["loss"]))
            else:
                losses_.append(float(trainer.train_step(inputs, targets)["loss"]))
            if grads is None:
                grads = {n: p.grad.detach().numpy().copy() for n, p in net.named_parameters()}
        moved = serve_forward(net, name, grid, inputs, case, "y_source" if name != "joint"
                              else "moved_1")
    finally:
        conv3.set_pallas_conv(None)
    return dict(losses=losses_, params=state(net), grads=grads, moved=moved,
                mesh=dict(trainer.mesh.shape), layout_copies=conv3.conv3_same_cf.layout_copies)


def serve_forward(net, name, grid, inputs, case, key):
    """The eval-mode forward of ``net`` on ``inputs`` (this rank's parts,
    ``shard_inputs``, inside ``spatial``), output ``key`` gathered whole;
    SynthMorphDense on the case's eval draws (JAX's PRNGKey(0))."""
    net.eval()
    extra = {"draws": case["eval_draws"]} if name == "synthmorph" else {}
    if grid is None:
        with torch.no_grad():
            return net(*map(torch.from_numpy, inputs), **extra)[key].numpy()
    parts = mesh_lib.shard_inputs(grid, net, inputs, device="cpu")
    if extra:
        rows = mesh_lib.batch_sharding(grid, 1).rows(len(inputs[0]))
        extra = {"draws": {k: v if v is None else v[rows] for k, v in extra["draws"].items()}}
    with mesh_lib.spatial(grid), torch.no_grad():
        out = net(*parts, **extra)[key]
    return mesh_lib.gather_batch(grid, out).numpy()


def serve(case, name, mesh_shape, batch, key):
    """The eval forward of model ``name`` with the case's params on the
    first ``batch`` rows of its case, and the slab length of its first
    input where it takes slabs."""
    net = model(case, name)
    inputs = tuple(a[:batch] for a in case["batch"][name][0])
    grid = mesh(mesh_shape)
    out = serve_forward(net, name, grid, inputs, case, key)
    slab = None
    if grid is not None and net.slab_inputs:
        slab = int(mesh_lib.shard_inputs(grid, net, inputs, device="cpu")[0].shape[1])
    return dict(out=out, slab=slab)


def run(case, group):
    """Every scenario of ``group``, in one order on every rank."""
    out = {scenario: train(case, scenario, name, shape, batch, conv)
           for scenario, name, shape, batch, conv in GROUPS[group]}
    out.update({scenario: serve(case, name, shape, batch, key)
                for scenario, name, shape, batch, key in SERVE[group]})
    return out


def main(group, rank, world, store, tmp):
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed("file://" + store, world, rank, "cpu")
    with open(os.path.join(tmp, "case.pkl"), "rb") as f:
        case = pickle.load(f)
    out = run(case, group)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
