"""The spatial-sharding scenarios of ``tests/test_torch_spatial.py``.

Each scenario takes the case (made with numpy in the test process) and
returns numpy results. The test runs every scenario in one process (a world
of one rank, unsharded) and in each rank of a gloo world of four, started as

    python tests/torch_spatial_ranks.py RANK WORLD STORE DIR

which joins the world through the ``file://`` store ``STORE``, reads the
case from ``DIR/case.pkl`` and writes its results to ``DIR/rank{RANK}.pkl``.
On four ranks each scenario runs on its mesh: (1, 4) shards the first
spatial dim, 24 planes in units of 4 (the U-Net's two pools), as 8/8/4/4;
(2, 2) holds a row of the batch on each pair of ranks, in slabs of 12.
The module imports torch, numpy and the port only.
"""

import os
import pickle
import sys

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from voxelmorph_tpu_torch import losses  # noqa: E402
from voxelmorph_tpu_torch.models import modelio  # noqa: E402
from voxelmorph_tpu_torch.models import vxm as vxm_module  # noqa: E402
from voxelmorph_tpu_torch.models.vxm import VxmDense  # noqa: E402
from voxelmorph_tpu_torch.ops import conv3  # noqa: E402
from voxelmorph_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from voxelmorph_tpu_torch.registration import build_register_fn  # noqa: E402
from voxelmorph_tpu_torch.training import LossTerm, Trainer  # noqa: E402

SHAPE = (24, 8, 8)
SHAPE_2D = (24, 8)
FEATS = [[4, 4], [4, 4, 4]]
LR = 1e-3
STEPS = 2
# the models by name: their configs (JAX's VxmDense fields)
CONFIGS = {
    "mse": dict(inshape=SHAPE, int_steps=1, int_resolution=2),
    "probs": dict(inshape=SHAPE, int_steps=1, int_resolution=2, use_probs=True, bidir=True),
    "2d": dict(inshape=SHAPE_2D, int_steps=1, int_resolution=2),
}


def mse_terms():
    """MSE, and Grad-l2 at 0.01 (tests/test_sharding.py's terms)."""
    return [LossTerm("y_source", losses.MSE().loss, weight=1.0, target_index=0),
            LossTerm("reg", losses.Grad("l2").loss, weight=0.01, target_index=1, name="grad")]


def probs_terms():
    """scripts/train.py's --image-loss ncc --bidir --use-probs: NCC on both
    warped images at 0.5, KL (prior lambda 10) at 0.01."""
    return [LossTerm("y_source", losses.NCC().loss, weight=0.5, target_index=0),
            LossTerm("y_target", losses.NCC().loss, weight=0.5, target_index=1),
            LossTerm("reg", losses.KL(10.0, SHAPE).loss, weight=0.01, target_index=2,
                     name="kl")]


def model(case, name, dtype=torch.float32):
    """The VxmDense ``name`` with the case's (JAX) params."""
    net = VxmDense(nb_unet_features=FEATS, dtype=dtype, **CONFIGS[name])
    net.load_state_dict(modelio.params_from_jax(case["params"][name]))
    return net


def mesh(shape):
    """The mesh of ``shape`` over a world of several ranks; None (the
    Trainer's default, one rank) in one process."""
    return mesh_lib.make_mesh(shape) if mesh_lib.world()[1] > 1 else None


def state(net):
    return {k: v.detach().cpu().numpy().copy() for k, v in net.state_dict().items()}


def train(case, name, terms, mesh_shape, batch, steps=STEPS, dtype=torch.float32):
    """``steps`` steps of the model ``name`` on the first ``batch`` pairs of
    its case; the losses, params and gradients of the last step."""
    net = model(case, name, dtype)
    trainer = Trainer(net, terms, lr=LR, device="cpu", mesh=mesh(mesh_shape))
    inputs, targets = case["batch"][name]
    inputs = tuple(a[:batch] for a in inputs)
    targets = tuple(a[:batch] for a in targets)
    losses_ = [float(trainer.train_step(inputs, targets)["loss"]) for _ in range(steps)]
    return dict(losses=losses_, params=state(net), mesh=dict(trainer.mesh.shape),
                grads={n: p.grad.detach().numpy().copy() for n, p in net.named_parameters()})


def mse(case):
    """MSE + Grad on (1, 4) at batch 1."""
    return train(case, "mse", mse_terms(), (1, 4), 1)


def probs(case):
    """NCC + KL + bidir on (2, 2) at batch 2, with the case's noise: each
    rank draws it at the global batch's shape and keeps its rows."""
    eps = torch.from_numpy(case["eps"])
    sample = vxm_module.sample_normal
    vxm_module.sample_normal = lambda shape, generator, device: mesh_lib.draw_rows(
        lambda batch: eps[:batch], shape[0])
    try:
        return train(case, "probs", probs_terms(), (2, 2), 2)
    finally:
        vxm_module.sample_normal = sample


def probs_generator(case):
    """The same recipe with the Trainer's own generator, in step on every
    rank."""
    return train(case, "probs", probs_terms(), (2, 2), 2)


def conv_kernel(case):
    """MSE + Grad on (1, 4) in conv-kernel mode (the plain conv on the CPU),
    with the conv's launches and layout copies."""
    conv3.set_pallas_conv(True)
    conv3.conv3_same_cf.layout_copies = 0
    try:
        out = train(case, "mse", mse_terms(), (1, 4), 1)
    finally:
        conv3.set_pallas_conv(None)
    out["layout_copies"] = conv3.conv3_same_cf.layout_copies
    return out


def bfloat16(case):
    """One MSE + Grad step of a bfloat16 model on (1, 4)."""
    return train(case, "mse", mse_terms(), (1, 4), 1, steps=1, dtype=torch.bfloat16)


def cached_pairs(case):
    """Trainer.fit_cached_pairs on (1, 4): one 2-step dispatch at batch 1."""
    net = model(case, "mse")
    trainer = Trainer(net, mse_terms(), lr=LR, device="cpu", mesh=mesh((1, 4)))
    metrics = trainer.fit_cached_pairs(case["stack"], epochs=1, steps_per_epoch=2,
                                       batch_size=1, log_fn=lambda msg: None)
    return dict(params=state(net), metrics=metrics)


def serve(case, name, mesh_shape, batch):
    """The eval-mode forward on this rank's slabs (``shard_batch(spatial=
    True)``), its outputs gathered: y_source, pos_flow, each row's sum of
    y_source (an array of one dim) and unet_out (a slab), and the inputs
    put back by ``gather_batch``."""
    net = model(case, name).eval()
    grid = mesh(mesh_shape)
    src, trg = (a[:batch] for a in case["serve"][name])
    if grid is None:
        with torch.no_grad():
            out = net(torch.from_numpy(src), torch.from_numpy(trg))
        return dict(y_source=out["y_source"].numpy(), pos_flow=out["pos_flow"].numpy(),
                    unet_out=out["unet_out"].numpy(), inputs=src, slab=src.shape[1],
                    row_sums=out["y_source"].flatten(1).sum(1).numpy())
    src_s, trg_s = mesh_lib.shard_batch(grid, (src, trg), spatial=True, device="cpu",
                                        align=net.slab_align)
    with mesh_lib.spatial(grid), torch.no_grad():
        out = net(src_s, trg_s)
        moved, warp = build_register_fn(net)(src_s, trg_s)
    whole = mesh_lib.gather_batch(grid, dict(y_source=out["y_source"],
                                             pos_flow=out["pos_flow"],
                                             row_sums=out["y_source"].flatten(1).sum(1)))
    parts = mesh_lib.gather_batch(grid, dict(unet_out=out["unet_out"], inputs=src_s),
                                  spatial=True)
    registered = mesh_lib.gather_batch(grid, (moved, warp))
    return dict({k: v.numpy() for k, v in {**whole, **parts}.items()}, slab=src_s.shape[1],
                register_equal=bool(torch.equal(registered[0], whole["y_source"])
                                    and torch.equal(registered[1], whole["pos_flow"])))


def run(case, tmp):
    """Every scenario, in one order on every rank."""
    return {"mse": mse(case), "probs": probs(case), "probs_generator": probs_generator(case),
            "conv_kernel": conv_kernel(case), "bfloat16": bfloat16(case),
            "cached_pairs": cached_pairs(case),
            "serve_3d": serve(case, "mse", (2, 2), 2), "serve_2d": serve(case, "2d", (1, 4), 1)}


def main(rank, world, store, tmp):
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed("file://" + store, world, rank, "cpu")
    with open(os.path.join(tmp, "case.pkl"), "rb") as f:
        case = pickle.load(f)
    out = run(case, tmp)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
