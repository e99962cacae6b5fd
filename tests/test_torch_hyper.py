"""HyperMorph in the PyTorch port against the JAX package on the CPU:
``HyperConv`` in 1-3 dimensions, the hyper U-Net with its ``resfix``,
``HyperVxmDense``'s forward, one train step of ``train_hypermorph``'s
recipe, checkpoints and Adam's state in both directions, the committed
full-width checkpoint, the registration API with ``hyper`` and
``fit_cached_pairs``'s ``extra_stream``.

Inputs come from numpy seeds; JAX params are carried across with
``params_from_jax``. Networks are 16^3 with narrow features and the flow
head redrawn N(0, 0.3) (flows of voxels; its own N(0, 1e-5) init gives
flows no comparison could see), and the hypernetwork's generator weights
redrawn N(0, 0.05) where the test needs the per-sample kernels to differ
(their N(0, 1e-3) init leaves every sample nearly the base kernel).
Tolerances, each relative to the largest magnitude of the compared
tensor (measured on the CPU in brackets): 1e-5 on float32 forwards
(2.6e-6), 1e-4 on one step's loss and gradients (1.4e-6; as
``tests/test_torch_train.py``), 2e-3 on the change of the params over
Adam steps (3.0e-4; as ``tests/test_torch_resume.py``), and for bfloat16
``HyperConv`` 7.8e-3, one bfloat16 step of the largest magnitude (0: both
round the generated kernel, the conv output and the bias add to
bfloat16, and may accumulate the conv in other orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_rel_close, flatten, unflatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import registration as jax_registration
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import HyperVxmDense as JaxHyper
from voxelmorph_tpu.models import HyperVxmJoint as JaxJoint
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models.unet import HyperConv as JaxHyperConv
from voxelmorph_tpu.models.unet import Unet as JaxUnet
from voxelmorph_tpu_torch import registration
from voxelmorph_tpu_torch.cli.train_hypermorph import hypermorph_terms
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.hyper import HyperVxmDense
from voxelmorph_tpu_torch.models.synthmorph import HyperVxmJoint
from voxelmorph_tpu_torch.models.unet import HyperConv, Unet
from voxelmorph_tpu_torch.ops.interp import resize
from voxelmorph_tpu_torch.training import Trainer

SHAPE = (16, 16, 16)
# three squarings: as many tiers as seven at this size, and a shorter JAX
# compile
CFG = dict(inshape=SHAPE, nb_unet_features=[[4, 8], [8, 4]], nb_hyp_units=8, nb_hyp_layers=2,
           int_steps=3)
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-3
BF16_RTOL = 7.8e-3
MIN_FLOW = 0.5  # voxels
LR = 1e-3
CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "artifacts_r5",
                          "hyper_r5_0100_model.npz")


def _blobs(seed, batch, shape=SHAPE):
    """``batch`` pairs of smooth blobs with a little noise, ``(B, *S, 1)``."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                             indexing="ij"), -1)
    out = []
    for _ in range(2):
        vols = []
        for _ in range(batch):
            c = np.asarray(shape) / 2 + rng.uniform(-2.5, 2.5, size=len(shape))
            blob = np.exp(-((g - c) ** 2).sum(-1) / 18)
            vols.append(0.9 * blob + 0.1 * rng.uniform(size=shape))
        out.append(np.stack(vols)[..., None].astype(np.float32))
    return out


def _redraw(params, gen_std=None):
    """JAX params (numpy) with the flow head N(0, 0.3) and, with
    ``gen_std``, every generator weight N(0, gen_std)."""
    rng = np.random.default_rng(3)
    flat = flatten(params)
    for key, val in sorted(flat.items()):
        if key.endswith("flow||kernel"):
            flat[key] = rng.normal(0.0, 0.3, val.shape).astype(np.float32)
        elif gen_std is not None and key.endswith(("_gen||kernel",)):
            flat[key] = rng.normal(0.0, gen_std, val.shape).astype(np.float32)
    return unflatten(flat)


def _jax_model(cfg, batch=3, seed=0, gen_std=0.05):
    """The JAX module of ``cfg`` and its params: the port's seeded init
    written out as JAX params (the layout JAX's own init gives, checked by
    the strict loads below), then redrawn. Skipping JAX's init saves its
    compile."""
    model = HyperVxmDense(**cfg, generator=torch.Generator().manual_seed(seed))
    return JaxHyper(**cfg), _redraw(modelio.params_to_jax(dict(model.named_parameters())),
                                    gen_std)


def _torch_model(cfg, params):
    model = HyperVxmDense(**cfg)
    model.load_state_dict(modelio.params_from_jax(flatten(params)))
    return model


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hyperconv_matches_jax(ndims, dtype):
    """Two samples with different embeddings, each convolved with its own
    generated kernel, as JAX's vmap of per-sample convs."""
    spatial, ci, co, units = (12, 10, 8)[:ndims], 3, 5, 6
    rng = np.random.default_rng(ndims)
    x = rng.normal(size=(2, *spatial, ci)).astype(np.float32)
    hyp = rng.normal(size=(2, units)).astype(np.float32)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxHyperConv(co, (3,) * ndims, dtype=jdtype)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x, hyp)["params"])
    params["kernel_gen"]["kernel"] = rng.normal(0.0, 0.05, params["kernel_gen"]["kernel"].shape
                                                ).astype(np.float32)
    params["bias_gen"]["kernel"] = rng.normal(0.0, 0.05, params["bias_gen"]["kernel"].shape
                                              ).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, x, hyp).astype(jnp.float32))

    conv = HyperConv(ci, co, ndims, units, dtype=tdtype)
    conv.load_state_dict(modelio.params_from_jax(flatten(params)))
    out = conv(torch.from_numpy(x).movedim(-1, 1), torch.from_numpy(hyp))
    assert out.dtype == tdtype
    out = out.float().movedim(1, -1).detach().numpy()
    assert_rel_close(out, ref, OUT_RTOL if dtype == "float32" else BF16_RTOL, dtype)
    # each sample has its own kernel: the second sample through the first's
    # embedding differs
    swapped = conv(torch.from_numpy(x).movedim(-1, 1), torch.from_numpy(hyp[[0, 0]]))
    swapped = swapped.float().movedim(1, -1).detach().numpy()
    assert np.abs(swapped[1] - ref[1]).max() > 0.05 * np.abs(ref[1]).max()


def test_hyperconv_init_statistics():
    """kernel_gen's bias (the base kernel) is flax's truncated normal times
    the he std, not rescaled: std 0.8796 sqrt(2 / fan_in), bounded by two he
    stds; the generator weights N(0, 1e-3); bias_gen's bias zero. The same
    statistics as the JAX module's own init, within 3% (27648 draws)."""
    ci, co, units = 32, 32, 128
    conv = HyperConv(ci, co, 3, units, generator=torch.Generator().manual_seed(0))
    he_std = np.sqrt(2.0 / (27 * ci))
    base = conv.kernel_gen.bias.detach().numpy()
    params = jax.device_get(JaxHyperConv(co, (3, 3, 3)).init(
        jax.random.PRNGKey(0), np.zeros((1, 4, 4, 4, ci), np.float32),
        np.zeros((1, units), np.float32))["params"])
    ref_base = params["kernel_gen"]["bias"]
    assert base.shape == ref_base.shape == (27 * ci * co,)
    for values in (base, ref_base):
        assert np.std(values) == pytest.approx(0.87962566 * he_std, rel=0.03)
        assert np.abs(values).max() <= 2 * he_std
    for name in ("kernel_gen", "bias_gen"):
        weight = getattr(conv, name).weight.detach().numpy()
        assert np.std(weight) == pytest.approx(1e-3, rel=0.03)
        assert np.std(params[name]["kernel"]) == pytest.approx(1e-3, rel=0.03)
    assert not conv.bias_gen.bias.detach().numpy().any()


def test_hyper_unet_with_resfix_matches_jax():
    """Unet(hyper=True, do_res=True): the four blocks whose width differs
    from their input's have a hyper resfix."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, *SHAPE, 2)).astype(np.float32)
    hyp = rng.normal(size=(2, 6)).astype(np.float32)
    feats = [[4, 8], [8, 4, 6]]
    jm = JaxUnet(ndims=3, nb_features=feats, hyper=True, do_res=True)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x, hyp)["params"])
    params = _redraw(params, gen_std=0.05)
    ref = np.asarray(jm.apply({"params": params}, x, hyp))

    unet = Unet(3, 2, nb_features=feats, do_res=True, hyper=True, nb_hyp_units=6)
    state = modelio.params_from_jax(flatten(params))
    assert sum(k.endswith(".resfix.kernel_gen.weight") for k in state) == 4
    unet.load_state_dict(state)
    out = unet(torch.from_numpy(x).movedim(-1, 1), torch.from_numpy(hyp))
    assert_rel_close(out.movedim(1, -1).detach().numpy(), ref, OUT_RTOL, "unet")


@pytest.mark.parametrize("extra", [dict(svf_resolution=1), dict(svf_resolution=2),
                                   dict(bidir=True), dict(use_probs=True)])
def test_forward_matches_jax(extra):
    """Every output key, hyper_val included, at lambda 0, 0.3 and 1 in one
    batch (eval mode: use_probs gives its mean)."""
    cfg = dict(CFG, **extra)
    jm, params = _jax_model(cfg)
    src, trg = _blobs(1, 3)
    hyp = np.array([[0.0], [0.3], [1.0]], np.float32)
    ref = jax.jit(lambda p: jm.apply({"params": p}, src, trg, hyp, train=False))(params)
    model = _torch_model(cfg, params).eval()
    out = model(torch.from_numpy(src), torch.from_numpy(trg), torch.from_numpy(hyp))
    assert sorted(out) == sorted(ref)
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ref:
        assert_rel_close(out[key].detach().numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    # lambda changes the flow
    flows = np.asarray(ref["pos_flow"])
    assert np.abs(flows[0] - flows[2]).max() > 0.05 * np.abs(flows).max()


def _jax_terms():
    """scripts/train_hypermorph.py's loss terms (MSE at sigma 0.05)."""
    scaling = 1.0 / 0.05 ** 2

    def image(yt, yp):
        return scaling * jnp.mean(jnp.square(yt - yp).reshape(yp.shape[0], -1), axis=-1)

    def hyp_of(inputs):
        return jnp.squeeze(inputs[-1], axis=-1)

    return [jax_training.LossTerm("y_source", image, weight=lambda i, o: 1.0 - hyp_of(i),
                                  target_index=0),
            jax_training.LossTerm("reg", jax_losses.Grad("l2", loss_mult=2).loss,
                                  weight=lambda i, o: hyp_of(i), target_index=1, name="grad")]


def _batch(batch=2, seed=1):
    src, trg = _blobs(seed, batch)
    hyp = np.array([[0.2], [0.7]], np.float32)[:batch]
    return (src, trg, hyp), (trg, np.zeros((batch, *SHAPE, 3), np.float32))


def test_train_step_matches_jax():
    """One step of train_hypermorph's recipe at B = 2 (lambda 0.2 and 0.7):
    the loss and every parameter gradient against JAX's value_and_grad."""
    cfg = dict(CFG, svf_resolution=2)
    jm, params = _jax_model(cfg)
    inputs, targets = _batch()
    loss_fn = jax_training.make_loss_fn(jm, _jax_terms())
    (ref_loss, (ref_metrics, _)), ref_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, {}, inputs, targets,
                                                    jax.random.PRNGKey(0))
    model = _torch_model(cfg, params)
    trainer = Trainer(model, hypermorph_terms("mse", 0.05, 2), lr=LR, device="cpu")
    model.train()
    loss, metrics = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                                    tuple(map(torch.from_numpy, targets)))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    for name in ("y_source", "grad"):
        assert metrics[name].item() == pytest.approx(float(ref_metrics[name]), rel=GRAD_RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_grads = flatten(ref_grads)
    assert sorted(grads) == sorted(ref_grads)
    assert any(k.startswith("hyp_dense_1") for k in grads)
    for name in ref_grads:
        assert_rel_close(grads[name], ref_grads[name], GRAD_RTOL, name)


def _jax_trainer(cfg, params=None, step_fn=None):
    """A JAX Trainer of ``cfg`` from ``params``; ``step_fn`` (another
    trainer's compiled step, the same model and terms) saves a compile."""
    jt = jax_training.Trainer(JaxHyper(**cfg), _jax_terms(), lr=LR)
    if step_fn is not None:
        jt.step_fn = step_fn
    if params is not None:
        jt.init(None, params=jax.tree_util.tree_map(jnp.asarray, params))
    return jt


def _steps(trainer, n):
    for _ in range(n):
        trainer.train_step(*_batch())
    return trainer


def test_checkpoints_load_in_both_packages(tmp_path):
    """A JAX checkpoint loads strictly in the port and gives its outputs; a
    port checkpoint gives JAX's load_model the port's outputs."""
    cfg = dict(CFG, svf_resolution=2)
    jm, params = _jax_model(cfg, batch=2)
    inputs, _ = _batch()

    jax_save_model(str(tmp_path / "jax.npz"), jm, params)
    ours = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(ours, HyperVxmDense) and ours.config["nb_hyp_units"] == 8
    out = ours(*map(torch.from_numpy, inputs))
    ref = jm.apply({"params": params}, *inputs, train=False)
    assert_rel_close(out["pos_flow"].detach().numpy(), np.asarray(ref["pos_flow"]), OUT_RTOL,
                     "jax -> port")

    modelio.save_model(str(tmp_path / "port.npz"), ours)
    back_model, back_params = jax_load_model(str(tmp_path / "port.npz"))
    back = back_model.apply({"params": back_params}, *inputs, train=False)
    assert_rel_close(np.asarray(back["pos_flow"]), out["pos_flow"].detach().numpy(), OUT_RTOL,
                     "port -> jax")
    assert sorted(flatten(back_params)) == sorted(flatten(params))


def test_adam_resumes_across_packages(tmp_path):
    """Two steps in one package, a checkpoint, one step in the other give
    the params of three steps, both ways (Adam's state carried as optax's
    leaves, in optax's order for the hypernetwork's keys)."""
    cfg = dict(CFG, svf_resolution=2)
    _, params = _jax_model(cfg, batch=2)
    # JAX two steps -> the port's third
    jt = _steps(_jax_trainer(cfg, params), 2)
    jt.save(str(tmp_path / "0002.npz"))
    whole = flatten(jax.device_get(_steps(jt, 1).params))
    resumed = Trainer(HyperVxmDense(**cfg), hypermorph_terms(), lr=LR, device="cpu")
    resumed.load(str(tmp_path / "0002.npz"))
    assert resumed.global_step == 2
    _steps(resumed, 1)
    start = flatten(params)
    got = modelio.params_to_jax(resumed.model.state_dict())
    for name in whole:
        assert_rel_close(got[name] - start[name], whole[name] - start[name], ADAM_RTOL, name)

    # the port two steps -> JAX's third
    first = Trainer(_torch_model(cfg, params), hypermorph_terms(), lr=LR, device="cpu")
    _steps(first, 2).save(str(tmp_path / "port_0002.npz"))
    whole = modelio.params_to_jax(_steps(first, 1).model.state_dict())
    jt = _jax_trainer(cfg, step_fn=jt.step_fn)
    jt.load(str(tmp_path / "port_0002.npz"))
    assert jt.global_step == 2 and int(jt.opt_state[0].count) == 2
    got = flatten(jax.device_get(_steps(jt, 1).params))
    for name in whole:
        assert_rel_close(got[name] - start[name], whole[name] - start[name], ADAM_RTOL, name)
    # the leaves the port writes are optax's for these params
    _, _, _, extra = modelio.read_checkpoint(str(tmp_path / "port_0002.npz"), with_extra=True)
    leaves = [extra[k] for k in sorted(k for k in extra if k.startswith("opt||"))]
    ref_leaves = jax.tree_util.tree_leaves(optax.adam(LR).init(params))
    assert [a.shape for a in leaves] == [np.shape(b) for b in ref_leaves]


def _smooth_pair(shape, seed=0):
    """Low-frequency noise and a copy of it shifted by a voxel, in [0, 1]."""
    coarse = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (6, 8, 10, 1), dtype=np.float32))
    img = resize(coarse, [s / c for s, c in zip(shape, (6, 8, 10))], new_shape=shape)
    img = ((img - img.min()) / (img.max() - img.min())).numpy()
    return img[None], np.roll(img, (1, -1, 1), axis=(0, 1, 2))[None]


def test_committed_checkpoint_matches_jax():
    """artifacts_r5/hyper_r5_0100_model.npz (default features, svf_resolution
    2, float32, trained at 80x96x112) loads strictly, re-targeted to
    48x64x80, and its forward at lambda 0.25 matches JAX's."""
    shape = (48, 64, 80)
    jm, jparams = jax_load_model(CHECKPOINT)
    jm, jparams = jax_registration.resolve_registration_model(jm, jparams, inshape=shape)
    model = registration.resolve_registration_model(
        modelio.load_model(CHECKPOINT, device="cpu"), inshape=shape)
    assert isinstance(model, HyperVxmDense) and model.inshape == shape
    assert sum(p.numel() for p in model.parameters()) > 40_000_000
    moving, fixed = _smooth_pair(shape)
    hyp = np.full((1, 1), 0.25, np.float32)
    ref = jax.jit(lambda p: jm.apply({"params": p}, moving, fixed, hyp, train=False))(jparams)
    with torch.no_grad():
        out = model(torch.from_numpy(moving), torch.from_numpy(fixed), torch.from_numpy(hyp))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("svf", "pos_flow", "y_source"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)


def test_registration_api_with_hyper():
    """build_register_fn and build_eval_register_fn bake ``hyper`` into a
    HyperVxmDense's input as JAX's do; resolve_registration_model
    re-targets one; enable_fast_warp passes it through; build_eval_register_fn
    serves a small HyperVxmJoint (``hyp`` filled with ``hyper``) as JAX's
    does, its warp and image within 1e-4 (they follow the detector's
    least-squares fit; see tests/test_torch_joint.py) and its segmentation
    equal."""
    cfg = dict(CFG, svf_resolution=2)
    jm, params = _jax_model(cfg, batch=1)
    model = _torch_model(cfg, params).eval()
    (src, trg, _), _ = _batch(batch=1)
    seg = (src > 0.5).astype(np.float32)
    moved, warp = registration.build_register_fn(model, hyper=0.3)(
        torch.from_numpy(src), torch.from_numpy(trg))
    ref_moved, ref_warp = jax_registration.build_register_fn(jm, hyper=0.3)(params, src, trg)
    assert np.abs(np.asarray(ref_warp)).max() >= MIN_FLOW
    assert_rel_close(warp.numpy(), np.asarray(ref_warp), OUT_RTOL, "warp")
    assert_rel_close(moved.numpy(), np.asarray(ref_moved), OUT_RTOL, "moved")
    other = registration.build_register_fn(model, hyper=0.9)(torch.from_numpy(src),
                                                             torch.from_numpy(trg))[1]
    assert (other - warp).abs().max().item() > 1e-2
    _, warp_e, seg_e = registration.build_eval_register_fn(model, hyper=0.3)(
        *map(torch.from_numpy, (src, trg, seg)))
    _, ref_warp_e, ref_seg = jax_registration.build_eval_register_fn(jm, hyper=0.3)(
        params, src, trg, seg)
    assert torch.equal(warp_e, warp)
    np.testing.assert_array_equal(seg_e.numpy(), np.asarray(ref_seg))

    retargeted = registration.resolve_registration_model(model, inshape=(12, 16, 16))
    assert type(retargeted) is HyperVxmDense and retargeted.inshape == (12, 16, 16)
    for a, b in zip(retargeted.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert registration.enable_fast_warp(model) is model

    cfg = dict(in_shape=SHAPE, int_steps=3, hyp_units=(4,), enc_nf=(4, 8), dec_nf=(8, 4),
               add_nf=(4,), aff_num_feat=8, aff_enc_nf=(8,))
    joint = HyperVxmJoint(**cfg, generator=torch.Generator().manual_seed(0)).eval()
    joint_params = unflatten(modelio.params_to_jax(dict(joint.named_parameters())))
    moved_j, warp_j, seg_j = registration.build_eval_register_fn(joint, hyper=0.3)(
        *map(torch.from_numpy, (src, trg, seg)))
    ref_moved, ref_warp, ref_seg = jax_registration.build_eval_register_fn(
        JaxJoint(**cfg), hyper=0.3)(joint_params, src, trg, seg)
    assert_rel_close(warp_j.numpy(), np.asarray(ref_warp), 1e-4, "joint warp")
    assert_rel_close(moved_j.numpy(), np.asarray(ref_moved), 1e-4, "joint moved")
    np.testing.assert_array_equal(seg_j.numpy(), np.asarray(ref_seg))


def test_fit_cached_pairs_extra_stream_dispatch_equals_single_steps():
    """K = 2 dispatches with the lambda stream as ``extra_stream`` give the
    params of single steps on the same picks and lambdas, bit for bit; the
    stream's draws reach the model as its last input."""
    from voxelmorph_tpu_torch.cli.train_hypermorph import hyp_stream

    cfg = dict(CFG, svf_resolution=2)
    _, params = _jax_model(cfg, batch=2)
    src, trg = _blobs(5, 2)
    data = np.concatenate([src, trg])
    seen = {}
    runs = {}
    for k in (1, 2):
        model = _torch_model(cfg, params)
        trainer = Trainer(model, hypermorph_terms(), lr=LR, device="cpu")
        step = trainer.train_step
        seen[k] = []

        def record(inputs, targets, step=step, log=seen[k]):
            log.append(np.asarray(inputs[-1]))
            return step(inputs, targets)

        trainer.train_step = record
        trainer.fit_cached_pairs(data, epochs=2, steps_per_epoch=2, steps_per_dispatch=k,
                                 batch_size=2, start_step=5,
                                 extra_stream=hyp_stream(2, 0.2, 5), log_fn=lambda _: None)
        runs[k] = model.state_dict()
    expected = [d for d, _ in zip(hyp_stream(2, 0.2, 5), range(4))]
    for k in (1, 2):
        assert len(seen[k]) == 4
        for got, (want,) in zip(seen[k], expected):
            assert got.shape == (2, 1)
            np.testing.assert_array_equal(got, want)
    for name, p in runs[1].items():
        assert torch.equal(runs[2][name], p), name
