"""The port's atlas models against the JAX package on the CPU: MeanStream,
TemplateCreation, ConditionalTemplateCreation and ProbAtlasSegmentation,
their forwards, TemplateCreation's train step with the stream state and its
checkpoints across the packages.

At 16^3 with narrow features the JAX params are carried across with
``params_from_jax`` after the flow head's kernel is redrawn as N(0, 0.3),
for flows of voxels (max|flow| >= 0.5 is asserted), and the atlas is set to
a smooth image, so that its gradient is not that of a constant. Tolerances,
each relative to the largest magnitude of the compared tensor, as in
``tests/test_torch_semisupervised.py``: 1e-5 on the forward's outputs, 1e-4
on one step's loss and gradients, 2e-3 on the change of the params over 3
Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import ConditionalTemplateCreation as JaxCond
from voxelmorph_tpu.models import MeanStream as JaxMeanStream
from voxelmorph_tpu.models import ProbAtlasSegmentation as JaxProb
from voxelmorph_tpu.models import TemplateCreation as JaxTemplate
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu_torch import losses
from voxelmorph_tpu_torch.models import modelio
from voxelmorph_tpu_torch.models.atlas import (ConditionalTemplateCreation, MeanStream,
                                               ProbAtlasSegmentation, TemplateCreation,
                                               stream_step)
from voxelmorph_tpu_torch.training import LossTerm, Trainer

SHAPE = (16, 16, 16)
FEATS = [[4, 8], [8, 4]]
CFG = dict(inshape=SHAPE, nb_unet_features=FEATS, int_steps=7, int_resolution=2)
LR = 1e-3
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-3
MIN_FLOW = 0.5  # voxels


def _smooth(seed, channels=1):
    """A smooth image in [0, 1]: a blob and a random field blurred."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in SHAPE],
                             indexing="ij"), -1)
    c = 8 + rng.uniform(-2.5, 2.5, size=3)
    blob = np.exp(-((g - c) ** 2).sum(-1) / 18)
    noise = rng.uniform(size=(*SHAPE, channels))
    return (0.7 * blob[..., None] + 0.3 * noise).astype(np.float32)[None]


def _redraw_flow(params, seed=3):
    """params with the VxmDense flow head's kernel drawn N(0, 0.3)."""
    params = dict(params)
    vxm = dict(params["vxm"])
    vxm["flow"] = dict(vxm["flow"], kernel=np.random.default_rng(seed).normal(
        0.0, 0.3, vxm["flow"]["kernel"].shape).astype(np.float32))
    params["vxm"] = vxm
    return params


def _load(model, params, state=None):
    modelio.load_weights(model, flatten(params), state and flatten(state))
    return model


# ---------------------------------------------------------------- MeanStream

def test_mean_stream_updates_as_jax():
    """tests/test_variant_models.py::test_mean_stream_updates, step by step
    against the JAX module, with the gradient into the input."""
    ms = JaxMeanStream(cap=10)
    x1 = np.random.default_rng(0).normal(size=(2, 4, 4, 2)).astype(np.float32) + 1.0
    x2 = np.random.default_rng(1).normal(size=(2, 4, 4, 2)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(2, 4, 4, 2)).astype(np.float32)
    variables = ms.init(jax.random.PRNGKey(0), jnp.asarray(x1))
    ours = MeanStream((4, 4, 2), cap=10).train()
    for x in (x1, x2, x1, x2, x1, x2):  # the count reaches the cap at the fifth
        prev = variables
        ref, variables = ms.apply(prev, jnp.asarray(x), mutable=["stream"])
        ref_grad = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * ms.apply(
            prev, a, mutable=["stream"])[0]))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = ours(xt)
        (torch.from_numpy(w) * out).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ours.mean.numpy(), np.asarray(variables["stream"]["mean"]),
                                   rtol=1e-6, atol=1e-7)
        assert ours.count.item() == float(variables["stream"]["count"])
        assert np.abs(np.asarray(ref_grad)).max() > 0
        assert_rel_close(xt.grad.numpy(), np.asarray(ref_grad), GRAD_RTOL, "dx")
    assert ours.count.item() == 10
    # eval mode changes nothing and returns the scaled stored mean
    ref, after = ms.apply(variables, jnp.asarray(x1), train=False, mutable=["stream"])
    out = ours.eval()(torch.from_numpy(x1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours.mean.numpy(), np.asarray(after["stream"]["mean"]))


def test_mean_stream_updates_once_per_step():
    """Inside a train step a second forward (a recomputation) folds the
    batch in once and returns what the first returned."""
    ms = MeanStream((3,), cap=4).train()
    x = torch.ones((2, 3))
    with stream_step(ms):
        first = ms(x)
        second = ms(x)
        assert ms.count.item() == 0  # written when the step ends
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    assert ms.count.item() == 2 and torch.all(ms.mean == 1)
    ms(torch.zeros((2, 3)))  # outside a step every call updates
    ms(torch.zeros((2, 3)))
    assert ms.count.item() == 4 and torch.allclose(ms.mean, torch.full((3,), 0.25))


# ----------------------------------------------------------- TemplateCreation

@pytest.fixture(scope="module")
def template():
    """The JAX TemplateCreation, its params (flow head redrawn, a smooth
    atlas) and its initial stream state."""
    jm = JaxTemplate(**CFG)
    src = _smooth(1)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(src)))
    params = _redraw_flow(dict(variables["params"]))
    params = dict(params, atlas=_smooth(5))
    return jm, params, dict(stream=variables["stream"])


def _template_terms(pkg_losses, term_cls):
    return [term_cls("y_source", pkg_losses.NCC().loss, weight=0.7, target_index=0),
            term_cls("y_target", pkg_losses.NCC().loss, weight=0.3,
                     target_output_key="atlas_tensor", name="neg_img"),
            term_cls("mean_stream", pkg_losses.MSE().loss, weight=1.0, target_index=1,
                     name="mean_stream"),
            term_cls("pos_flow", pkg_losses.Grad("l2", loss_mult=2).loss, weight=1.0,
                     target_index=2, name="grad")]


def _template_batch(seed):
    src = _smooth(seed)
    zero = np.zeros((1, *SHAPE, 3), np.float32)
    return (src,), (src, zero, zero, zero)


def test_template_forward_matches_jax(template):
    jm, params, state = template
    src = _smooth(2)
    ref, new_state = jax.jit(lambda v, x: jm.apply(v, x, mutable=["stream"]))(
        {"params": params, **state}, jnp.asarray(src))
    model = _load(TemplateCreation(**CFG), params, state).train()
    with torch.no_grad():
        out = model(torch.from_numpy(src))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ("y_source", "y_target", "pos_flow", "neg_flow", "atlas", "atlas_tensor",
                "mean_stream"):
        assert out[key].shape == ref[key].shape, key
        assert_rel_close(out[key].detach().numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    ours = modelio.state_to_jax(model)
    assert sorted(ours) == ["stream||mean_stream||count", "stream||mean_stream||mean"]
    for key, val in flatten(new_state).items():
        assert_rel_close(ours[key], val, OUT_RTOL, key)
    # the atlas setter and getter
    model.set_atlas(_smooth(7)[0])
    np.testing.assert_array_equal(model.get_atlas(), _smooth(7)[0, ..., 0])
    np.testing.assert_array_equal(
        JaxTemplate.get_atlas(JaxTemplate.set_atlas(params, _smooth(7)[0])), model.get_atlas())


def test_template_train_steps_match_jax(template):
    """One step's loss, every gradient (the atlas's too) and the new stream
    state, then 3 Adam steps with the state carried, against JAX."""
    import optax
    jm, params, state = template
    inputs, targets = _template_batch(3)
    terms = _template_terms(jax_losses, jax_training.LossTerm)
    loss_fn = jax_training.make_loss_fn(jm, terms)
    (ref_loss, (ref_metrics, ref_state)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state, inputs, targets, jax.random.PRNGKey(0))
    tx = optax.adam(LR)
    step = jax_training.make_train_step(jm, terms, tx, donate=False)
    ref_params, ref_states, opt_state, jstate = params, [], tx.init(params), state
    for i in range(3):
        ref_params, jstate, opt_state, _ = step(ref_params, jstate, opt_state,
                                                jax.random.PRNGKey(0), np.asarray(i, np.int32),
                                                inputs, targets)
        ref_states.append(flatten(jax.device_get(jstate)))

    model = _load(TemplateCreation(**CFG), params, state)
    trainer = Trainer(model, _template_terms(losses, LossTerm), lr=LR, device="cpu")
    model.train()
    with stream_step(model):
        loss, metrics = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                                        tuple(map(torch.from_numpy, targets)))
        loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    for key in ("neg_img", "mean_stream", "grad"):
        assert metrics[key].item() == pytest.approx(float(ref_metrics[key]), rel=GRAD_RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_grads = flatten(ref_grads)
    assert sorted(grads) == sorted(ref_grads) and "atlas" in grads
    for name in ref_grads:
        assert_rel_close(grads[name], ref_grads[name], GRAD_RTOL, name)
    for key, val in flatten(ref_state).items():
        assert_rel_close(modelio.state_to_jax(model)[key], val, OUT_RTOL, key)

    model = _load(TemplateCreation(**CFG), params, state)
    trainer = Trainer(model, _template_terms(losses, LossTerm), lr=LR, device="cpu")
    for i in range(3):
        trainer.train_step(inputs, targets)
        assert model.mean_stream.count.item() == i + 1
        for key, val in ref_states[i].items():
            assert_rel_close(modelio.state_to_jax(model)[key], val, ADAM_RTOL, key)
    ours = modelio.params_to_jax(dict(model.named_parameters()))
    start, ref_params = flatten(params), flatten(ref_params)
    for name in ref_params:
        assert_rel_close(ours[name] - start[name], ref_params[name] - start[name], ADAM_RTOL,
                         name)


def _eval_match(jm, jparams, jstate, model, src):
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))({"params": jparams, **jstate},
                                                             jnp.asarray(src))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(src))
    for key in ("y_source", "y_target", "pos_flow", "mean_stream"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)


def _steps(trainer, n, batch):
    for _ in range(n):
        trainer.train_step(*batch)
    return trainer


def test_template_resumes_across_packages(template, tmp_path):
    """Two steps in one package, a checkpoint with the stream state, one
    step in the other: the params and state of three steps in one package,
    both ways; outputs equal after each load."""
    jm, params, state = template
    batch = _template_batch(4)
    start = flatten(params)
    jterms = _template_terms(jax_losses, jax_training.LossTerm)

    def compare(resumed, resumed_state, whole, whole_state):
        for name in whole:
            assert_rel_close(resumed[name] - start[name], whole[name] - start[name], ADAM_RTOL,
                             name)
        for key in whole_state:
            assert_rel_close(resumed_state[key], whole_state[key], ADAM_RTOL, key)

    # JAX -> port
    jt = jax_training.Trainer(jm, jterms, lr=LR)
    jt.init(batch[0])
    jt.init(None, params=jax.tree_util.tree_map(jnp.asarray, params))
    _steps(jt, 2, batch).save(str(tmp_path / "jax_0002.npz"))
    saved = np.load(tmp_path / "jax_0002.npz")
    assert float(saved["__extra__state||stream||mean_stream||count"]) == 2
    _steps(jt, 1, batch)
    resumed = Trainer(TemplateCreation(**CFG), _template_terms(losses, LossTerm), lr=LR,
                      device="cpu")
    resumed.load(str(tmp_path / "jax_0002.npz"))
    assert resumed.global_step == 2 and resumed.model.mean_stream.count.item() == 2
    jm2, jp2, extra = jax_load_model(str(tmp_path / "jax_0002.npz"), with_extra=True)
    _eval_match(jm2, jp2, extra["state"], resumed.model, _smooth(6))
    served = modelio.load_model(str(tmp_path / "jax_0002.npz"), device="cpu")
    assert served.mean_stream.count.item() == 2
    _eval_match(jm2, jp2, extra["state"], served, _smooth(6))
    _steps(resumed, 1, batch)
    compare(modelio.params_to_jax(dict(resumed.model.named_parameters())),
            modelio.state_to_jax(resumed.model), flatten(jax.device_get(jt.params)),
            flatten(jax.device_get(jt.state)))

    # port -> JAX
    first = _steps(Trainer(_load(TemplateCreation(**CFG), params, state),
                           _template_terms(losses, LossTerm), lr=LR, device="cpu"), 2, batch)
    first.save(str(tmp_path / "port_0002.npz"))
    jt = jax_training.Trainer(JaxTemplate(**CFG), jterms, lr=LR)
    jt.load(str(tmp_path / "port_0002.npz"))
    assert jt.global_step == 2 and float(jt.state["stream"]["mean_stream"]["count"]) == 2
    _eval_match(JaxTemplate(**CFG), jt.params, jt.state, first.model, _smooth(6))
    _steps(first, 1, batch)
    _steps(jt, 1, batch)
    compare(flatten(jax.device_get(jt.params)), flatten(jax.device_get(jt.state)),
            modelio.params_to_jax(dict(first.model.named_parameters())),
            modelio.state_to_jax(first.model))

    # a checkpoint without a state loads with zero buffers
    jax_save_model(str(tmp_path / "plain.npz"), jm, params)
    model = modelio.load_model(str(tmp_path / "plain.npz"), device="cpu")
    assert isinstance(model, TemplateCreation) and not model.training
    assert model.mean_stream.count.item() == 0 and not model.mean_stream.mean.any()


# ---------------------------------------------------- ConditionalTemplateCreation

@pytest.mark.parametrize("levels", [0, 2])
def test_conditional_forward_and_checkpoints(levels, tmp_path):
    """The forward of the phenotype decoder (no upsampling, and two levels)
    and a checkpoint of each package loading in the other."""
    cfg = dict(CFG, pheno_input_shape=(3,), conv_nb_features=4, extra_conv_layers=2,
               conv_nb_levels=levels)
    jm = JaxCond(**cfg)
    pheno = np.random.default_rng(8).normal(size=(1, 3)).astype(np.float32)
    atlas, src = _smooth(9), _smooth(10)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(pheno),
                                                jnp.asarray(atlas), jnp.asarray(src)))
    params = _redraw_flow(dict(variables["params"]))
    # atlas_gen drawn larger, so that the decoder shows in the atlas
    rng = np.random.default_rng(11)
    params["atlas_gen"] = {k: rng.normal(0.0, 0.1, v.shape).astype(np.float32)
                           for k, v in params["atlas_gen"].items()}
    state = dict(stream=variables["stream"])
    ref, new_state = jax.jit(lambda v, *a: jm.apply(v, *a, mutable=["stream"]))(
        {"params": params, **state}, jnp.asarray(pheno), jnp.asarray(atlas), jnp.asarray(src))
    model = _load(ConditionalTemplateCreation(**cfg), params, state).train()
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (pheno, atlas, src)))
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    assert np.abs(np.asarray(ref["atlas_tensor"]) - atlas).max() > 10 * OUT_RTOL
    for key in ("atlas_tensor", "y_source", "y_target", "pos_flow", "mean_stream"):
        assert out[key].shape == ref[key].shape, key
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    assert model.pheno_dense.weight.shape == params["pheno_dense"]["kernel"].shape[::-1]

    # JAX -> port and port -> JAX, the Dense kernel transposed both ways
    jax_save_model(str(tmp_path / "jax.npz"), jm, params)
    loaded = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert loaded.config == ConditionalTemplateCreation(**cfg).config
    modelio.save_model(str(tmp_path / "port.npz"), model)
    jm2, jp2, extra = jax_load_model(str(tmp_path / "port.npz"), with_extra=True)
    flat, ref_flat = flatten(jp2), flatten(params)
    assert sorted(flat) == sorted(ref_flat)
    for key in ref_flat:
        np.testing.assert_array_equal(flat[key], ref_flat[key], err_msg=key)
    for key, val in flatten(new_state).items():
        assert_rel_close(flatten(extra["state"])[key], val, OUT_RTOL, key)
    ref = jax.jit(lambda v, *a: jm2.apply(v, *a, train=False))(
        {"params": jp2, **extra["state"]}, jnp.asarray(pheno), jnp.asarray(atlas),
        jnp.asarray(src))
    with torch.no_grad():
        out = model.eval()(*map(torch.from_numpy, (pheno, atlas, src)))
    for key in ("atlas_tensor", "y_source", "mean_stream"):
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)


def test_conditional_refuses_what_jax_refuses():
    cfg = dict(CFG, pheno_input_shape=(3,), conv_nb_levels=1, conv_image_shape=(4, 8, 8))
    with pytest.raises(ValueError, match="upsampled through"):
        ConditionalTemplateCreation(**cfg)
    with pytest.raises(ValueError, match="upsampled through"):
        JaxCond(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)),
                            jnp.zeros((1, *SHAPE, 1)), jnp.zeros((1, *SHAPE, 1)))


# ---------------------------------------------------------- ProbAtlasSegmentation

def _prob_params(jm, image, atlas):
    """JAX init with the flow head redrawn, and the statistics' VALID convs
    drawn N(0, 0.1): their global max then has one clear winner."""
    params = _redraw_flow(dict(jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(atlas))["params"])))
    rng = np.random.default_rng(15)
    for name in ("mu_vol", "logsigmasq_vol"):
        params[name] = {k: rng.normal(0.0, 0.1, v.shape).astype(np.float32)
                        for k, v in params[name].items()}
    return params


def _prob_atlas(labels=3, seed=12):
    """A smooth probabilistic atlas: a softmax of blurred noise."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(4, 4, 4, labels)) * 3
    up = logits.repeat(4, 0).repeat(4, 1).repeat(4, 2)
    p = np.exp(up - up.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)[None]


@pytest.mark.parametrize("variant", ["post-warp", "pre-warp, supervised"])
def test_prob_atlas_forward_and_checkpoint(variant, tmp_path):
    post = variant == "post-warp"
    cfg = dict(CFG, nb_labels=3, stat_post_warp=post, supervised_model=not post,
               init_mu=[0.2, 0.5, 0.8], init_sigma=[0.1, 0.2, 0.3])
    image, atlas = _smooth(13), _prob_atlas()
    jm = JaxProb(**cfg)
    params = _prob_params(jm, image, atlas)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(image), jnp.asarray(atlas))
    model = _load(ProbAtlasSegmentation(**cfg), params).train()
    with torch.no_grad():
        out = model(torch.from_numpy(image), torch.from_numpy(atlas))
    assert np.abs(np.asarray(ref["flow"])).max() >= MIN_FLOW
    for key in ("loss_vol", "flow", "uloglhood", "stat_mu", "stat_logssq", "warped_atlas"):
        assert out[key].shape == ref[key].shape, key
        assert_rel_close(out[key].numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    if not post:
        np.testing.assert_allclose(out["loss_vol"].sum(-1).numpy(), 1.0, rtol=1e-5)
    jax_save_model(str(tmp_path / "jax.npz"), jm, params)
    loaded = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(loaded, ProbAtlasSegmentation)
    assert loaded.config == ProbAtlasSegmentation(**cfg).config
    with torch.no_grad():
        again = loaded(torch.from_numpy(image), torch.from_numpy(atlas))
    assert_rel_close(again["loss_vol"].numpy(), np.asarray(ref["loss_vol"]), OUT_RTOL,
                     "loss_vol")
    modelio.save_model(str(tmp_path / "port.npz"), loaded)
    _, jp2 = jax_load_model(str(tmp_path / "port.npz"))
    assert sorted(flatten(jp2)) == sorted(flatten(params))


def test_prob_atlas_step_matches_jax():
    """One step of the unsupervised segmentation recipe (the masked
    negative log-marginal and Grad-l2): the loss and every gradient."""
    from voxelmorph_tpu_torch.cli.train_unsupervised_seg import unsupervised_seg_terms
    cfg = dict(CFG, nb_labels=3, stat_post_warp=True)
    image, atlas = _smooth(14), _prob_atlas()
    image[..., :3, :] = 0  # a background the mask leaves out
    jm = JaxProb(**cfg)
    params = _prob_params(jm, image, atlas)

    def weight(inputs, out):
        m = (inputs[0] > 0).astype(jnp.float32)
        return -m / jnp.maximum(jnp.mean(m), 1e-8)

    terms = [jax_training.LossTerm("loss_vol", lambda _, yp: jnp.mean(yp, axis=-1, keepdims=True),
                                   weight=weight, target_index=0, name="nll"),
             jax_training.LossTerm("flow", jax_losses.Grad("l2", loss_mult=2).loss, weight=10.0,
                                   target_index=1, name="grad")]
    inputs = (image, atlas)
    targets = (atlas, np.zeros((1, *SHAPE, 3), np.float32))
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        jax_training.make_loss_fn(jm, terms), has_aux=True))(
        params, {}, inputs, targets, jax.random.PRNGKey(0))
    model = _load(ProbAtlasSegmentation(**cfg), params).train()
    trainer = Trainer(model, unsupervised_seg_terms(10.0), lr=LR, device="cpu")
    loss, _ = trainer.loss_fn(tuple(map(torch.from_numpy, inputs)),
                              tuple(map(torch.from_numpy, targets)))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_grads = flatten(ref_grads)
    assert sorted(grads) == sorted(ref_grads)
    for name in ref_grads:
        assert_rel_close(grads[name], ref_grads[name], GRAD_RTOL, name)
