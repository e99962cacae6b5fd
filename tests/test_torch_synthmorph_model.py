"""SynthMorphDense in the PyTorch port against the JAX package on the CPU:
the forward and one train step of ``scripts/train_synthmorph.py``'s loss
(on JAX's synthesis draws, replayed from the keys its two
``labels_to_image`` calls receive), checkpoints in both directions, and the
committed ``artifacts_r5/synth_w25_00010.npz`` registering a pair through
``resolve_registration_model`` as JAX's does.

The keys are recorded by wrapping the JAX module's ``labels_to_image``
during an eager (unjitted) ``value_and_grad`` of JAX's loss: flax's
``make_rng`` derives them. Networks are 16^3 with narrow features and the
flow head redrawn N(0, 0.3) (flows of voxels). Tolerances, each relative
to the largest magnitude of the compared tensor (measured on the CPU in
brackets): 1e-5 on float32 forwards (largest 4.7e-6, pred_map), 1e-4 on
the loss, its terms and every gradient (2.3e-6; as
``tests/test_torch_train.py``).
The committed checkpoint is bfloat16; it is compared with a float32
override in both packages, since bfloat16 convolutions round in another
order in each.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth_parity import jax_draws, label_maps
from torch_parity import assert_rel_close, flatten, unflatten
from voxelmorph_tpu import losses as jax_losses
from voxelmorph_tpu import registration as jax_registration
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models import synthmorph as jsynth
from voxelmorph_tpu.models.unet import Unet as JaxUnet
from voxelmorph_tpu_torch import registration
from voxelmorph_tpu_torch.cli.train_synthmorph import synthmorph_terms
from voxelmorph_tpu_torch.models import modelio, synthmorph
from voxelmorph_tpu_torch.models.unet import Unet
from voxelmorph_tpu_torch.models.vxm import VxmDense
from voxelmorph_tpu_torch.ops.interp import resize
from voxelmorph_tpu_torch.training import make_loss_fn

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
MIN_FLOW = 0.5  # voxels
LABELS = [0, 2, 3, 7, 9]
NET = dict(nb_unet_features=[[4, 8], [8, 4]], int_steps=3)
CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "artifacts_r5",
                          "synth_w25_00010.npz")

# (config kwargs, model fields, same subject, NCC weight, flow-MSE weight,
# the seed of JAX's step key): the full loss with the supervised flow and a
# shared-contrast coin (seed 5: the coin shares the contrast); the reference
# loss set (Dice + Grad) on maps padded to the network's shape. Two
# synthesis squarings keep JAX's eager run short.
CASES = {
    "supflow-shared-ncc": (dict(in_shape=(16, 16, 16), warp_std=2.0, warp_res=[8],
                                warp_int_steps=2),
                           dict(sup_flow=True, shared_contrast=0.5), True, 0.25, 0.1, 5),
    "reference-padded": (dict(in_shape=(12, 16, 16), out_shape=(16, 16, 16),
                              out_label_list=[2, 3, 9, 11], warp_std=2.0, warp_res=[8],
                              warp_int_steps=2), dict(), False, 0.0, 0.0, 4),
}


def _models(cfg_kwargs, fields):
    """The port's model from seed 0 and the JAX module with the same
    params, the flow head redrawn N(0, 0.3) (JAX params as numpy)."""
    cfg = synthmorph.LabelsToImageConfig(in_label_list=LABELS, **cfg_kwargs)
    ref_cfg = jsynth.LabelsToImageConfig(in_label_list=LABELS, **cfg_kwargs)
    model = synthmorph.SynthMorphDense(cfg, **NET, **fields,
                                       generator=torch.Generator().manual_seed(0))
    flat = modelio.params_to_jax(dict(model.named_parameters()))
    rng = np.random.default_rng(3)
    for key in sorted(flat):
        if key.endswith("flow||kernel"):
            flat[key] = rng.normal(0.0, 0.3, flat[key].shape).astype(np.float32)
    model.load_state_dict(modelio.params_from_jax(flat))
    return model, jsynth.SynthMorphDense(cfg=ref_cfg, **NET, **fields), unflatten(flat)


def _jax_terms(image_weight, flow_weight):
    """scripts/train_synthmorph.py's loss terms."""
    dice = jax_losses.Dice()
    terms = [jax_training.LossTerm("pred_map", lambda t, p: dice.loss(t, p) + 1.0,
                                   target_output_key="map_2", name="dice"),
             jax_training.LossTerm("pos_flow", jax_losses.Grad("l2", loss_mult=1.0).loss,
                                   target_output_key="pos_flow", name="grad")]
    if image_weight:
        terms.append(jax_training.LossTerm("y_source", jax_losses.NCC().loss,
                                           weight=image_weight, target_output_key="image_2",
                                           name="ncc"))
    if flow_weight:
        terms.append(jax_training.LossTerm(
            "pos_flow", lambda t, p: jnp.mean(jnp.square(p - t), axis=tuple(range(1, p.ndim))),
            weight=flow_weight, target_output_key="gt_flow", name="supflow"))
    return terms


@pytest.fixture
def synth_keys(monkeypatch):
    """The (key, intensity key) of each labels_to_image call of the JAX
    module, in order."""
    calls = []
    original = jsynth.labels_to_image

    def record(key, label_map, cfg, return_warp=False, intensity_key=None):
        calls.append((np.asarray(key), None if intensity_key is None
                      else np.asarray(intensity_key)))
        return original(key, label_map, cfg, return_warp=return_warp,
                        intensity_key=intensity_key)

    monkeypatch.setattr(jsynth, "labels_to_image", record)
    return calls


def _port_draws(calls, cfg, batch, share_coin):
    """The port's draws of one forward from JAX's two recorded calls. Where
    JAX's coin shared the contrast, the target's intensities are replayed
    from its own key instead: the port must replace them by the source's."""
    (k1, ik1), (k2, ik2) = calls
    share = None
    if share_coin:
        shared = bool(np.array_equal(ik1, ik2))
        share = torch.tensor(shared)
        if shared:
            ik2 = None
    return {"share": share, "src": jax_draws(k1, cfg, batch, ik1),
            "trg": jax_draws(k2, cfg, batch, ik2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_train_step_match_jax(case, synth_keys):
    """Every output of a training-mode forward, and one step's loss, metrics
    and gradients, on the same synthesis draws. JAX's side is one eager
    value_and_grad of the loss of ``training.make_loss_fn`` (its rng split
    for the 'synth' stream, each term's mean of weight times raw value)
    with the outputs as its aux; jitted, XLA's fusions move JAX's own
    gradients by up to 1.5e-3 here (constant regions make max-pool ties
    that rounding breaks), so the eager run is the reference."""
    cfg_kwargs, fields, same_subj, image_w, flow_w, seed = CASES[case]
    model, jm, params = _models(cfg_kwargs, fields)
    cfg = model.cfg
    src = label_maps(1, 1, cfg.in_shape, LABELS).astype(np.float32)
    trg = src if same_subj else label_maps(2, 1, cfg.in_shape, LABELS).astype(np.float32)
    synth_key = jax.random.split(jax.random.PRNGKey(seed), 1)[0]
    terms = _jax_terms(image_w, flow_w)

    def jax_loss(p):
        out = jm.apply({"params": p}, src, trg, train=True, rngs={"synth": synth_key})
        total, metrics = 0.0, {}
        for term in terms:
            raw = term.fn(out[term.target_output_key], out[term.output_key])
            total = total + jnp.mean(term.weight * raw)
            metrics[term.name] = jnp.mean(raw)
        return total, (metrics, out)

    (ref_loss, (ref_metrics, ref)), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        params)
    assert len(synth_keys) == 2
    draws = _port_draws(synth_keys, jm.cfg, 1, fields.get("shared_contrast", 0) > 0)
    assert (draws["share"] is not None and draws["share"].item()) == (case == "supflow-shared-ncc")

    model.train()
    inputs = (torch.from_numpy(src), torch.from_numpy(trg))
    outputs = {}
    loss, metrics = make_loss_fn(
        lambda *x, generator=None: outputs.update(model(*x, draws=draws)) or outputs,
        synthmorph_terms(1.0, image_w, flow_w))(inputs, (torch.zeros(1),))
    loss.backward()
    assert sorted(outputs) == sorted(ref)
    assert ("gt_flow" in outputs) == fields.get("sup_flow", False)
    assert np.abs(np.asarray(ref["pos_flow"])).max() >= MIN_FLOW
    for key in ref:
        assert_rel_close(outputs[key].detach().numpy(), np.asarray(ref[key]), OUT_RTOL, key)
    assert loss.item() == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    assert sorted(metrics) == sorted([*ref_metrics, "loss"])
    for name in ref_metrics:
        assert metrics[name].item() == pytest.approx(float(ref_metrics[name]), rel=GRAD_RTOL)
    grads = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref_grads = flatten(ref_grads)
    assert sorted(grads) == sorted(ref_grads)
    for name in ref_grads:
        assert_rel_close(grads[name], ref_grads[name], GRAD_RTOL, name)


def test_unet_gradients_through_zero_padding_match_jax():
    """Zero-padded slabs (SynthMorph's out_shape) through convs with zero
    bias give pre-activations of exactly 0, where flax's LeakyReLU has
    derivative 1 (torch's F.leaky_relu: the slope). The U-Net's gradients
    on such an input against JAX's, within GRAD_RTOL (measured 6.3e-7; 0.29
    with torch's derivative)."""
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(1, 16, 16, 16, 2)).astype(np.float32)
    x[:, :2] = x[:, -2:] = 0.0
    jm = JaxUnet(ndims=3, nb_features=[[4, 8], [8, 4]], nb_upsample_skips=1)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x)["params"])
    w = rng.normal(size=jm.apply({"params": params}, x).shape).astype(np.float32)
    ref = flatten(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x) * w))(params))
    unet = Unet(3, 2, nb_features=[[4, 8], [8, 4]], nb_upsample_skips=1)
    unet.load_state_dict(modelio.params_from_jax(flatten(params)))
    out = unet(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    (out * torch.from_numpy(w)).sum().backward()
    got = modelio.params_to_jax({n: p.grad for n, p in unet.named_parameters()})
    for name in ref:
        assert_rel_close(got[name], ref[name], GRAD_RTOL, name)


def test_shared_contrast_and_eval_draws():
    """shared_contrast 1 gives the target the source's intensity draws (the
    coin is drawn first, on the maps' device); in eval mode the draws come
    from a generator seeded 0, so two calls agree."""
    cfg = synthmorph.LabelsToImageConfig((8, 8, 8), LABELS, warp_res=[4])
    model = synthmorph.SynthMorphDense(cfg, **NET, shared_contrast=1.0)
    draws = model.draw(torch.Generator().manual_seed(1), 2, "cpu")
    assert draws["share"].dtype == torch.bool and draws["share"].item()
    maps = torch.from_numpy(label_maps(1, 2, cfg.in_shape, LABELS))
    model.train()
    out = model(maps, maps, draws=draws)
    for d_src, d_trg in zip(draws["src"], draws["trg"]):
        assert not torch.equal(d_src["means"], d_trg["means"])
    # same map, same means and stds, other noise and warps: the images
    # differ, but both hold the source's contrast
    moved = synthmorph.labels_to_image_from_draws(
        maps, cfg, [synthmorph.shared_intensity(t, s, True)
                    for t, s in zip(draws["trg"], draws["src"])])
    assert torch.equal(out["image_2"], moved[0])
    model.eval()
    first, second = (model(maps, maps)["image_1"] for _ in range(2))
    assert torch.equal(first, second)


def test_checkpoints_load_in_both_packages(tmp_path):
    """A JAX SynthMorphDense checkpoint loads strictly in the port with its
    LabelsToImageConfig; a port checkpoint gives JAX's load_model the same
    config and params."""
    cfg_kwargs, fields = CASES["supflow-shared-ncc"][:2]
    _, jm, params = _models(cfg_kwargs, fields)
    jax_save_model(str(tmp_path / "jax.npz"), jm, params)
    ours = modelio.load_model(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(ours, synthmorph.SynthMorphDense)
    assert ours.cfg.to_dict() == jm.cfg.to_dict()
    assert (ours.sup_flow, ours.shared_contrast) == (True, 0.5)
    got = modelio.params_to_jax(dict(ours.named_parameters()))
    want = flatten(params)
    assert sorted(got) == sorted(want) and all(k.startswith("vxm||") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])

    modelio.save_model(str(tmp_path / "port.npz"), ours)
    back_model, back_params = jax_load_model(str(tmp_path / "port.npz"))
    assert type(back_model).__name__ == "SynthMorphDense"
    assert back_model.cfg.to_dict() == jm.cfg.to_dict()
    for field in ("nb_unet_features", "int_steps", "int_resolution", "svf_resolution",
                  "sup_flow", "shared_contrast"):
        assert np.array_equal(np.asarray(getattr(back_model, field), dtype=object),
                              np.asarray(getattr(jm, field), dtype=object)), field
    back = flatten(back_params)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key])


def _smooth_pair(shape, seed=0):
    """Low-frequency noise and a copy of it shifted by a voxel, in [0, 1]."""
    coarse = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 5, 6, 1), dtype=np.float32))
    img = resize(coarse, [s / c for s, c in zip(shape, (4, 5, 6))], new_shape=shape)
    img = ((img - img.min()) / (img.max() - img.min())).numpy()
    return img[None], np.roll(img, (1, -1, 1), axis=(0, 1, 2))[None]


def test_committed_checkpoint_registers_like_jax():
    """artifacts_r5/synth_w25_00010.npz (46 labels, features [[64]*4,
    [64]*6], bfloat16, shared_contrast 0.5, trained at 80x96x112) loads
    strictly; its resolved VxmDense, re-targeted to 32x32x48 in float32,
    registers a smooth pair as JAX's does."""
    shape = (32, 32, 48)
    ours = modelio.load_model(CHECKPOINT, device="cpu")
    assert isinstance(ours, synthmorph.SynthMorphDense)
    assert ours.cfg.nb_in_labels == ours.cfg.nb_out_labels == 46
    assert ours.cfg.in_shape == (80, 96, 112) and ours.vxm.dtype == torch.bfloat16
    assert ours.shared_contrast == 0.5
    jm, jparams = jax_load_model(CHECKPOINT)
    jm, jparams = jax_registration.resolve_registration_model(
        jm.clone(dtype=jnp.float32), jparams, inshape=shape)
    net = registration.resolve_registration_model(
        modelio.load_model(CHECKPOINT, device="cpu", dtype=torch.float32), inshape=shape)
    assert type(net) is VxmDense and net.inshape == shape and net.dtype == torch.float32
    moving, fixed = _smooth_pair(shape)
    ref_moved, ref_warp = jax_registration.build_register_fn(jm)(jparams, moving, fixed)
    moved, warp = registration.build_register_fn(net)(torch.from_numpy(moving),
                                                      torch.from_numpy(fixed))
    assert np.abs(np.asarray(ref_warp)).max() >= MIN_FLOW
    assert_rel_close(warp.numpy(), np.asarray(ref_warp), OUT_RTOL, "warp")
    assert_rel_close(moved.numpy(), np.asarray(ref_moved), OUT_RTOL, "moved")
