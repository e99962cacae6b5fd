"""SynthMorph's joint affine and deformable model in the PyTorch port against
the JAX package on the CPU: ``_scale_matrix`` and ``_cen_matrix``,
``_FeatureEncoder``, ``VxmAffineFeatureDetector`` over its flags and
``HyperVxmJoint`` over its branches in 2-D and 3-D, the gradients of one
scalar of ``tot_1``, checkpoints in both directions, the seeded init's
scales, and the linear algebra a singular fit meets.

Inputs are smooth blobs with a little noise (numpy seeds); the port's
seeded init is carried to JAX with ``params_to_jax`` (flax's own init is
compared with it by its scales), and JAX's forwards run op by op, which
compiles each op once for the whole file. Volumes are 16^3 and 32x32 with
narrow widths; the detector's least-squares fit has 8 landmarks (its 8
features' barycenters) for 4 (or 3) unknowns a row. The fit is well
conditioned at these inputs: ``test_fit_is_well_conditioned`` holds the
condition number of each weighted normal matrix of the detector tests under
1e3 (measured at most 3.5e2), so float32 round-off, which both packages
make in their own order, moves the fit by up to about 1e3 x 6e-8 = 6e-5 of
itself. Tolerances, each relative to the largest magnitude of the compared
tensor (measured on the CPU in brackets): 1e-5 on forwards (1.2e-6), 1e-4
on the outputs that follow the fit (the detector's aff, dense and moved,
the joint model's aff, tot and moved), set from that conditioning (3.5e-5,
in 2-D at full resolution; 1.3e-6 in 3-D), and 1e-4 on gradients
(6.4e-6), as ``tests/test_torch_hyper.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, flatten, unflatten
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu.models import save_model as jax_save_model
from voxelmorph_tpu.models import synthmorph as jax_synth
from voxelmorph_tpu.ops import affine as jax_affine
from voxelmorph_tpu.ops import image as jax_image
from voxelmorph_tpu_torch.models import modelio, synthmorph
from voxelmorph_tpu_torch.ops import affine, conv3, image

OUT_RTOL = 1e-5
FIT_RTOL = 1e-4
GRAD_RTOL = 1e-4
SHAPES = {3: (16, 16, 16), 2: (32, 32)}
# narrow widths: the detector's maps are 4^3 (8x8 in 2-D) of 8 features
DET = dict(num_feat=8, enc_nf=(8, 8), dec_nf=(8,), add_nf=(8,))
JOINT = dict(int_steps=3, hyp_units=(4,), enc_nf=(4, 8), dec_nf=(8, 4), add_nf=(4,),
             aff_num_feat=8, aff_enc_nf=(8,))
HYP = np.array([[0.3]], np.float32)


def _blobs(seed, shape, batch=1):
    """Two batches of smooth blobs with a little noise, ``(B, *S, 1)``."""
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


def _seeded(cls, seed=0, **kw):
    """The port model drawn from ``seed``, and its params as JAX's tree."""
    model = cls(**kw, generator=torch.Generator().manual_seed(seed)).eval()
    return model, unflatten(modelio.params_to_jax(dict(model.named_parameters())))


def _compare(out, ref, fit_keys=()):
    """Every output against JAX's: ``fit_keys`` (those that follow the
    detector's fit) within FIT_RTOL, the rest within OUT_RTOL."""
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape, key
        rtol = FIT_RTOL if key.split("_")[0] in fit_keys else OUT_RTOL
        assert_rel_close(out[key].detach().numpy(), np.asarray(ref[key]), rtol, key)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("fact", [2.0, 0.5])
def test_scale_and_centre_matrices_match_jax(nd, fact):
    shape = SHAPES[nd]
    np.testing.assert_array_equal(synthmorph._scale_matrix(fact, nd).numpy(),
                                  np.asarray(jax_synth._scale_matrix(fact, nd)))
    sign = 1.0 if fact > 1 else -1.0
    np.testing.assert_array_equal(synthmorph._cen_matrix(shape, sign).numpy(),
                                  np.asarray(jax_synth._cen_matrix(shape, sign)))


@pytest.mark.parametrize("nd,kw", [
    (3, dict(num_feat=8, enc_nf=(8, 8), add_nf=(8,))),
    (3, dict(num_feat=4, enc_nf=(4, 8), dec_nf=(8, 4), add_nf=(4,), per_level=2)),
    (2, dict(num_feat=8, enc_nf=(8, 8), dec_nf=(8,), add_nf=(8, 8))),
], ids=["3d", "3d-decoder-per-level-2", "2d-decoder"])
def test_feature_encoder_matches_jax(nd, kw):
    x = _blobs(0, SHAPES[nd])[0]
    model, params = _seeded(synthmorph._FeatureEncoder, ndims=nd, **kw)
    ref = jax_synth._FeatureEncoder(ndims=nd, **kw).apply({"params": params}, x)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and float(out.min()) >= 0
    assert_rel_close(out.numpy(), np.asarray(ref), OUT_RTOL, "features")


DETECTOR_FLAGS = {
    "default": dict(),
    "full-res": dict(half_res=False),
    "unweighted": dict(weighted=False, make_dense=False),
    "rigid": dict(rigid=True),
    "mid-space": dict(return_trans_to_mid_space=True, bidir=True),
    "half-res-out": dict(return_trans_to_half_res=True, return_moved=True, return_feat=True),
    "moved-full": dict(return_moved=True, make_dense=False),
}


def _detector(nd, flags, seed=0):
    """JAX's detector, its params, the blob pairs (batch 2), the port model."""
    kw = dict(in_shape=SHAPES[nd], **DET, **flags)
    model, params = _seeded(synthmorph.VxmAffineFeatureDetector, seed, **kw)
    return (jax_synth.VxmAffineFeatureDetector(**kw), params, _blobs(1, SHAPES[nd], batch=2),
            model)


@pytest.mark.parametrize("flags", DETECTOR_FLAGS.values(), ids=DETECTOR_FLAGS.keys())
@pytest.mark.parametrize("nd", [2, 3])
def test_affine_detector_matches_jax(nd, flags):
    """Every output of the detector, batch 2, against JAX's; its two
    matrices are inverses (but for the half-resolution output's, each
    composed with the same 2x scaling). The mid-space matrices are square
    roots (Denman-Beavers), which exist only for an affine with no
    eigenvalue on the negative real axis: seed 0's 3-D init fits a
    reflection to the first pair, whose iteration converges in neither
    package, so that case draws from seed 2 and checks that each root
    squares to the affine."""
    mid = flags.get("return_trans_to_mid_space", False)
    jm, params, (im_1, im_2), model = _detector(nd, flags, seed=2 if mid else 0)
    ref = jm.apply({"params": params}, im_1, im_2)
    with torch.no_grad():
        out = model(torch.from_numpy(im_1), torch.from_numpy(im_2))
    _compare(out, ref, fit_keys=("aff", "dense", "moved"))
    sq = affine.make_square_affine
    if mid:
        full = _detector(nd, {}, seed=2)[3]
        with torch.no_grad():
            aff = full(torch.from_numpy(im_1), torch.from_numpy(im_2))["aff_1"]
        np.testing.assert_allclose((sq(out["aff_1"]) @ sq(out["aff_1"])).numpy(),
                                   sq(aff).numpy(), atol=1e-4)
    if not flags.get("return_trans_to_half_res"):
        np.testing.assert_allclose((sq(out["aff_1"]) @ sq(out["aff_2"])).numpy(),
                                   np.broadcast_to(np.eye(nd + 1), (2, nd + 1, nd + 1)),
                                   atol=1e-4)


JOINT_FLAGS = {
    "default": dict(),
    "mid-space": dict(mid_space=True),
    "skip-affine": dict(skip_affine=True),
    "half-res-moved": dict(return_trans_to_half_res=True, return_moved=True),
    "no-integration": dict(int_steps=0),
}


def _joint(nd, flags, seed=0):
    """JAX's HyperVxmJoint, its params, the blob pair, and the port model."""
    kw = dict(in_shape=SHAPES[nd], **{**JOINT, **flags})
    model, params = _seeded(synthmorph.HyperVxmJoint, seed, **kw)
    return jax_synth.HyperVxmJoint(**kw), params, _blobs(2, SHAPES[nd]), model


@pytest.mark.parametrize("flags", JOINT_FLAGS.values(), ids=JOINT_FLAGS.keys())
@pytest.mark.parametrize("nd", [2, 3])
def test_joint_forward_matches_jax(nd, flags):
    """Every output of HyperVxmJoint against JAX's; the SVF symmetrised."""
    jm, params, (im_1, im_2), model = _joint(nd, flags)
    ref = jm.apply({"params": params}, HYP, im_1, im_2)
    with torch.no_grad():
        out = model(torch.from_numpy(HYP), torch.from_numpy(im_1), torch.from_numpy(im_2))
    _compare(out, ref, fit_keys=("aff", "tot", "moved"))
    assert torch.equal(out["svf_2"], -out["svf_1"])
    assert np.abs(np.asarray(ref["svf_1"])).max() > 0.05  # voxels: a flow to compare


def test_joint_gradients_match_jax():
    """The gradient of sum(tot_1 * w) (w a fixed normal draw) with respect
    to every parameter, the detector's and the hypernetwork's included,
    against jax.grad."""
    jm, params, (im_1, im_2), model = _joint(3, {})
    w = np.random.default_rng(5).normal(size=(1, *SHAPES[3], 3)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, HYP, im_1, im_2)["tot_1"] * w)))(params)
    out = model(torch.from_numpy(HYP), torch.from_numpy(im_1), torch.from_numpy(im_2))
    (out["tot_1"] * torch.from_numpy(w)).sum().backward()
    ours = modelio.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    ref = flatten(grads)
    assert sorted(ours) == sorted(ref)
    assert any(k.startswith("affine||detector") for k in ref)
    for key, val in ref.items():
        if not np.abs(val).max():
            np.testing.assert_array_equal(ours[key], 0.0, err_msg=key)
            continue
        assert_rel_close(ours[key], val, GRAD_RTOL, key)


@pytest.mark.parametrize("nd", [2, 3])
def test_fit_is_well_conditioned(nd):
    """The weighted normal matrices of the fits of the detector tests
    (detection at half and at full resolution, both samples, both
    directions) and of the joint model's default test have condition
    numbers under 1e3."""
    shape = SHAPES[nd]
    cases = []
    for flags in (DETECTOR_FLAGS["default"], DETECTOR_FLAGS["full-res"]):
        _, _, ims, model = _detector(nd, flags)
        cases.append((model, ims, model.half_res))
    _, _, ims, joint = _joint(nd, {})
    cases.append((joint.affine, [_half(torch.from_numpy(x)).numpy() for x in ims], False))
    conds = []
    for model, ims, half_res in cases:
        ims = [torch.from_numpy(x) for x in ims]
        if half_res:
            ims = [_half(x) for x in ims]
        with torch.no_grad():
            feats = [model.detector(x) for x in ims]
        pows = [f.sum(dim=tuple(range(1, nd + 1))) for f in feats]
        weights = torch.ones_like(pows[0])
        for p in pows:
            weights = weights * p / p.sum(-1, keepdim=True)
        size = torch.tensor(model.in_shape, dtype=torch.float32)
        for f in feats:
            cen = image.barycenter(f) * size
            x = torch.cat([cen, torch.ones_like(cen[..., :1])], dim=-1)
            normal = (x.transpose(-1, -2) * weights[:, None, :]) @ x
            conds += torch.linalg.cond(normal.double()).tolist()
    assert max(conds) < 1e3, conds


def _half(x):
    """Images ``(B, *S, 1)`` downsampled by 2, as the detector's half_res."""
    nd = x.dim() - 2
    scale = synthmorph._scale_matrix(2.0, nd)[None].expand(x.shape[0], nd, nd + 1)
    return synthmorph._warp_to(x, scale, tuple(s // 2 for s in x.shape[1:-1]))


def test_weights_round_trip_between_the_packages(tmp_path):
    """A JAX checkpoint of either class loads in the port, and the port's
    in JAX, bit for bit, keys such as ``affine||detector||enc_0_0||kernel``,
    ``hyp_dense_0||kernel`` and ``def_add_0||kernel_gen||kernel`` included."""
    jm, params, _, model = _joint(3, {})
    flat = flatten(jax.device_get(params))
    for key in ("affine||detector||enc_0_0||kernel", "hyp_dense_0||kernel",
                "def_add_0||kernel_gen||kernel", "def_flow||bias_gen||bias"):
        assert key in flat
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_model(jax_path, jm, jax.device_get(params))
    loaded = modelio.load_model(jax_path, device="cpu")
    assert isinstance(loaded, synthmorph.HyperVxmJoint) and loaded.config == model.config
    for key, val in modelio.params_to_jax(dict(loaded.named_parameters())).items():
        np.testing.assert_array_equal(val, flat[key], err_msg=key)
    modelio.save_model(port_path, loaded)
    jm2, params2 = jax_load_model(port_path)
    assert type(jm2).__name__ == "HyperVxmJoint" and tuple(jm2.in_shape) == jm.in_shape
    back = flatten(jax.device_get(params2))
    assert sorted(back) == sorted(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)

    kw = dict(in_shape=SHAPES[2], **DET, rigid=True)
    _, det_params = _seeded(synthmorph.VxmAffineFeatureDetector, 1, **kw)
    jax_save_model(jax_path, jax_synth.VxmAffineFeatureDetector(**kw), det_params)
    port_det = modelio.load_model(jax_path, device="cpu")
    assert isinstance(port_det, synthmorph.VxmAffineFeatureDetector) and port_det.rigid
    modelio.save_model(port_path, port_det)
    det_flat = flatten(jax.device_get(det_params))
    back = flatten(jax.device_get(jax_load_model(port_path)[1]))
    assert sorted(back) == sorted(det_flat)
    for key, val in det_flat.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_seeded_init_scales_match_jax():
    """The port's seeded init against flax's, tensor by tensor: the same
    zero tensors, and the same standard deviation within 15% for each
    tensor of at least 2000 values (lecun-normal convs and Dense kernels,
    HyperConv's N(0, 1e-3) generator weights and he-scaled truncated base
    kernels)."""
    shape = SHAPES[3]
    kw = dict(in_shape=shape, int_steps=3, hyp_units=(16, 16), enc_nf=(16, 16),
              dec_nf=(16, 16), add_nf=(16,), aff_num_feat=16, aff_enc_nf=(16,))
    im = _blobs(0, shape)[0]
    ref = flatten(jax.device_get(jax.jit(lambda key: jax_synth.HyperVxmJoint(**kw).init(
        key, HYP, im, im))(jax.random.PRNGKey(0))["params"]))
    model = synthmorph.HyperVxmJoint(**kw, generator=torch.Generator().manual_seed(0))
    ours = modelio.params_to_jax(dict(model.named_parameters()))
    assert sorted(ours) == sorted(ref)
    checked = 0
    for key, val in ref.items():
        assert ours[key].shape == val.shape, key
        if not np.any(val):
            assert not np.any(ours[key]), key
        elif val.size >= 2000:
            assert abs(ours[key].std() / val.std() - 1) < 0.15, (key, ours[key].std(), val.std())
            checked += 1
    assert checked >= 12


def test_conv_kernel_mode_leaves_the_joint_model_unchanged():
    """VXM_PALLAS_CONV=1 (set_pallas_conv) sends no joint conv to the conv
    kernel: the outputs are bit-equal to cuDNN mode's."""
    _, _, (im_1, im_2), model = _joint(3, {})
    args = (torch.from_numpy(HYP), torch.from_numpy(im_1), torch.from_numpy(im_2))
    with torch.no_grad():
        ref = model(*args)
        conv3.set_pallas_conv(True)
        try:
            out = model(*args)
        finally:
            conv3.set_pallas_conv(None)
    for key in ref:
        assert torch.equal(out[key], ref[key]), key


def _singular_cases():
    # three landmarks in the plane z = 0: the normal matrix's last spatial
    # row and column are zero
    trg = np.array([[[0, 0, 0], [2, 0, 0], [0, 3, 0]]], np.float32)
    src = trg + np.float32(0.5)
    mat = np.array([[1, 2, 3, 4], [2, 4, 6, 8], [0, 0, 1, 0]], np.float32)
    sq = np.zeros((4, 4), np.float32)
    return {
        "fit_affine": (lambda t: affine.fit_affine(*t), lambda a: jax_affine.fit_affine(*a),
                       (src, trg)),
        "invert_affine": (lambda t: affine.invert_affine(*t),
                          lambda a: jax_affine.invert_affine(*a), (mat,)),
        "sqrtm": (lambda t: image.sqrtm(*t), lambda a: jax_image.sqrtm(*a), (sq,)),
    }


@pytest.mark.parametrize("name", _singular_cases().keys())
def test_singular_linear_algebra_gives_non_finite_values(name):
    """A singular fit (3 landmarks in 3-D), a singular affine and a
    singular square root give non-finite values in both packages, at the
    same elements; the port does not raise."""
    port_fn, jax_fn, args = _singular_cases()[name]
    ours = port_fn(tuple(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jax_fn(tuple(jnp.asarray(a) for a in args)))
    assert not np.isfinite(ref).all() and not np.isfinite(ours).all()
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
