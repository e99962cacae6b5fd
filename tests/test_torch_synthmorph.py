"""SynthMorph's synthesis in the PyTorch port against the JAX package on the
CPU: ``interpn_label_onehot`` in 2-D and 3-D (edges clamped, -1 labels)
against JAX's fused function and its packed path (the one-hot built and
concatenated, then ``interpn``); ``LabelsToImageConfig``; and
``labels_to_image`` on JAX's draws, replayed from its keys
(``synth_parity.jax_draws``).

Tolerances, relative to the largest magnitude of the compared tensor
(measured on the CPU in brackets): 1e-6 for ``interpn_label_onehot`` (0
against the fused function and the packed path: the same corner order, and
adding a zero changes no float), 1e-5 for ``labels_to_image``'s image,
one-hot and warps (the image 2.0e-7, from XLA's exp and pow against
torch's; the one-hot and the warps 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth_parity import jax_draws, label_maps
from torch_parity import assert_rel_close
from voxelmorph_tpu.models import synthmorph as jsynth
from voxelmorph_tpu.ops import interp as jinterp
from voxelmorph_tpu_torch.models import synthmorph
from voxelmorph_tpu_torch.ops import interp

ONEHOT_RTOL = 1e-6
SYNTH_RTOL = 1e-5
LABELS = [0, 2, 3, 7, 9]


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("shape", [(9, 11), (6, 7, 8)], ids=["2d", "3d"])
def test_interpn_label_onehot_matches_jax(shape):
    """Locations up to two voxels past every edge (clamped), some exactly
    on the edges, and labels -1 (no channel) among 0..L-1."""
    rng = np.random.default_rng(len(shape))
    nb = 5
    image = rng.normal(size=shape).astype(np.float32)
    lab = rng.integers(-1, nb, size=shape).astype(np.int32)
    out_shape = tuple(s + 2 for s in shape)
    loc = np.stack([rng.uniform(-2, s + 1, size=out_shape) for s in shape], -1)
    loc[:3, ..., 0] = 0.0
    loc[-3:, ..., 0] = shape[0] - 1
    loc = loc.astype(np.float32)

    img, oh = interp.interpn_label_onehot(torch.from_numpy(image), torch.from_numpy(lab),
                                          torch.from_numpy(loc), nb)
    assert img.shape == out_shape and oh.shape == (*out_shape, nb)
    ref_img, ref_oh = jinterp.interpn_label_onehot(jnp.asarray(image), jnp.asarray(lab),
                                                   jnp.asarray(loc), nb)
    assert_rel_close(_np(img), ref_img, ONEHOT_RTOL, "image, fused")
    assert_rel_close(_np(oh), ref_oh, ONEHOT_RTOL, "one-hot, fused")
    pack = jnp.concatenate([jnp.asarray(image)[..., None],
                            jax.nn.one_hot(jnp.asarray(lab), nb, dtype=jnp.float32)], -1)
    packed = np.asarray(jinterp.interpn(pack, jnp.asarray(loc)))
    assert_rel_close(_np(img), packed[..., 0], ONEHOT_RTOL, "image, packed")
    assert_rel_close(_np(oh), packed[..., 1:], ONEHOT_RTOL, "one-hot, packed")
    # a voxel whose corners all hold -1 has no channel; elsewhere the
    # channels sum to the share of corners with a label
    valid = interp.interpn(torch.from_numpy((lab >= 0).astype(np.float32)),
                           torch.from_numpy(loc))
    assert_rel_close(_np(oh.sum(-1)), _np(valid), ONEHOT_RTOL, "channel sums")


@pytest.mark.parametrize("kwargs", [
    dict(in_shape=(8, 9, 10), in_label_list=[3, 0, 7, 3, 2]),
    dict(in_shape=(8, 9), in_label_list=[1, 4, 5], out_label_list=[5, 4, 12, 1],
         out_shape=(10, 6), warp_res=[4, 8], bias_res=4, bias_std=0.0, zero_background=0.0)])
def test_config_matches_jax(kwargs):
    """to_dict, the lookup tables and the label counts (an output label the
    input lacks maps nowhere; a missing one to -1); from_dict round-trips."""
    ours = synthmorph.LabelsToImageConfig(**kwargs)
    ref = jsynth.LabelsToImageConfig(**kwargs)
    assert ours.to_dict() == ref.to_dict()
    np.testing.assert_array_equal(ours.index_lut, ref.index_lut)
    np.testing.assert_array_equal(ours.out_lut, ref.out_lut)
    assert (ours.nb_in_labels, ours.nb_out_labels) == (ref.nb_in_labels, ref.nb_out_labels)
    assert synthmorph.LabelsToImageConfig.from_dict(ours.to_dict()).to_dict() == ref.to_dict()


CASES = {
    # B = 2, the background zeroed in each sample (zero_background 1), an
    # output list without label 0 and with a label the maps lack
    "warp-zeroed-b2": (dict(in_shape=(12, 12, 12), in_label_list=LABELS,
                            out_label_list=[2, 3, 7, 9, 11], warp_std=2.0, warp_res=[6],
                            zero_background=1.0), 2, True, False),
    # a shared intensity key, the background not zeroed (no label 0), padded
    # along one axis and cropped along another
    "intensity-pad-crop": (dict(in_shape=(12, 12, 12), in_label_list=[1, 2, 3, 7, 9],
                                out_shape=(16, 8, 12), warp_std=2.0, warp_res=[6],
                                bias_res=[6, 12], blur_std=2.0), 1, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_to_image_matches_jax(case):
    """The port's map from JAX's draws gives JAX's image, one-hot and, with
    return_warp, the synthesis warp and its inverse."""
    kwargs, batch, return_warp, shared = CASES[case]
    ref_cfg = jsynth.LabelsToImageConfig(**kwargs)
    cfg = synthmorph.LabelsToImageConfig(**kwargs)
    maps = label_maps(5, batch, cfg.in_shape, cfg.in_label_list)
    key, ikey = jax.random.PRNGKey(3), (jax.random.PRNGKey(8) if shared else None)
    ref = jax.jit(lambda k, ik, m: jsynth.labels_to_image(
        k, m, ref_cfg, return_warp=return_warp, intensity_key=ik))(key, ikey, maps)
    draws = jax_draws(key, ref_cfg, batch, ikey)
    got = synthmorph.labels_to_image_from_draws(torch.from_numpy(maps), cfg, draws,
                                                return_warp=return_warp)
    assert len(got) == len(ref) == (4 if return_warp else 2)
    names = ["image", "one_hot", "warp", "inv_warp"]
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape, name
        assert_rel_close(_np(a), np.asarray(b), SYNTH_RTOL, f"{case}: {name}")
    image, one_hot = (np.asarray(x) for x in ref[:2])
    assert image.min() >= 0 and image.max() <= 1
    if return_warp:
        assert np.abs(np.asarray(ref[2])).max() >= 0.5  # voxels
        # each sample's background (label 0, the first intensity) is black
        # before the blur: its draws were zeroed
        assert all(d["zero"].item() for d in draws)
    else:
        # the padded border is zero
        assert not one_hot[:, :2].any() and not image[:, :2].any()
    # the port's own draws: the same map, shapes and ranges, and the shared
    # intensities taken from the other call's draws
    gen = torch.Generator().manual_seed(0)
    other = synthmorph.labels_to_image_draws(gen, cfg, batch)
    own = synthmorph.labels_to_image(gen, torch.from_numpy(maps), cfg, return_warp,
                                     intensity_draws=other if shared else None)
    assert [tuple(t.shape) for t in own] == [tuple(t.shape) for t in got]
    assert 0 <= own[0].min().item() and own[0].max().item() <= 1
