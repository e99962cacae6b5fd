"""SynthMorph's samplers, trainer and CLIs in the PyTorch port against the JAX
package on the CPU: ``generators.synthmorph`` and the cached label stream
(picks and flips equal to JAX's), ``Trainer.fit_cached_labels``'s K-step
dispatch against single steps (bit for bit), cli/train_synthmorph's flags
and defaults against scripts/train_synthmorph.py's, a tiny CPU run whose
checkpoints load in both packages and whose resumed run continues the
uninterrupted one bit for bit, and cli/register and cli/test serving a
SynthMorph checkpoint as scripts/register.py and scripts/test.py do.

Label maps are 16^3 (nearest-of-random-centres regions, ``synth_parity``)
with narrow networks. Tolerances: the samplers, the checkpoints and the
Dice scores are equal; the port's runs against each other are bit-equal;
the register CLI's warp and moved image within 1e-5 of JAX's, relative to
their largest magnitude (as ``tests/test_torch_hyper_cli.py``), the
checkpoint's flow head redrawn N(0, 0.3) for flows of voxels.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from synth_parity import label_maps
from torch_parity import assert_rel_close
from voxelmorph_tpu import generators as jax_generators
from voxelmorph_tpu import training as jax_training
from voxelmorph_tpu.models import load_model as jax_load_model
from voxelmorph_tpu_torch import generators, training
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import test as test_cli
from voxelmorph_tpu_torch.cli import train_synthmorph as train_cli
from voxelmorph_tpu_torch.models import modelio, synthmorph
from voxelmorph_tpu_torch.py.utils import load_volfile

SHAPE = (16, 16, 16)
LABELS = [0, 2, 3, 7]
OUT_RTOL = 1e-5
MIN_FLOW = 0.5  # voxels
SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
NET = ["--enc", "4", "8", "--dec", "8", "4", "--int-steps", "2"]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _maps(n=3):
    return list(label_maps(11, n, SHAPE, LABELS)[..., 0])


@pytest.mark.parametrize("same_subj", [False, True])
def test_synthmorph_generator_matches_jax(monkeypatch, same_subj):
    """Both modules' own rng seeded alike: the same pairs, flips and void
    outputs, draw for draw; an explicit rng gives the same stream."""
    maps = _maps()
    monkeypatch.setattr(jax_generators, "_rng", np.random.default_rng(7))
    monkeypatch.setattr(generators, "_rng", np.random.default_rng(7))
    ref = jax_generators.synthmorph(maps, batch_size=2, same_subj=same_subj)
    ours = generators.synthmorph(maps, batch_size=2, same_subj=same_subj)
    explicit = generators.synthmorph(maps, batch_size=2, same_subj=same_subj,
                                     rng=np.random.default_rng(7))
    for _ in range(6):
        (r_src, r_trg), r_void = next(ref)
        for (src, trg), void in (next(ours), next(explicit)):
            np.testing.assert_array_equal(src, r_src)
            np.testing.assert_array_equal(trg, r_trg)
            assert src.shape == (2, *SHAPE, 1) and len(void) == 2
            np.testing.assert_array_equal(void[0], r_void[0])
        if same_subj:
            np.testing.assert_array_equal(r_src, r_trg)


def test_cached_label_stream_matches_jax():
    """device_cached_label_indices equals JAX's step for step (each flag
    set, with and without same_subj and flips), and the cached generator's
    int32 pairs, gathered and flipped on the device, equal JAX's."""
    maps = _maps(4)
    for kwargs in (dict(batch_size=2), dict(batch_size=1, same_subj=True),
                   dict(batch_size=1, flip=False, seed=3)):
        ref = jax_training.device_cached_label_indices(4, 3, start_step=5, **kwargs)
        ours = training.device_cached_label_indices(4, 3, start_step=5, **kwargs)
        for _ in range(8):
            (pr, fr), (po, fo) = next(ref), next(ours)
            assert po.dtype == pr.dtype and fo.dtype == fr.dtype
            np.testing.assert_array_equal(po, pr)
            np.testing.assert_array_equal(fo, fr)
    ref = jax_training.device_cached_label_generator(maps, batch_size=2, start_step=2)
    ours = training.device_cached_label_generator(maps, batch_size=2, start_step=2,
                                                  device="cpu")
    flipped = 0
    for step in range(6):
        (r_src, r_trg), _ = next(ref)
        (src, trg), void = next(ours)
        assert src.dtype == torch.int32 and void[0].shape == (2, *SHAPE, 3)
        np.testing.assert_array_equal(src.numpy(), np.asarray(r_src))
        np.testing.assert_array_equal(trg.numpy(), np.asarray(r_trg))
        flipped += int(next(training.device_cached_label_indices(4, 3, 2, start_step=2 + step))
                       [1].any())
    assert flipped  # the stream flipped some pairs


def _small_model(cfg=None, flow_std=None):
    cfg = cfg or synthmorph.LabelsToImageConfig(SHAPE, LABELS, warp_std=2.0, warp_res=[8])
    model = synthmorph.SynthMorphDense(cfg, nb_unet_features=[[4, 8], [8, 4]], int_steps=2,
                                       shared_contrast=0.5,
                                       generator=torch.Generator().manual_seed(0))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(1))
    return model


def test_fit_cached_labels_dispatch_equals_single_steps():
    """K = 2 dispatches give the params, metrics and generator state of the
    same steps taken one at a time on the cached generator's pairs, bit for
    bit, with one metric fetch a dispatch."""
    maps = _maps()
    runs = {}
    for k in (1, 2):
        trainer = training.Trainer(_small_model(), train_cli.synthmorph_terms(1.0, 0.25),
                                   lr=1e-3, device="cpu")
        logged = []
        trainer.fit_cached_labels(maps, epochs=2, steps_per_epoch=2, steps_per_dispatch=k,
                                  start_step=3, log_fn=logged.append)
        runs[k] = trainer
        assert trainer.global_step == 4 and len(logged) == 2
    assert runs[1].metric_fetches == 4 and runs[2].metric_fetches == 2
    single = training.Trainer(_small_model(), train_cli.synthmorph_terms(1.0, 0.25), lr=1e-3,
                              device="cpu")
    stream = training.device_cached_label_generator(maps, start_step=3, device="cpu")
    for _ in range(4):
        inputs, targets = next(stream)
        single.train_step(inputs, targets)
    for trainer in runs.values():
        for name, p in single.model.state_dict().items():
            assert torch.equal(trainer.model.state_dict()[name], p), name
        assert torch.equal(trainer.generator.get_state(), single.generator.get_state())


def test_cli_flags_match_the_jax_script():
    """Every flag of scripts/train_synthmorph.py with its default, plus
    --device; the same values from the same arguments."""
    jax_parse = _script("train_synthmorph").parse_args
    for argv in (["--label-dir", "maps/"],
                 ["--label-dir", "a", "b", "--same-subj", "--blur-std", "2", "--gamma", "0.1",
                  "--vel-std", "1", "--vel-res", "8", "16", "--bias-std", "0.2", "--bias-res",
                  "20", "--out-shape", "160", "192", "224", "--out-labels", "l.npy",
                  "--epochs", "3", "--steps-per-epoch", "4", "--batch-size", "2",
                  "--init-weights", "latest", "--save-freq", "5", "--reg-param", "0.5",
                  "--sup-flow-weight", "0.1", "--image-loss-weight", "0.25",
                  "--shared-contrast", "0.5", "--lr", "1e-3", "--dtype", "bfloat16",
                  "--clip-grad", "1", "--init-epoch", "2", "--cache-device",
                  "--steps-per-dispatch", "4", "--int-steps", "7", "--enc", "8", "--dec", "8",
                  "--sub-dir", "s", "--model-dir", "m"]):
        ours = vars(train_cli.parse_args(argv))
        assert ours.pop("device") == "cuda"
        assert ours == vars(jax_parse(argv))
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--label-dir", "x", "--shared-contrast", "2"])


@pytest.fixture
def picks(monkeypatch):
    """The source label maps of every port train step, in order."""
    seen = []
    step = training.Trainer.train_step

    def record(self, inputs, targets):
        seen.append(np.array(inputs[0]))
        return step(self, inputs, targets)

    monkeypatch.setattr(training.Trainer, "train_step", record)
    return seen


def _write_maps(tmp_path):
    os.makedirs(tmp_path / "maps")
    for i, lab in enumerate(_maps(3)):
        np.save(tmp_path / "maps" / f"m{i}.npy", lab)
    np.save(tmp_path / "out_labels.npy", np.array([2, 3, 7, 12]))
    return str(tmp_path / "maps")


def test_cli_runs_resumes_and_writes_checkpoints_both_packages_load(tmp_path, picks):
    """A two-epoch --cache-device run in dispatches of 2; the same run stopped
    after one epoch and resumed from 'latest' on single steps (the pick
    stream one step on, as the JAX script's): the same picks and params bit
    for bit. The checkpoints load in the port and in JAX with the same
    config and params; --sup-flow-weight without --same-subj is refused."""
    label_dir = _write_maps(tmp_path)
    common = ["--label-dir", label_dir, *NET, "--steps-per-epoch", "2", "--save-freq", "1",
              "--out-labels", str(tmp_path / "out_labels.npy"), "--image-loss-weight", "0.25",
              "--shared-contrast", "0.5", "--vel-std", "2", "--vel-res", "8", "--lr", "1e-3",
              "--cache-device", "--device", "cpu"]
    whole = str(tmp_path / "whole")
    train_cli.main([*common, "--epochs", "2", "--steps-per-dispatch", "2", "--model-dir", whole])
    uninterrupted = list(picks)
    picks.clear()
    resumed = str(tmp_path / "resumed")
    train_cli.main([*common, "--epochs", "1", "--steps-per-dispatch", "2",
                    "--model-dir", resumed])
    train_cli.main([*common, "--epochs", "2", "--init-weights", "latest",
                    "--model-dir", resumed])
    # the single-step run's probe of step 0 of the stream is not a step
    assert len(uninterrupted) == len(picks) == 4
    for a, b in zip(picks, uninterrupted):
        np.testing.assert_array_equal(a, b)
    path = os.path.join(whole, "00002.npz")
    ours = modelio.read_checkpoint(path)[2]
    again = modelio.read_checkpoint(os.path.join(resumed, "00002.npz"))[2]
    for key, val in ours.items():
        np.testing.assert_array_equal(again[key], val, err_msg=key)

    model = modelio.load_model(path, device="cpu")
    jm, jparams = jax_load_model(path)
    assert type(jm).__name__ == "SynthMorphDense" and isinstance(model,
                                                                 synthmorph.SynthMorphDense)
    assert model.cfg.to_dict() == jm.cfg.to_dict()
    assert list(model.cfg.out_label_list) == [2, 3, 7]  # 12 is in no map
    assert (jm.shared_contrast, jm.sup_flow, jm.int_steps) == (0.5, False, 2)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(ours)
    for key, val in ((("||".join(k.key for k in p)), v) for p, v in flat):
        np.testing.assert_array_equal(np.asarray(val), ours[key], err_msg=key)

    with pytest.raises(SystemExit, match="requires --same-subj"):
        train_cli.main([*common, "--epochs", "1", "--sup-flow-weight", "0.1",
                        "--model-dir", str(tmp_path / "refused")])


def test_register_and_test_clis_serve_a_synthmorph_checkpoint(tmp_path, capsys):
    """A SynthMorphDense checkpoint (flow head redrawn) through cli/register
    and cli/test: the warp and moved image of scripts/register.py, the Dice
    of scripts/test.py."""
    model = _small_model(flow_std=0.3)
    path = str(tmp_path / "synth.npz")
    modelio.save_model(path, model)
    files = []
    for i, lab in enumerate(label_maps(13, 2, SHAPE, LABELS)[..., 0]):
        vol = synthmorph.labels_to_image(torch.Generator().manual_seed(i),
                                         torch.from_numpy(lab[None, ..., None]),
                                         model.cfg)[0][0, ..., 0].numpy()
        files.append(str(tmp_path / f"scan{i}.npz"))
        np.savez(files[-1], vol=vol, seg=lab)
    outputs = {}
    for name, main in (("jax", _script("register").main), ("port", register_cli.main)):
        args = ["--moving", files[0], "--fixed", files[1], "--model", path,
                "--moved", str(tmp_path / f"{name}_moved.nii.gz"),
                "--warp", str(tmp_path / f"{name}_warp.nii.gz")]
        main(args + (["--device", "cpu"] if name == "port" else []))
        outputs[name] = [load_volfile(str(tmp_path / f"{name}_{k}.nii.gz"))
                         for k in ("moved", "warp")]
    assert np.abs(outputs["jax"][1]).max() >= MIN_FLOW
    for ours, ref, key in zip(outputs["port"], outputs["jax"], ("moved", "warp")):
        assert_rel_close(ours, ref, OUT_RTOL, key)

    (tmp_path / "pairs.txt").write_text(f"{files[0]} {files[1]}\n{files[1]} {files[0]}\n")
    args = ["--model", path, "--pairs", str(tmp_path / "pairs.txt"), "--img-suffix", "",
            "--seg-prefix", ""]
    _script("test").main(args)
    ref = [ln.split("Dice: ")[1] for ln in capsys.readouterr().out.splitlines() if "Dice:" in ln]
    scores = test_cli.main([*args, "--device", "cpu"])
    ours = [ln.split("Dice: ")[1] for ln in capsys.readouterr().out.splitlines()
            if "Dice:" in ln]
    assert len(scores) == 2 and len(ours) == len(ref) == 3
    assert ours == ref
