"""The PyTorch port stands alone: no JAX, no JAX package, GPU by default.

The port and chip_smoke.py must import with JAX, flax, optax, nibabel and
voxelmorph_tpu all refused, so that they run where none of them is installed.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nibabel", "voxelmorph_tpu")
CHECKPOINT = ROOT / "artifacts_r4" / "probs_ncc_0050.npz"


def _port_files():
    files = sorted((ROOT / "voxelmorph_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _run(code, cwd=ROOT, **kw):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_port_imports_with_jax_refused():
    modules = [_module_name(p) for p in _port_files()]
    code = f"""
import importlib, sys
FORBIDDEN = {FORBIDDEN!r}
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"refused import of {{name}}")
        return None
sys.meta_path.insert(0, Refuse())
for m in {modules!r}:
    importlib.import_module(m)
loaded = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not loaded, loaded
print("imported", len({modules!r}))
"""
    res = _run(["-c", code])
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"imported {len(modules)}" in res.stdout


@pytest.mark.parametrize("path", _port_files(), ids=_module_name)
def test_port_source_names_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the GPU default runs")
    from voxelmorph_tpu_torch.cli import register as register_cli
    from voxelmorph_tpu_torch.models.modelio import load_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(str(CHECKPOINT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        register_cli.main(["--moving", str(CHECKPOINT), "--fixed", str(CHECKPOINT),
                           "--model", str(CHECKPOINT), "--moved", "unused.nii.gz"])


ATLAS_CLIS = {
    "train_instance": ["--moving", "m.npz", "--fixed", "f.npz", "--moved", "o.nii.gz"],
    "train_template": ["--img-list", "list.txt"],
    "train_cond_template": ["--img-list", "list.txt", "--pheno-csv", "pheno.csv"],
    "train_unsupervised_seg": ["--img-list", "list.txt", "--atlas", "atlas.npz"],
    "test_unsupervised_seg": ["image.npz", "seg.nii.gz", "--model", "m.npz", "--atlas",
                              "atlas.npz", "--mapping", "map.npy"],
    "train_synthmorph": ["--label-dir", "maps/"],
}


@pytest.mark.parametrize("name", sorted(ATLAS_CLIS))
def test_atlas_clis_default_to_the_gpu(name):
    """The CLIs of the atlas, instance and SynthMorph models refuse to start
    without a GPU unless --device cpu is given, before they read any file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the GPU default runs")
    import importlib
    cli = importlib.import_module(f"voxelmorph_tpu_torch.cli.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(ATLAS_CLIS[name])


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs there")
    res = _run([str(ROOT / "chip_smoke.py")])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
