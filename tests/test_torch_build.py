"""The kernel build module of the PyTorch port, with a stand-in compiler.

The real build needs nvcc and a GPU and runs in chip_smoke.py; these tests
check the build module's own logic: output renamed into place only on
success, no rebuild of an up-to-date library,
and a failure that names its source.
"""

import os
import stat
import sys

import pytest

from voxelmorph_tpu_torch import _build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "{fail}" == "1":
    print("error: stand-in compiler refused " + args[-1])
    sys.exit(2)
open(out, "w").write("library")
print("ptxas info    : Used 40 registers")
"""


def _fake_nvcc(tmp_path, monkeypatch, fail=False):
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC.format(python=sys.executable, fail=int(fail)))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(path))
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "_OUT", out)
    return out


def test_build_compiles_once_and_skips_fresh_libraries(tmp_path, monkeypatch):
    out = _fake_nvcc(tmp_path, monkeypatch)
    logs = _build.build()
    assert sorted(logs) == sorted(_build.SOURCES)
    assert "registers" in logs["warp_bounded"]
    lib = out / "libwarp_bounded.so"
    assert lib.read_text() == "library"
    assert sorted(p.name for p in out.iterdir()) == ["libwarp_bounded.so"]
    assert _build.build() == {}
    # a library older than its source is rebuilt
    old = os.stat(_build.SOURCES["warp_bounded"]).st_mtime - 10
    os.utime(lib, (old, old))
    assert sorted(_build.build()) == ["warp_bounded"]


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    out = _fake_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="warp_bounded.cu.*exit 2"):
        _build.build(["warp_bounded"], force=True)
    assert list(out.iterdir()) == []


def test_nvcc_flags_target_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
