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
    assert sorted(p.name for p in out.iterdir()) == sorted(f"lib{n}.so" for n in _build.SOURCES)
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


def test_build_rebuilds_after_a_shared_header_changes(tmp_path, monkeypatch):
    """A library newer than its source and the build module but older than a
    header of csrc/ (where tensor_core.cuh lives) is rebuilt."""
    _fake_nvcc(tmp_path, monkeypatch)
    _build.build(["conv3"])
    assert _build.build(["conv3"]) == {}
    headers = tmp_path / "csrc"
    headers.mkdir()
    (headers / "shared.cuh").write_text("// a header")
    monkeypatch.setattr(_build, "_SRC", headers)
    newest = max(os.stat(p).st_mtime for p in (_build.SOURCES["conv3"], _build.__file__))
    lib = _build.library_path("conv3")
    os.utime(lib, (newest + 1, newest + 1))
    os.utime(headers / "shared.cuh", (newest + 2, newest + 2))
    assert sorted(_build.build(["conv3"])) == ["conv3"]


def test_entry_point_is_looked_up_once(monkeypatch):
    """A kernel's C function comes back with its argument types set, and the
    same object on every later call (no lookup per launch)."""
    import ctypes
    loads = []

    def load(name):
        loads.append(name)
        return ctypes.CDLL(None)  # the process's own symbols

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_ENTRY_POINTS", {})
    fn = _build.entry_point("libc", "abs", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert fn(-7) == 7
    assert _build.entry_point("libc", "abs", [ctypes.c_int]) is fn
    assert loads == ["libc"]
