"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` for Hopper (sm_90a) into
``_build/lib<name>.so``, a shared library with a plain C interface that
``ctypes`` loads. A library is rebuilt only when it is older than its source,
the shared headers of ``csrc/`` or this file.

Nothing is built when the package is imported: the first wrapper call on a
CUDA tensor builds what it needs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["NVCC_FLAGS", "SOURCES", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel sources of the package, by library name.
SOURCES = {"warp_bounded": _SRC / "warp_bounded.cu"}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "voxelmorph_tpu_torch are built at first use with nvcc")


def _library(name: str) -> Path:
    return _OUT / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _library(name)
    if not lib.is_file():
        return True
    deps = [SOURCES[name], Path(__file__).resolve(), *_SRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are out of date.

    Returns the compiler's output (``-Xptxas -v`` register and shared-memory
    report) by library name for each library it built. Raises RuntimeError
    naming the source that failed.
    """
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    _OUT.mkdir(exist_ok=True)
    logs = {}
    for name in todo:
        # compile to a private name and rename, so that concurrent builds
        # never load a half-written library
        tmp = _OUT / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {SOURCES[name].name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, _library(name))
        logs[name] = proc.stdout
    return logs


def load(name: str) -> ctypes.CDLL:
    """Build the kernel ``name`` if needed and return its loaded library."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        _LOADED[name] = lib
    return lib
