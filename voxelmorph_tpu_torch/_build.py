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
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["NVCC_FLAGS", "SOURCES", "build", "entry_point", "library_path", "load",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel sources of the package, by library name.
SOURCES = {"warp_bounded": _SRC / "warp_bounded.cu", "warp_gather": _SRC / "warp_gather.cu",
           "conv3": _SRC / "conv3.cu"}

_LOADED: Dict[str, ctypes.CDLL] = {}
_ENTRY_POINTS: Dict[Tuple[str, str], Any] = {}


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


def library_path(name: str) -> Path:
    """Where the kernel library ``name`` is built."""
    return _OUT / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.is_file():
        return True
    deps = [SOURCES[name], Path(__file__).resolve(), *_SRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are out of date, one
    nvcc process for each source, all started together.

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
    # compile to private names and rename, so that concurrent builds never
    # load a half-written library
    tmps = {name: _OUT / f".lib{name}.{os.getpid()}.so" for name in todo}
    procs = {name: subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmps[name]), str(SOURCES[name])],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in todo}
    logs, failed = {}, []
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmps[name].unlink(missing_ok=True)
            failed.append(f"nvcc failed for {SOURCES[name].name} "
                          f"(exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmps[name], library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """Build the kernel ``name`` if needed and return its loaded library."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def entry_point(name: str, symbol: str, argtypes: List[Any]):
    """The C function ``symbol`` of the kernel library ``name``, built and
    loaded at first use, with ``argtypes`` set and an int result. Looked up
    once: a launch calls the cached function."""
    fn = _ENTRY_POINTS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRY_POINTS[(name, symbol)] = fn
    return fn
