"""The benchmark's common machinery: finding a cell's files by name, the
seeds drawn from ``--seed``, the run's start time, the result line and the
checks that no JAX module was loaded.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``, the ``file`` of its entry) and a
traffic mix (``traffic/<traffic>.json``); the mix names the runner
(``runners/<runner>.py``) that runs the program on it, and the cell's own
file (``workloads/<cell>.json``) holds the limits of its comparison with
the reference. Each per-layer metric is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules that no run may load, compared whole (the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "voxelmorph_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules in this process's ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """This process's start, on ``time.perf_counter``'s clock (to the
    kernel's clock tick)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)


class Seeds:
    """Independent seeds of a run, drawn from ``--seed`` (any integer):
    ``data`` for the inputs and weights, ``picks`` for the pairs' stream,
    ``trainer`` for the program's sampling generator, ``sample`` for which
    answers are compared."""

    def __init__(self, seed: int):
        seed = int(seed)
        ss = np.random.SeedSequence([abs(seed) % 2 ** 64, abs(seed) >> 64, int(seed < 0)])
        self.data, self.picks, self.trainer, self.sample = (
            int(x) for x in ss.generate_state(4, np.uint32))


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module ``name`` (file names may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(name, str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """Everything a run of one cell reads, found by its name."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = bench or read_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(ROOT / self.config_entry["file"])
        self.traffic = read_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.spec = read_json(BENCH_DIR / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def runner(self) -> ModuleType:
        return load_module(BENCH_DIR / "runners" / f"{self.traffic['runner']}.py",
                           f"h100_bench_runner_{self.traffic['runner']}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                           "h100_bench_metric_" + metric.replace(".", "_"))


class RunData:
    """What a per-layer metric's reader reads of one rank's run: ``trace``
    (a ``trace.Trace``, or None in an untraced run), the work of the window
    over every rank (``steps``, ``pairs``, ``calls``), its ``window_s``,
    ``world`` and ``rank``, the cell's ``dtype``, configuration, traffic and
    model sizes, and ``dispatch_s`` (the host time of each serving call's
    enqueue)."""

    def __init__(self, trace=None, steps=0, pairs=0, calls=0, window_s=0.0, world=1, rank=0,
                 dtype="float32", config=None, traffic=None, model=None, dispatch_s=()):
        self.trace, self.steps, self.pairs, self.calls = trace, steps, pairs, calls
        self.window_s, self.world, self.rank, self.dtype = window_s, world, rank, dtype
        self.config, self.traffic, self.model = config or {}, traffic or {}, model or {}
        self.dispatch_s = list(dispatch_s)


class Check:
    """One number compared with its limit: the run is correct where every
    check's value is at most its limit (a NaN is not)."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


def checks(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    return [Check(k, values[k], limits[k]) for k in limits]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict],
                device: Dict, found: List[Check], breakdown: Optional[Dict] = None) -> str:
    """The run's last line: the keys the contract names, the compared
    numbers last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in found}
    return json.dumps(out)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def mark(t_start: float, what: str):
    """Log the seconds since the run's start at the end of a phase."""
    log(f"[{time.perf_counter() - t_start:8.3f} s] {what}")
