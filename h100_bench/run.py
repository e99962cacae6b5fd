"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` runs the same window under the profiler and reports
its per-layer metrics. Both decide ``correct`` by comparing what the window
produced with the plain reference (``reference/``). A cell on several chips
runs one process a card: this process is rank 0 and starts the others.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
from pathlib import Path


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


class Context:
    """What a runner reads of its run: the cell, the seeds, the window's
    length, whether it is traced, the device, this process's rank among
    ``world``, the process group's port, the process's start, and (for the
    tests) ``overrides`` of sizes and a ``fault_hook`` that may replace the
    program's Trainer or register function."""

    def __init__(self, cell, seed, seconds, traced, device="cuda", rank=0, world=1, port=0,
                 t_start=0.0, overrides=None, fault_hook=None):
        from h100_bench import harness
        self.cell, self.seeds, self.seconds, self.trace = cell, harness.Seeds(seed), seconds, traced
        self.device, self.rank, self.world, self.port = device, rank, world, port
        self.t_start, self.overrides = t_start, overrides or {}
        self.fault_hook = fault_hook or (lambda x: x)

    def gather(self, run, peak: int):
        """This rank's per-layer readings, peak memory and forbidden
        modules, gathered from every rank (a list in rank order)."""
        import torch.distributed as dist
        from h100_bench import harness, trace
        item = {"peak": int(peak), "forbidden": harness.forbidden_modules(), "readings": {}}
        if run.trace is not None:
            for m in self.cell.per_layer:
                value = self.cell.reader(m["name"]).read(run)
                if value is not None:
                    item["readings"][m["name"]] = float(value)
            item["busy_s"], item["window_s"] = run.trace.busy_s, run.trace.window_s
            if self.rank == 0:
                item["breakdown"] = trace.breakdown(run.trace)
        if self.world == 1:
            return [item]
        out = [None] * self.world
        dist.all_gather_object(out, item)
        dist.barrier()
        dist.destroy_process_group()
        return out


def reported_as(metric: str, values) -> str:
    """The runner's quantity that an end-to-end metric reports: the longest
    of ``values``' names that ends the metric's name (``pairs_per_s`` for
    ``train_pairs_per_s``), so that a cell's entry in ``BENCHMARK.json``
    names its metrics and no runner does."""
    names = [k for k in values if metric == k or metric.endswith("_" + k)]
    if not names:
        raise KeyError(f"the runner reports nothing for {metric!r} (has {sorted(values)})")
    return max(names, key=len)


def execute(ctx) -> dict:
    """Run the cell's runner and turn what it returns into the result line's
    fields (rank 0; an empty dict on the others)."""
    from h100_bench import harness
    got = ctx.cell.runner().run(ctx)
    if ctx.rank:
        return {}
    gathered = got["gathered"]
    found = harness.checks(got["gaps"], ctx.cell.spec["limits"])
    correct = all(c.ok for c in found)
    failed = got.get("failed_calls", 0) + (0 if correct else 1)
    metrics, device = {}, {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
                           "count": ctx.cell.chips,
                           "memory_peak_bytes": max(g["peak"] for g in gathered)}
    if ctx.device == "cuda":
        import torch
        device["kind"] = torch.cuda.get_device_name(0)
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    breakdown = None
    if ctx.trace:
        names = [m["name"] for m in ctx.cell.per_layer]
        for name in names:
            values = [g["readings"][name] for g in gathered if name in g["readings"]]
            if values:
                metrics[name] = {"value": sum(values) / len(values), "unit": units[name]}
        device["busy_s"] = sum(g["busy_s"] for g in gathered) / len(gathered)
        device["window_s"] = sum(g["window_s"] for g in gathered) / len(gathered)
        breakdown = gathered[0].get("breakdown")
    else:
        values = dict(got["rate"], setup_s=got["setup_s"])
        for m in ctx.cell.end_to_end:
            metrics[m["name"]] = {"value": values[reported_as(m["name"], values)],
                                  "unit": m["unit"]}
    forbidden = sorted({f for g in gathered for f in g["forbidden"]}
                       | set(harness.forbidden_modules()))
    return {"correct": correct, "attempted": got["attempted"], "failed": failed,
            "metrics": metrics, "device": device, "checks": found, "breakdown": breakdown,
            "forbidden": forbidden}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    args = _args(argv)
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from h100_bench import harness
    t_start = harness.process_start()
    cell = harness.Cell(args.workload)
    import torch
    # one host thread for torch's CPU work: the cells' host work is serial,
    # and idle pool threads only contend with it for the host's cores
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    world = cell.chips
    ranks = []
    if world > 1 and args.rank == 0:
        # build the port's kernels once here, not in every rank at once
        from voxelmorph_tpu_torch import _build
        _build.build()
        args.port = _free_port()
        base = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                "--seed", str(args.seed), "--seconds", str(args.seconds),
                "--trace", str(args.trace), "--port", str(args.port)]
        ranks = [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.DEVNULL)
                 for r in range(1, world)]
    try:
        out = execute(Context(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              args.rank, world, args.port, t_start))
        for p in ranks:
            if p.wait(timeout=300) != 0:
                raise RuntimeError(f"rank process {p.args[-1]} exited with {p.returncode}")
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    if args.rank:
        return 0
    if out["forbidden"]:
        harness.log(f"forbidden modules were loaded: {', '.join(out['forbidden'])}")
        return 4
    for c in out["checks"]:
        harness.log(f"check {c.name} {c.value!r} limit {c.limit!r} "
                    f"{'ok' if c.ok else 'OVER'}")
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                              out["device"], out["checks"], out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
