"""A run of a cell on the CPU at 16^3, for the tests: the harness's look for
a card is skipped and everything else of a run is driven, optionally with
the timed path broken underneath (``FAULTS``). Run as a script, it is one
rank of a data-parallel run over gloo:

    python h100_bench/tests/cpu_run.py <cell> <rank> <world> <port> <fault>

and rank 0 prints the result's fields as JSON.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from h100_bench import harness  # noqa: E402

TINY = {"model": {"inshape": [16, 16, 16]},
        "traffic": {"stack": 4, "sample_from": 2, "sample_calls": 2}}


def state_unchanged(trainer):
    """Each step's update undone: the step returns its state unchanged."""
    step = trainer.train_step

    def frozen(*args, **kwargs):
        saved = [p.detach().clone() for p in trainer.model.parameters()]
        out = step(*args, **kwargs)
        with torch.no_grad():
            for p, s in zip(trainer.model.parameters(), saved):
                p.copy_(s)
        return out

    trainer.train_step = frozen
    return trainer


def half_batch(trainer):
    """Each step on the first half of its rows, the mean over those."""
    step = trainer.train_step

    def half(inputs, targets):
        h = max(int(inputs[0].shape[0]) // 2, 1)
        return step([x[:h] for x in inputs], [y[:h] for y in targets])

    trainer.train_step = half
    return trainer


def no_exchange(trainer):
    """DDP's gradient buckets kept as each rank computed them."""
    def local(_, bucket):
        fut = torch.futures.Future()
        fut.set_result(bucket.buffer())
        return fut

    trainer.ddp.register_comm_hook(None, local)
    return trainer


def answer_altered(register):
    """The first scan's warp shifted by a voxel where the call produces it."""
    def altered(moving, fixed):
        moved, warp = register(moving, fixed)
        warp = warp.clone()
        warp[0] += 1.0
        return moved, warp

    return altered


def half_served(register):
    """Only the first half of a call's scans registered; their answers
    stand in for the rest."""
    def half(moving, fixed):
        h = moving.shape[0] // 2
        moved, warp = register(moving[:h], fixed[:h])
        return torch.cat([moved, moved]), torch.cat([warp, warp])

    return half


FAULTS = {"none": None, "state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "answer_altered": answer_altered,
          "half_served": half_served}


def run(cell: str, seed: int = 20231, fault: str = "none", rank: int = 0, world: int = 1,
        port: int = 0, seconds: float = 0.5, traced: bool = False) -> dict:
    sys.path.insert(0, str(ROOT / "h100_bench"))
    import run as bench_run
    torch.set_num_threads(2)
    ctx = bench_run.Context(harness.Cell(cell), seed, seconds, traced, "cpu", rank, world,
                            port, time.perf_counter(), TINY, FAULTS[fault])
    return bench_run.execute(ctx)


if __name__ == "__main__":
    name, rank, world, port, fault = sys.argv[1:6]
    out = run(name, fault=fault, rank=int(rank), world=int(world), port=int(port))
    if int(rank) == 0:
        print(json.dumps({"correct": out["correct"],
                          "checks": {c.name: c.value for c in out["checks"]}}))
