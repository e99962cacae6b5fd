"""Runs of every cell on the CPU at 16^3 (the harness's look for a card
skipped, everything else driven): the reference agrees with the port, so a
sound run is correct; with the timed path broken underneath by each fault
the cell can have, ``correct`` comes out false."""

import json
import socket
import subprocess
import sys

import pytest

from h100_bench.tests import cpu_run

SINGLE = [("vxm-train-f32", "none", True), ("vxm-train-f32", "state_unchanged", False),
          ("synthmorph-train-f32", "none", True),
          ("synthmorph-train-f32", "state_unchanged", False),
          ("vxm-register-bf16", "none", True), ("vxm-register-bf16", "answer_altered", False),
          ("vxm-register-bf16", "half_served", False),
          # the data-parallel cell's global batch in one process
          ("vxm-train-dp4", "none", True), ("vxm-train-dp4", "half_batch", False),
          ("vxm-train-dp4", "state_unchanged", False)]


@pytest.mark.parametrize("cell,fault,correct", SINGLE)
def test_a_run_is_correct_unless_broken(cell, fault, correct):
    out = cpu_run.run(cell, fault=fault)
    assert out["correct"] is correct, {c.name: c.value for c in out["checks"]}
    assert out["attempted"] > 0 and not out["forbidden"]


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault,correct", [("none", True), ("no_exchange", False)])
def test_four_ranks_over_gloo(fault, correct):
    port = _port()
    procs = [subprocess.Popen([sys.executable, cpu_run.__file__, "vxm-train-dp4", str(r), "4",
                               str(port), fault], stdout=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    got = json.loads(outs[0].strip().splitlines()[-1])
    assert got["correct"] is correct, got


def test_a_traced_run_reads_its_window():
    out = cpu_run.run("vxm-register-bf16", traced=True)
    assert out["correct"] and out["device"]["window_s"] > 0
    assert "dispatch_ms.serve" in out["metrics"]
