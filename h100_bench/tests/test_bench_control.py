"""The control on the card: the plain reference in the next precision below
the cell's, put in the program's place, comes out over the cell's limits. At
80x96x112, half of each axis, so that a test run holds it; ``control.py``
reads the same at the cells' own size."""

import pytest

from h100_bench import control, harness


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.read_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]])
def test_the_control_fails_the_comparison(card, cell):
    limits = harness.Cell(cell).spec["limits"]
    got = control.read(cell, 7, (80, 96, 112))[0]
    assert any(not got[k] <= limits[k] for k in limits), got
