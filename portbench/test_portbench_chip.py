"""On the card only (the ``cuda_device`` fixture skips elsewhere): one short
run of each cell at its own size is correct, and the control is not."""

import pytest

from portbench import harness
from portbench.reference.precision import control

CELLS = ["n1000-train", "paper-case2-train", "n1000-knn", "n1000-conn"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda_device, name):
    cell = harness.Cell.find(name)
    res = harness.run_cell(cell, 2**31 + 101, 1.0, False, cuda_device)
    assert res["correct"] and res["device"]["platform"] == "gpu", res["checks"]
    ctl = harness.run_cell(cell, 2**31 + 102, 1.0, False, cuda_device,
                           control=control(cell.config["dtype"]))
    assert not ctl["correct"], ctl["checks"]
