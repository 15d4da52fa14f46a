"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (run_cell on the CPU, the port's plain
versions, the small coarse cell, each cloud against a copy of itself), one
fault of portbench/faults.py is planted in the program per case, and the
compared number that covers the faulted layer is over its limit. Batch size
1 and one chip: the cell cannot leave half a batch out or skip an exchange
between chips, and it keeps no state from step to step."""

import pytest
import torch

from portbench import faults, run
from portbench.tests import helpers

torch.set_num_threads(2)


@pytest.mark.parametrize("fault,number", [
    ("transform", "transform_inlier_gap"),
    ("backbone", "backbone_mean_rel"),
    ("neighbour", "neighbor_mismatch"),
    ("point", "points_gap"),
])
def test_a_planted_fault_is_not_correct(fault, number, monkeypatch):
    helpers.self_pairs(monkeypatch)
    with faults.FAULTS[fault]():
        result = run.run_cell(helpers.coarse_cell(), 2**31 + 21, 0.2, False, device="cpu")
    assert not result["correct"], result["checks"]
    assert result["checks"][number]["value"] > result["checks"][number]["limit"], result["checks"]
