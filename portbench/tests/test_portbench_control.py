"""The control of the cell's comparison comes out not correct: the plain
reference computed in TF32 (the nearest precision below the configuration's
float32 with TF32 off) and put in the program's place fails at least one of
the cell's limits. On the card only (TF32 exists there alone), at the
cell's own sizes, on one seed; PERF.md gives the readings on more."""

import pytest

from portbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["indoor_pairs"])
def test_the_control_is_not_correct(workload, card):
    from portbench import run

    run._environment(spec.PKG)
    cell = spec.load_cell(workload)
    nums = cell.runner().Runner(cell, 2**31 + 3, card).control()
    failed = [k for k, limit in cell.traffic["limits"].items() if nums.get(k, 0.0) > limit]
    assert failed, nums
