"""The plain reference of the coarse call: its pieces against what they are
defined to compute, and a whole run on the CPU, where the program runs its
kernels' plain versions, against the program."""

import math

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import coarse
from portbench.tests import helpers

torch.set_num_threads(2)


def _rotation(rng):
    q = rng.standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def test_search_keeps_the_nearest_within_the_radius():
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.uniform(0, 1, (50, 3)), dtype=torch.float32)
    s = torch.as_tensor(rng.uniform(0, 1, (300, 3)), dtype=torch.float32)
    found = coarse.Search(q, s, 0.2, 6)
    d = np.linalg.norm(q.numpy()[:, None].astype(np.float64) - s.numpy()[None], axis=-1)
    for i in range(50):
        near = [j for j in np.argsort(d[i], kind="stable") if d[i, j] <= 0.2][:6]
        got = [j for j in found.idx[i].tolist() if j < 300]
        assert got == near
    assert found.mismatch(found.idx) == (0, 0, found.valid())
    moved = found.idx.clone()
    moved[0, 0] = 299 if moved[0, 0] != 299 else 298
    assert found.mismatch(moved)[0] >= 1


def test_centroids_average_each_voxel():
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.04, 0.0, 0.0], [0.1, 0.0, 0.0], [0.12, 0.02, 0.0]])
    c = coarse.centroids(pts, 0.05)
    assert sorted(map(tuple, c.numpy().round(6))) == [(0.02, 0.0, 0.0), (0.11, 0.01, 0.0)]
    assert coarse.level_gap(pts, c.float()[[1, 0]], 0.05) < 1e-7
    assert coarse.level_gap(pts, c.float()[:1], 0.05) == math.inf


@pytest.mark.parametrize("scale", [False, True])
def test_procrustes_recovers_a_transform(scale):
    rng = np.random.default_rng(5)
    src = torch.as_tensor(rng.standard_normal((40, 3)))
    rot, t, s = torch.as_tensor(_rotation(rng)), torch.tensor([0.3, -1.0, 2.0]), 1.7 if scale else 1.0
    ref = s * src @ rot.T + t
    out = coarse.procrustes(src, ref, torch.ones(40), scale)
    assert torch.allclose(out[:3, :3], s * rot, atol=1e-6)
    assert torch.allclose(out[:3, 3], t.double(), atol=1e-5)


def test_ransac_ignores_outliers():
    rng = np.random.default_rng(7)
    src = torch.as_tensor(rng.uniform(-1, 1, (200, 3)), dtype=torch.float32)
    rot = torch.as_tensor(_rotation(rng), dtype=torch.float32)
    ref = 1.3 * src @ rot.T + 0.2
    ref[:60] += torch.as_tensor(rng.uniform(-1, 1, (60, 3)), dtype=torch.float32)
    rs = {"num_iterations_test": 500, "num_points_test": 5, "with_scale": True,
          "distance_threshold": 0.05}
    out = coarse.ransac(src, ref, torch.ones(200, dtype=torch.bool), rs,
                        torch.Generator().manual_seed(1))
    assert torch.allclose(out[:3, :3].float(), 1.3 * rot, atol=1e-4)


def test_sinkhorn_meets_its_marginals():
    rng = np.random.default_rng(9)
    scores = torch.as_tensor(rng.standard_normal((2, 5, 6)), dtype=torch.float32)
    rmask = torch.tensor([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0]], dtype=torch.bool)
    cmask = torch.tensor([[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 1, 0]], dtype=torch.bool)
    plan = coarse.sinkhorn(scores, rmask, cmask, torch.tensor(1.0), 500).exp()
    for b in range(2):
        m, n = int(rmask[b].sum()), int(cmask[b].sum())
        rows = plan[b].sum(dim=1)[:-1][rmask[b]]
        cols = plan[b].sum(dim=0)[:-1][cmask[b]]
        assert torch.allclose(rows, torch.ones(m), atol=1e-3)
        assert torch.allclose(cols, torch.ones(n), atol=1e-3)
        assert float(plan[b, :-1][~rmask[b]].sum()) == 0.0


def test_reference_agrees_with_the_program_on_the_cpu(monkeypatch):
    """Each cloud against a copy of itself (seeded weights agree on no
    transform between two real clouds): the pyramid exactly, the features
    to bfloat16's flips, which random weights amplify, the transforms
    closely."""
    helpers.self_pairs(monkeypatch)
    result = run.run_cell(helpers.coarse_cell(), 2**31 + 11, 0.2, False, device="cpu")
    nums = {k: c["value"] for k, c in result["checks"].items()}
    nums.update(result["readings"])
    assert nums["failed_calls"] == 0
    assert nums["points_gap"] <= 1e-6
    assert nums["neighbor_mismatch"] == 0
    assert nums["backbone_mean_rel"] <= 2e-3
    assert nums["coarse_feats_mean_rel"] <= 2e-3
    assert nums["transformer_mean_rel"] <= 1e-5
    assert nums["corr_miss"] <= 0.05
    assert nums["lgr_rmse"] <= 1e-3
    assert nums["transform_rmse"] <= 1e-3
    assert nums["transform_inlier_gap"] <= 0.0
