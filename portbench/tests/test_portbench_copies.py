"""The benchmark's frozen copies equal the port's originals today: the
traffic generator and the stage attribution."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import trace

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,n,tier", [(0, 2000, "easy"), (2**31 + 5, 1500, "hard"),
                                         (77, None, "easy")])
def test_random_pair_equals_the_ports(seed, n, tier):
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.synthetic import random_pair as original

    from portbench.gen.synthetic import random_pair

    cfg = make_tiny_cfg()
    a = original(cfg, seed, num_points=n, tier=tier)
    b = random_pair(dataclasses.asdict(cfg), seed, num_points=n, tier=tier)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _events():
    """A chrome trace: two stage ranges on the host, their launches and
    kernels, one uncorrelated kernel inside the second window, one outside."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "backbone", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "RANSAC", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 1, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 21, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 25, "dur": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 5, "dur": 3000,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 4000, "dur": 1000,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_ctypes", "ts": 5100, "dur": 500, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "k_c", "ts": 6000, "dur": 2000,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k_out", "ts": 9000, "dur": 100, "args": {}},
    ]


def test_stage_attribution_equals_the_ports():
    from gaussreg_tpu_torch.tools.profiling import attribute as original

    busy, stages, by_name, on_device = original(_events())
    ops = trace.attribute(_events(), ("backbone", "RANSAC"))
    assert on_device
    assert {s: sum(v.values()) for s, v in ops.items()} == pytest.approx(stages)
    assert ops["RANSAC"]["k_ctypes"] == pytest.approx(0.5)
    t = trace.reduce(_events(), ["backbone", "RANSAC"], 1, 0.01)
    assert t.busy_s == pytest.approx(busy / 1e3)
    assert t.kernel_ms("k_") == pytest.approx(sum(ms for ms, _ in by_name.values()))
    gaps = dict(t.breakdown["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((9100 - 5 - 6600) / 1e6)


