"""Helpers the runners share."""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np


def sub_seed(seed: int, *key: int) -> int:
    """A 32-bit seed drawn from the run's seed (any size) and a key."""
    return int(np.random.SeedSequence([int(seed), *key]).generate_state(1)[0])


def sample(seed: int, population: int, k: int) -> List[int]:
    """k distinct indices of range(population), drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5A]))
    return sorted(int(i) for i in rng.choice(population, size=min(k, population), replace=False))


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class Clock:
    """The window's host clock: calls are timed back to back, each ending in
    a device sync."""

    def __init__(self):
        self.start = time.perf_counter()
        self.latencies: List[float] = []
        self.end = self.start

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def record(self, t0: float) -> float:
        self.end = time.perf_counter()
        self.latencies.append(self.end - t0)
        return self.end - self.start

    @property
    def seconds(self) -> float:
        return self.end - self.start


def percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def worst(acc: Dict[str, float], nums: Dict[str, float]) -> None:
    for k, v in nums.items():
        acc[k] = max(acc.get(k, float("-inf")), v)
