"""Small cells for the CPU tests: the coarse cell with the port's
`make_tiny_cfg()` widths, weights drawn from the seed, and small clouds."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.spec import Cell, load_cell


def tiny_config() -> dict:
    from gaussreg_tpu_torch.config import make_tiny_cfg

    doc = dataclasses.asdict(make_tiny_cfg())
    doc["weights"] = None
    # room for every voxel of the tests' 800-point clouds at every level
    doc["capacity"]["levels"] = [1024, 1024, 1024, 512, 256]
    return doc


def coarse_cell() -> Cell:
    cell = load_cell("indoor_pairs")
    cell.config = tiny_config()
    cell.traffic = dict(cell.traffic, num_points=800, pool=2, sample=2, sample_range=3)
    return cell


def self_pairs(monkeypatch) -> None:
    """Make the cell's pairs a cloud against an exact copy of itself, so
    that the seeded weights' features match and the transform (identity)
    is determined; random weights register a real pair to no agreed
    answer."""
    from portbench.gen import synthetic
    from portbench.runners import coarse_pairs

    def pair(cfg, seed, num_points=None, tier="easy"):
        p, f = synthetic.random_pair(cfg, seed, num_points=num_points, tier=tier)[:2]
        return p, f, p.copy(), f.copy(), np.eye(4, dtype=np.float32)

    monkeypatch.setattr(coarse_pairs, "random_pair", pair)
