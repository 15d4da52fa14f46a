"""Small tensor ops (port of gaussreg_tpu/ops/misc.py)."""

from __future__ import annotations

import math

import torch


def index_select(values: torch.Tensor, indices: torch.Tensor, axis: int = 0):
    """N-d gather: output shape = values.shape[:axis] + indices.shape +
    values.shape[axis+1:]."""
    flat = torch.index_select(values, axis, indices.reshape(-1))
    shape = values.shape[:axis] + indices.shape + values.shape[axis + 1 :]
    return flat.reshape(shape)


def vector_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between vectors via atan2(|a x b|, a.b)."""
    cross = torch.linalg.cross(a, b, dim=-1)
    sin = torch.linalg.norm(cross, dim=-1)
    cos = torch.sum(a * b, dim=-1)
    return torch.atan2(sin, cos)


def deg2rad(x):
    return x * math.pi / 180.0


def rad2deg(x):
    return x * 180.0 / math.pi
