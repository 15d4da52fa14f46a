"""Pairwise squared distances in gram-matrix form
(port of gaussreg_tpu/ops/pairwise.py)."""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e12


def pairwise_sq_dist(
    x: torch.Tensor, y: torch.Tensor, normalized: bool = False
) -> torch.Tensor:
    """Squared euclidean distance between (..., N, C) and (..., M, C),
    clamped at 0. `normalized` (unit-norm rows) uses 2 - 2 x.y."""
    xy = torch.einsum("...nc,...mc->...nm", x, y)
    if normalized:
        sq = 2.0 - 2.0 * xy
    else:
        x2 = torch.sum(x * x, dim=-1)[..., :, None]
        y2 = torch.sum(y * y, dim=-1)[..., None, :]
        sq = x2 - 2.0 * xy + y2
    return torch.clamp_min(sq, 0.0)


def masked_pairwise_sq_dist(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    y_mask: Optional[torch.Tensor] = None,
    fill: float = _BIG,
) -> torch.Tensor:
    """pairwise_sq_dist with invalid rows/cols set to `fill`."""
    sq = pairwise_sq_dist(x, y)
    if x_mask is not None:
        sq = sq.masked_fill(~x_mask[..., :, None], fill)
    if y_mask is not None:
        sq = sq.masked_fill(~y_mask[..., None, :], fill)
    return sq
