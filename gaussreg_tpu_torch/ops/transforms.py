"""SE(3)+scale transform algebra (port of gaussreg_tpu/ops/transforms.py).

A "transform" is a (..., 4, 4) matrix whose top-left 3x3 block may carry an
isotropic scale (s*R). Only the helpers the coarse-registration path uses
are ported here; quaternion and SH-rotation helpers belong to the fusion
slice.
"""

from __future__ import annotations

import torch


def apply_transform(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) or batched (..., 4, 4) transform to (..., N, 3) points
    (points @ R^T + t)."""
    rotation = transform[..., :3, :3]
    translation = transform[..., :3, 3]
    if transform.dim() == 2:
        return points @ rotation.T + translation
    return torch.einsum("...ij,...nj->...ni", rotation, points) + translation[..., None, :]


def transform_from_rotation_translation(
    rotation: torch.Tensor, translation: torch.Tensor
) -> torch.Tensor:
    """Compose (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch_shape = rotation.shape[:-2]
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype, device=rotation.device
    ).expand(batch_shape + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotation_translation_scale_from_transform(transform: torch.Tensor):
    """Decompose a similarity transform into (R, t, s); s = norm of the first
    row of the 3x3 block."""
    a = transform[..., :3, :3]
    scale = torch.sqrt(torch.sum(a[..., 0, :] * a[..., 0, :], dim=-1))
    rotation = a / scale[..., None, None]
    translation = transform[..., :3, 3] / scale[..., None]
    return rotation, translation, scale
