"""Weighted Procrustes / Umeyama similarity estimation
(port of gaussreg_tpu/ops/procrustes.py).

Rotations come from Horn's quaternion method (the dominant eigenvector of
the 4x4 Davenport matrix by 8 normalized squarings), as on the JAX hot
path; `_svd_rotation` (torch.linalg.svd with the det fix) is its oracle
twin for the tests.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gaussreg_tpu_torch.ops.transforms import transform_from_rotation_translation


def _weighted_stats(src, ref, weights, weight_thresh, eps):
    w = torch.where(weights < weight_thresh, 0.0, weights)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + eps)
    w = w[..., None]  # (..., N, 1)
    src_centroid = torch.sum(src * w, dim=-2, keepdim=True)
    ref_centroid = torch.sum(ref * w, dim=-2, keepdim=True)
    src_c = src - src_centroid
    ref_c = ref - ref_centroid
    h = torch.einsum("...ni,...nj->...ij", src_c, w * ref_c)
    return w, src_centroid, ref_centroid, src_c, ref_c, h


def _svd_rotation(h):
    """R maximizing trace(R H) with det(R) = +1, from H = U S V^T."""
    u, s, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.ones_like(s)
    d[..., -1] = torch.sign(det)
    return (v * d[..., None, :]) @ ut


def _horn_rotation(h):
    """R maximizing trace(R H) with det(R) = +1 (Horn's quaternion method)."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    n4 = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
        ],
        -2,
    )
    fro = torch.sqrt(torch.sum(h * h, dim=(-2, -1), keepdim=True))
    eye4 = torch.eye(4, dtype=h.dtype, device=h.device)
    k = n4 + (math.sqrt(3.0) * fro + 1e-12) * eye4
    for _ in range(8):
        k = k @ k
        k = k / torch.sqrt(torch.sum(k * k, dim=(-2, -1), keepdim=True) + 1e-30)
    idx = torch.argmax(torch.sum(k * k, dim=-2), dim=-1)
    q = torch.gather(k, -1, idx[..., None, None].expand(k.shape[:-1] + (1,)))[..., 0]
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-30)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
        ],
        -2,
    )


def weighted_procrustes(
    src_points: torch.Tensor,
    ref_points: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    weight_thresh: float = 0.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Weighted rigid Procrustes: (..., 4, 4) transforms mapping src -> ref."""
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=src_points.dtype, device=src_points.device)
    _, src_centroid, ref_centroid, _, _, h = _weighted_stats(
        src_points, ref_points, weights, weight_thresh, eps
    )
    h = h + 1e-9 * torch.eye(3, dtype=h.dtype, device=h.device)
    r = _horn_rotation(h)
    t = ref_centroid[..., 0, :] - torch.einsum("...ij,...j->...i", r, src_centroid[..., 0, :])
    return transform_from_rotation_translation(r, t)


def umeyama_similarity(
    src_points: torch.Tensor,
    ref_points: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    with_scale: bool = True,
    weight_thresh: float = 0.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Weighted Umeyama similarity: (..., 4, 4) transforms whose 3x3 block
    is s*R."""
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=src_points.dtype, device=src_points.device)
    w, src_centroid, ref_centroid, src_c, _, h = _weighted_stats(
        src_points, ref_points, weights, weight_thresh, eps
    )
    h = h + 1e-9 * torch.eye(3, dtype=h.dtype, device=h.device)
    r = _horn_rotation(h)
    if with_scale:
        var_src = torch.sum(w[..., 0] * torch.sum(src_c * src_c, dim=-1), dim=-1)
        # sum of det-corrected singular values = max trace(R H)
        scale = torch.einsum("...ij,...ji->...", r, h) / torch.clamp_min(var_src, eps)
    else:
        scale = torch.ones(h.shape[:-2], dtype=h.dtype, device=h.device)
    sr = r * scale[..., None, None]
    t = ref_centroid[..., 0, :] - torch.einsum("...ij,...j->...i", sr, src_centroid[..., 0, :])
    return transform_from_rotation_translation(sr, t)
