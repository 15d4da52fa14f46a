"""Registration metrics: RRE / RTE / RSE, RMSE, recall, chamfer distance,
inlier and overlap ratios (port of gaussreg_tpu/models/metrics.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.ops.pairwise import masked_pairwise_sq_dist
from gaussreg_tpu_torch.ops.transforms import (
    apply_transform,
    rotation_translation_scale_from_transform,
)


def _inverse_transpose_3x3(a):
    """inv(A)^T = cof(A) / det(A), elementwise float32."""
    c = torch.stack(
        [
            torch.stack(
                [
                    a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
                    a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
                    a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                    a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                    a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
                    a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
                    a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
                ],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    det = a[..., 0, 0] * c[..., 0, 0] + a[..., 0, 1] * c[..., 0, 1] + a[..., 0, 2] * c[..., 0, 2]
    return c / det[..., None, None]


def _orthogonalize(rotation):
    """Nearest rotation (polar factor) of a near-orthogonal 3x3 by three
    Newton steps X <- (X + inv(X)^T) / 2."""
    x = rotation
    for _ in range(3):
        x = 0.5 * (x + _inverse_transpose_3x3(x))
    return x


def relative_rotation_error(gt_rotation, rotation):
    """Degrees; trace(A^T B) taken elementwise."""
    trace = torch.sum(_orthogonalize(rotation) * _orthogonalize(gt_rotation), dim=(-2, -1))
    x = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    return 180.0 * torch.arccos(x) / np.pi


def relative_translation_error(gt_translation, translation):
    return torch.linalg.norm(gt_translation - translation, dim=-1) / torch.linalg.norm(
        gt_translation, dim=-1
    )


def relative_scale_error(gt_scale, scale):
    return torch.abs(gt_scale - scale) / torch.abs(gt_scale)


def isotropic_transform_error(gt_transform, transform):
    """(rre_deg, rte, rse) for similarity transforms."""
    gt_r, gt_t, gt_s = rotation_translation_scale_from_transform(gt_transform)
    r, t, s = rotation_translation_scale_from_transform(transform)
    return (
        relative_rotation_error(gt_r, r),
        relative_translation_error(gt_t, t),
        relative_scale_error(gt_s, s),
    )


def modified_chamfer_distance(
    raw_points,
    ref_points,
    src_points,
    gt_transform,
    transform,
    raw_mask=None,
    ref_mask=None,
    src_mask=None,
):
    """Modified chamfer distance: masked mean of aligned src -> raw plus
    GT-aligned raw -> src squared nearest distances. `ref_points` and
    `ref_mask` are accepted for the reference's signature and not used."""
    if raw_mask is None:
        raw_mask = torch.ones(raw_points.shape[0], dtype=torch.bool, device=raw_points.device)
    if src_mask is None:
        src_mask = torch.ones(src_points.shape[0], dtype=torch.bool, device=src_points.device)
    aligned_src = apply_transform(src_points, transform)
    m1 = masked_pairwise_sq_dist(aligned_src, raw_points, src_mask, raw_mask).amin(dim=1)
    chamfer_src = torch.where(src_mask, m1, 0.0).sum() / torch.clamp_min(src_mask.sum(), 1)
    aligned_raw = apply_transform(raw_points, torch.linalg.inv(gt_transform))
    m2 = masked_pairwise_sq_dist(aligned_raw, src_points, raw_mask, src_mask).amin(dim=1)
    chamfer_raw = torch.where(raw_mask, m2, 0.0).sum() / torch.clamp_min(raw_mask.sum(), 1)
    return chamfer_src + chamfer_raw


def anisotropic_transform_error(gt_transform, transform):
    """Per-axis rotation (xyz euler angles, degrees) and translation errors.
    Returns (r_mse, r_mae, t_mse, t_mae)."""
    gt_r, gt_t, _ = rotation_translation_scale_from_transform(gt_transform)
    r, t, _ = rotation_translation_scale_from_transform(transform)

    def euler_xyz(m):
        sy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
        x = torch.atan2(m[..., 2, 1], m[..., 2, 2])
        y = torch.atan2(-m[..., 2, 0], sy)
        z = torch.atan2(m[..., 1, 0], m[..., 0, 0])
        return torch.stack([x, y, z], dim=-1) * 180.0 / np.pi

    r_err = euler_xyz(gt_r) - euler_xyz(r)
    t_err = gt_t - t
    return (
        torch.mean(r_err**2, dim=-1),
        torch.mean(torch.abs(r_err), dim=-1),
        torch.mean(t_err**2, dim=-1),
        torch.mean(torch.abs(t_err), dim=-1),
    )


def inlier_ratio(ref_corr_points, src_corr_points, corr_valid, transform, radius):
    """Share of the valid correspondences within `radius` after alignment."""
    d = torch.linalg.norm(ref_corr_points - apply_transform(src_corr_points, transform), dim=-1)
    ok = (d < radius) & corr_valid
    return ok.sum() / torch.clamp_min(corr_valid.sum(), 1)


def overlap_ratio(ref_points, src_points, ref_mask, src_mask, transform, radius):
    """Share of the valid src points with a ref point within `radius` after
    alignment."""
    aligned = apply_transform(src_points, transform)
    d2 = masked_pairwise_sq_dist(aligned, ref_points, src_mask, ref_mask)
    close = d2.amin(dim=1) < radius * radius
    return (close & src_mask).sum() / torch.clamp_min(src_mask.sum(), 1)


def registration_rmse(src_points, src_mask, gt_transform, est_transform):
    """Mean realignment residual of the valid src points."""
    realign = torch.linalg.inv(gt_transform) @ est_transform
    res = torch.linalg.norm(apply_transform(src_points, realign) - src_points, dim=-1)
    return torch.sum(torch.where(src_mask, res, 0.0)) / torch.clamp_min(src_mask.sum(), 1)


def evaluate_registration(
    cfg: Config, gt_transform, est_transform, src_points, src_mask
) -> Dict[str, torch.Tensor]:
    """RRE, RTE, RTE_abs, RSE, RMSE and RR (RMSE < cfg.eval.rmse_threshold),
    in the normalized frame."""
    rre, rte, rse = isotropic_transform_error(gt_transform, est_transform)
    rmse = registration_rmse(src_points, src_mask, gt_transform, est_transform)
    return {
        "RRE": rre,
        "RTE": rte,
        "RTE_abs": torch.linalg.norm(gt_transform[..., :3, 3] - est_transform[..., :3, 3], dim=-1),
        "RSE": rse,
        "RMSE": rmse,
        "RR": (rmse < cfg.eval.rmse_threshold).to(torch.float32),
    }


def unnormalize_transform(
    est_transform: np.ndarray,
    ref_adjust_scale: float,
    src_adjust_scale: float,
    ref_center: np.ndarray,
    src_center: np.ndarray,
) -> np.ndarray:
    """Map a transform estimated in the volume-normalized frame back to the
    original GS frame."""
    out = np.zeros_like(est_transform)
    out[:3, :3] = est_transform[:3, :3] / ref_adjust_scale * src_adjust_scale
    out[:3, 3] = est_transform[:3, 3] / ref_adjust_scale + ref_center - out[:3, :3] @ src_center
    out[3, 3] = 1.0
    return out
