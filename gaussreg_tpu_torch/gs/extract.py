"""GS model -> registration point cloud extraction (port of
gaussreg_tpu/gs/extract.py, host numpy).

reference: geotransformer/datasets/registration/ScanNet_GSReg/dataset.py:73-130
(_read_ply_by_opacity + FPS limiting) and experiments/.../demo.py:30-75.

Pipeline: sigmoid-opacity filter (> 0.7), per-axis 5-95 percentile crop,
SH-degree-3 color evaluation toward a synthetic viewpoint 2x the bbox
diagonal above the centroid, optional furthest-point downsample, features =
[opacity, R, G, B] (RGB in 0..255).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gaussreg_tpu_torch.gs import sh as sh_mod
from gaussreg_tpu_torch.gs.ply import GaussianModel, load_gaussians


def extract_point_cloud(
    model: GaussianModel,
    transformation: Optional[np.ndarray] = None,
    opacity_threshold: float = 0.7,
    percentile: float = 5.0,
    view_rotation: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (points (N, 3) float32, features (N, 4) float32).

    `transformation` (4, 4) is applied to the points first (test-time frame
    alignment, reference dataset.py:108-112). `view_rotation` optionally
    rotates the synthetic camera offset (the reference uses a random rotation
    during training: dataset.py:107).
    """
    opacity_logit = model.opacity[:, 0]
    opacity = 1.0 / (1.0 + np.exp(-opacity_logit))
    xyz = model.xyz

    lo = np.percentile(xyz, percentile, axis=0)
    hi = np.percentile(xyz, 100.0 - percentile, axis=0)
    keep = (
        (opacity > opacity_threshold)
        & np.all(xyz > lo, axis=1)
        & np.all(xyz < hi, axis=1)
    )
    index = np.where(keep)[0]

    points = xyz[index]
    coeffs = model.sh_coeffs()[index]  # (N, 3, 16)

    if transformation is not None:
        points = points @ transformation[:3, :3].T + transformation[:3, 3]

    center = points.mean(0)
    max_length = np.linalg.norm(points.max(0) - points.min(0))
    offset = np.array([0.0, 2.0 * max_length, 0.0])
    if view_rotation is not None:
        offset = offset @ view_rotation.T
    camera = center + offset

    # view direction = point - camera (reference dataset.py:114-115)
    dirs = points - camera
    dirs = dirs / (np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-6)
    rgb = np.asarray(sh_mod.eval_sh(3, coeffs, dirs))  # (N, 3)
    colors = np.clip(rgb + 0.5, 0.0, 1.0) * 255.0

    features = np.concatenate(
        [opacity[index][:, None], colors.astype(np.float32)], axis=1
    ).astype(np.float32)
    return points.astype(np.float32), features


def load_point_cloud_from_gs_ply(
    path: str,
    point_limit: Optional[int] = None,
    transformation: Optional[np.ndarray] = None,
    view_rotation: Optional[np.ndarray] = None,
    seed: int = 0,
    return_model: bool = False,
):
    """reference dataset.py:122-130: extraction + FPS down to point_limit.
    Returns (points, features), and with `return_model` also the
    GaussianModel read from `path`, so that a caller that needs the model
    too reads the file once."""
    from gaussreg_tpu_torch.ops.subsample import furthest_point_sample_host

    model = load_gaussians(path)
    points, features = extract_point_cloud(
        model, transformation, view_rotation=view_rotation
    )
    if point_limit is not None and points.shape[0] > point_limit:
        idx = furthest_point_sample_host(points, point_limit, seed=seed)
        points = points[idx]
        features = features[idx]
    if return_model:
        return points, features, model
    return points, features


def adjust_point_cloud_volume(
    ref_points: np.ndarray,
    src_points: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    max_adjust_volume: float = 50.0,
    min_adjust_volume: float = 10.0,
    apply_translation: bool = False,
):
    """Volume normalization of both clouds into [min, max] m^3, adjusting the
    GT rotation/translation consistently (reference dataset.py:132-168).

    Returns (ref_points, src_points, rotation, translation,
    ref_adjust_scale, src_adjust_scale, ref_center, src_center)."""

    def volume(p):
        ext = p.max(0) - p.min(0)
        return float(ext[0] * ext[1] * ext[2])

    ref_scale = 1.0
    src_scale = 1.0
    ref_center = np.zeros(3, np.float32)
    src_center = np.zeros(3, np.float32)
    if apply_translation:
        ref_center = ((ref_points.max(0) + ref_points.min(0)) / 2).astype(np.float32)
        ref_points = ref_points - ref_center
        src_center = ((src_points.max(0) + src_points.min(0)) / 2).astype(np.float32)
        src_points = src_points - src_center

    ref_vol = volume(ref_points)
    src_vol = volume(src_points)
    if ref_vol > max_adjust_volume:
        ref_scale = (max_adjust_volume / ref_vol) ** (1.0 / 3.0)
    elif ref_vol < min_adjust_volume:
        ref_scale = (min_adjust_volume / ref_vol) ** (1.0 / 3.0)
    if ref_scale != 1.0:
        ref_points = ref_points * ref_scale
        rotation = rotation * ref_scale
        translation = translation * ref_scale

    if src_vol > max_adjust_volume:
        src_scale = (max_adjust_volume / src_vol) ** (1.0 / 3.0)
    elif src_vol < min_adjust_volume:
        src_scale = (min_adjust_volume / src_vol) ** (1.0 / 3.0)
    if src_scale != 1.0:
        src_points = src_points * src_scale
        rotation = rotation / src_scale

    return (
        ref_points,
        src_points,
        rotation,
        translation,
        ref_scale,
        src_scale,
        ref_center,
        src_center,
    )
