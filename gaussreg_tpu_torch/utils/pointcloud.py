"""Host-side (numpy) point cloud utilities (the port's copy of
gaussreg_tpu/utils/pointcloud.py).

reference: geotransformer/utils/pointcloud.py:11-287 and parts of
geotransformer/utils/registration.py — nearest neighbors, transform
composition/decomposition with scale, random rotations, keypoint
sampling/NMS, depth-image unprojection.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def get_nearest_neighbor(q_points, s_points, return_index: bool = False):
    """KD-tree nearest neighbor distances (reference pointcloud.py:11-22)."""
    tree = cKDTree(s_points)
    distances, indices = tree.query(q_points, k=1)
    if return_index:
        return distances, indices
    return distances


def apply_transform_np(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    return points @ transform[:3, :3].T + transform[:3, 3]


def get_transform_from_rotation_translation(rotation, translation):
    """reference pointcloud.py:43-56."""
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3] = rotation
    transform[:3, 3] = translation
    return transform


def get_rotation_translation_from_transform(transform):
    return transform[:3, :3], transform[:3, 3]


def get_rotation_translation_from_transform_w_scale(transform):
    """Similarity decomposition, scale = sqrt(trace(A A^T) / 3)
    (reference pointcloud.py:95-108 — note: the numpy twin uses the trace
    form while the torch module uses the (0,0) entry; identical for exact
    similarities)."""
    a = transform[:3, :3]
    scale = np.sqrt(np.trace(a @ a.T) / 3.0)
    return a / scale, transform[:3, 3] / scale, scale


def inverse_transform_np(transform):
    r, t = get_rotation_translation_from_transform(transform)
    return get_transform_from_rotation_translation(r.T, -r.T @ t)


def random_sample_rotation(rotation_factor: float = 1.0, rng=None) -> np.ndarray:
    """Uniform-axis random rotation with angle in [0, 2*pi*factor)
    (reference pointcloud.py:126-139)."""
    rng = rng or np.random.default_rng()
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis) + 1e-12
    angle = rng.uniform() * 2 * np.pi * rotation_factor
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return (np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)).astype(
        np.float32
    )


def random_sample_points(points, num_samples: int, rng=None):
    """Uniform subsample without replacement (reference pointcloud.py:153+)."""
    rng = rng or np.random.default_rng()
    n = points.shape[0]
    if n <= num_samples:
        return points
    return points[rng.choice(n, num_samples, replace=False)]


def sample_keypoints_nms(
    points: np.ndarray, scores: np.ndarray, num_keypoints: int, radius: float
):
    """Score-ordered non-maximum suppression keypoint selection
    (reference pointcloud.py:196-253). Returns indices."""
    order = np.argsort(-scores)
    selected = []
    tree: Optional[cKDTree] = None
    sel_pts = []
    for i in order:
        if len(selected) >= num_keypoints:
            break
        p = points[i]
        if sel_pts:
            tree = cKDTree(np.asarray(sel_pts))
            d, _ = tree.query(p, k=1)
            if d < radius:
                continue
        selected.append(i)
        sel_pts.append(p)
    return np.asarray(selected, dtype=np.int64)


def depth_to_points(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    depth_scale: float = 1.0,
    depth_limit: Optional[float] = None,
) -> np.ndarray:
    """Unproject a depth image to a point cloud
    (reference pointcloud.py:259-287)."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth.astype(np.float64) / depth_scale
    valid = z > 0
    if depth_limit is not None:
        valid &= z < depth_limit
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = np.stack([x[valid], y[valid], z[valid]], axis=1)
    return pts.astype(np.float32)


def get_correspondences(
    ref_points: np.ndarray,
    src_points: np.ndarray,
    transform: np.ndarray,
    matching_radius: float,
) -> np.ndarray:
    """GT correspondences via KD-tree ball query after alignment
    (reference utils/registration.py:192-204). Returns (C, 2) indices."""
    src_t = apply_transform_np(src_points, transform)
    tree = cKDTree(ref_points)
    pairs = []
    neighbors = tree.query_ball_point(src_t, matching_radius)
    for j, idx in enumerate(neighbors):
        for i in idx:
            pairs.append((i, j))
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
