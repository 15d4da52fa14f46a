"""Visualization helpers (Open3D-free): write colored clouds, node
assignments, and correspondence line sets as .ply / .obj files viewable in
any mesh tool.

reference: geotransformer/utils/visualization.py:14-158 (which uses Open3D
windows; headless hosts get file artifacts instead). The port's copy of
gaussreg_tpu/utils/visualization.py, on the port's own gs/ply.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gaussreg_tpu_torch.gs.ply import write_ply_vertex


def _colormap(values: np.ndarray) -> np.ndarray:
    """Simple blue->red colormap for scalar values in [0, 1]."""
    v = np.clip(values, 0.0, 1.0)
    return np.stack([v, 0.2 + 0.3 * np.sin(np.pi * v), 1.0 - v], axis=1)


def write_point_cloud(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Write a (colored) point cloud .ply. colors in [0, 1]."""
    cols = {c: points[:, i] for i, c in enumerate("xyz")}
    if colors is not None:
        for i, c in enumerate(("red", "green", "blue")):
            cols[c] = colors[:, i]
    write_ply_vertex(path, cols)


def write_node_partition(path: str, points: np.ndarray, point_to_node: np.ndarray):
    """Color points by their node assignment (reference
    visualization.py draw_node_partition)."""
    rng = np.random.default_rng(0)
    palette = rng.uniform(0.1, 1.0, size=(int(point_to_node.max()) + 1, 3))
    write_point_cloud(path, points, palette[point_to_node])


def write_scored_cloud(path: str, points: np.ndarray, scores: np.ndarray):
    """Color points by a scalar score (e.g. overlap/confidence)."""
    s = scores - scores.min()
    s = s / (s.max() + 1e-12)
    write_point_cloud(path, points, _colormap(s))


def write_correspondences_obj(
    path: str,
    ref_points: np.ndarray,
    src_points: np.ndarray,
    valid: Optional[np.ndarray] = None,
):
    """Write correspondence line segments as a wavefront .obj
    (reference visualization.py draw_correspondences)."""
    if valid is None:
        valid = np.ones(ref_points.shape[0], bool)
    with open(path, "w") as f:
        idx = 1
        for r, s, ok in zip(ref_points, src_points, valid):
            if not ok:
                continue
            f.write(f"v {r[0]} {r[1]} {r[2]}\n")
            f.write(f"v {s[0]} {s[1]} {s[2]}\n")
            f.write(f"l {idx} {idx + 1}\n")
            idx += 2


def write_registration_result(
    out_dir: str,
    ref_points: np.ndarray,
    src_points: np.ndarray,
    transform: np.ndarray,
):
    """Dump ref / aligned-src clouds for visual inspection."""
    import os

    from gaussreg_tpu_torch.utils.pointcloud import apply_transform_np

    os.makedirs(out_dir, exist_ok=True)
    n_ref = ref_points.shape[0]
    write_point_cloud(
        os.path.join(out_dir, "ref.ply"),
        ref_points,
        np.tile([[0.2, 0.5, 1.0]], (n_ref, 1)),
    )
    aligned = apply_transform_np(src_points, transform)
    write_point_cloud(
        os.path.join(out_dir, "src_aligned.ply"),
        aligned,
        np.tile([[1.0, 0.6, 0.1]], (aligned.shape[0], 1)),
    )
