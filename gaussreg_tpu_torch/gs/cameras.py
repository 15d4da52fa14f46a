"""3DGS ``cameras.json`` parsing -> rasterizer Cameras (port of
gaussreg_tpu/gs/cameras.py).

Every 3DGS training run (graphdeco-inria format) writes a ``cameras.json``
next to the model directory. Each entry:

    {"id", "img_name", "width", "height",
     "position": [3] camera center in world space,
     "rotation": [3][3] camera-to-world rotation (rows),
     "fx", "fy": focals in pixels}

The principal point is implicitly the image center. The rasterizer wants
world-to-camera with z forward: R_w2c = rot^T, t = -rot^T @ position.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from gaussreg_tpu_torch.gs.rasterizer.camera import Camera


def camera_from_entry(entry: dict, image_scale: float = 1.0) -> Camera:
    """One cameras.json entry -> Camera (optionally rescaled)."""
    rot = np.asarray(entry["rotation"], np.float32)  # (3, 3) c2w
    pos = np.asarray(entry["position"], np.float32)  # (3,)
    r = rot.T  # w2c
    t = -r @ pos
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = r
    w2c[:3, 3] = t
    width = int(round(entry["width"] * image_scale))
    height = int(round(entry["height"] * image_scale))
    return Camera(
        w2c=torch.from_numpy(w2c),
        fx=float(entry["fx"]) * image_scale,
        fy=float(entry["fy"]) * image_scale,
        cx=width / 2.0,
        cy=height / 2.0,
        width=width,
        height=height,
    )


def load_cameras_json(
    path: str,
    max_cameras: Optional[int] = None,
    image_scale: float = 1.0,
    max_size: Optional[int] = None,
) -> List[Camera]:
    """Parse a 3DGS cameras.json into rasterizer Cameras.

    Args:
        max_cameras: keep at most this many viewpoints, spread evenly
            through the (typically trajectory-ordered) list.
        image_scale: uniform intrinsics/resolution scale.
        max_size: if set, additionally downscale so max(W, H) <= max_size.
    """
    with open(path) as f:
        entries = json.load(f)
    if not entries:
        raise ValueError(f"{path}: empty cameras.json")
    if max_cameras is not None and len(entries) > max_cameras:
        idx = np.linspace(0, len(entries) - 1, max_cameras).round().astype(int)
        entries = [entries[i] for i in idx]
    cams = []
    for e in entries:
        scale = image_scale
        if max_size is not None:
            cur = max(e["width"], e["height"]) * scale
            if cur > max_size:
                scale *= max_size / cur
        cams.append(camera_from_entry(e, image_scale=scale))
    return cams


def find_cameras_json(ply_path: str) -> Optional[str]:
    """Locate the cameras.json belonging to a GS point_cloud.ply.

    The 3DGS layout is <model>/point_cloud/iteration_N/point_cloud.ply with
    <model>/cameras.json; walk up from the ply until found.
    """
    d = os.path.dirname(os.path.abspath(ply_path))
    for _ in range(4):
        cand = os.path.join(d, "cameras.json")
        if os.path.isfile(cand):
            return cand
        d = os.path.dirname(d)
    return None


def save_cameras_json(path: str, cameras: List[Camera]) -> None:
    """Inverse of load (testing + synthetic-scene tooling)."""
    entries = []
    for i, c in enumerate(cameras):
        w2c = c.w2c.detach().cpu().numpy()
        r = w2c[:3, :3]
        pos = -r.T @ w2c[:3, 3]
        entries.append(
            {
                "id": i,
                "img_name": f"{i:05d}",
                "width": int(c.width),
                "height": int(c.height),
                "position": [float(x) for x in pos],
                "rotation": [[float(x) for x in row] for row in r.T],
                "fx": float(c.fx),
                "fy": float(c.fy),
            }
        )
    with open(path, "w") as f:
        json.dump(entries, f)
