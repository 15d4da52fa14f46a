"""Pinhole camera container for the rasterizer (port of
gaussreg_tpu/gs/rasterizer/camera.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """world-to-camera extrinsics (4, 4) with z forward, + intrinsics.

    `w2c` may live on any device: the renderer moves it to the gaussians'."""

    w2c: torch.Tensor  # (4, 4)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def cam_center(self) -> torch.Tensor:
        r = self.w2c[:3, :3]
        t = self.w2c[:3, 3]
        return -r.T @ t


def look_at_camera(eye, target, up, fov_deg: float, width: int, height: int) -> Camera:
    """Build a Camera looking from `eye` to `target` (numpy, host-side)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd], axis=0)  # world -> cam rows
    t = -r @ eye
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = r
    w2c[:3, 3] = t
    focal = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
    return Camera(
        w2c=torch.from_numpy(w2c),
        fx=float(focal),
        fy=float(focal),
        cx=width / 2.0,
        cy=height / 2.0,
        width=width,
        height=height,
    )
