"""GS model fusion: transform model B by an estimated similarity and merge
(port of gaussreg_tpu/gs/fusion.py).

The per-gaussian math (xyz transform, log-scale shift, quaternion
composition, SH rotation, midpoint-distance keep filter) runs as tensor ops
on the device; file IO and orchestration stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.gs import sh as sh_mod
from gaussreg_tpu_torch.gs.ply import GaussianModel, load_gaussians, save_gaussians
from gaussreg_tpu_torch.ops.transforms import (
    matrix_to_quaternion,
    quaternion_to_matrix,
)


def _transform_gaussians_device(xyz, scales, rots, f_rest, transform):
    """Apply a similarity transform (4, 4 with s*R block) to gaussian
    params: xyz' = xyz R^T s + t; log-scales shift by log(s); rotations
    left-composed with R; SH bands rotated."""
    a = transform[:3, :3]
    t = transform[:3, 3]
    scale = torch.sqrt((a @ a.T)[0, 0])
    r = a / scale

    xyz_t = xyz @ r.T * scale + t
    scales_t = scales + torch.log(scale)
    rots_t = matrix_to_quaternion(r[None] @ quaternion_to_matrix(rots))
    f_rest_t = sh_mod.rotate_sh_rest(f_rest, r)
    return xyz_t, scales_t, rots_t, f_rest_t


def _keep_masks_device(xyz1, xyz2):
    """Midpoint filter: keep a point iff it is closer to its own cloud's
    centroid than to the other cloud's.

    Cloud 1 keeps ties (<=): with perfectly-aligned clouds (coincident
    centroids) a strict < on both sides drops every point of both models;
    the asymmetric tie-break keeps exactly one copy instead."""
    c1 = xyz1.mean(0)
    c2 = xyz2.mean(0)
    keep1 = torch.linalg.norm(xyz1 - c1, dim=1) <= torch.linalg.norm(xyz1 - c2, dim=1)
    keep2 = torch.linalg.norm(xyz2 - c2, dim=1) < torch.linalg.norm(xyz2 - c1, dim=1)
    return keep1, keep2


def transform_gaussians(
    g: GaussianModel, transform: np.ndarray, device: DeviceLike = None
) -> GaussianModel:
    """Host wrapper: similarity-transform a GaussianModel."""
    dev = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    xyz, scales, rots, f_rest = _transform_gaussians_device(
        f(g.xyz), f(g.scales), f(g.rots), f(g.f_rest), f(transform)
    )
    return GaussianModel(
        xyz=xyz.cpu().numpy(),
        f_dc=g.f_dc,
        f_rest=f_rest.cpu().numpy(),
        opacity=g.opacity,
        scales=scales.cpu().numpy(),
        rots=rots.cpu().numpy(),
    )


def fuse_gaussians(
    g1: GaussianModel, g2: GaussianModel, transform: np.ndarray, device: DeviceLike = None
) -> GaussianModel:
    """Transform g2 into g1's frame and merge with the midpoint keep filter."""
    dev = resolve_device(device)
    g2t = transform_gaussians(g2, transform, device=dev)
    keep1, keep2 = _keep_masks_device(
        torch.as_tensor(np.asarray(g1.xyz, np.float32), device=dev),
        torch.as_tensor(g2t.xyz, device=dev),
    )
    k1 = keep1.cpu().numpy()
    k2 = keep2.cpu().numpy()

    def cat(a, b):
        return np.concatenate([a[k1], b[k2]], axis=0)

    return GaussianModel(
        xyz=cat(g1.xyz, g2t.xyz),
        f_dc=cat(g1.f_dc, g2t.f_dc),
        f_rest=cat(g1.f_rest, g2t.f_rest),
        opacity=cat(g1.opacity, g2t.opacity),
        scales=cat(g1.scales, g2t.scales),
        rots=cat(g1.rots, g2t.rots),
    )


def gaussian_fuse(
    input_path_1: str, input_path_2: str, transform_path: str, output_path: str,
    device: DeviceLike = None,
) -> None:
    """CLI-level entry: fuses two GS .ply models given an
    estimated_transform .npz and writes the merged .ply."""
    g1 = load_gaussians(input_path_1)
    g2 = load_gaussians(input_path_2)
    transform = np.load(transform_path)["estimated_transform"]
    save_gaussians(output_path, fuse_gaussians(g1, g2, transform, device=device))
