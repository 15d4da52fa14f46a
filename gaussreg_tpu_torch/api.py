"""High-level API: register and fuse Gaussian Splatting models (port of
gaussreg_tpu/api.py): coarse registration, optional render-and-compare
refinement, and the re-export of `gaussian_fuse`.

Entry points run on CUDA by default and raise without it unless the caller
passes device="cpu". Where the JAX package takes a parameter tree, the port
takes the model (an nn.Module holding its weights).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from gaussreg_tpu_torch.config import Config, make_cfg
from gaussreg_tpu_torch.data.pipeline import make_pair_batch
from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.gs.cameras import find_cameras_json, load_cameras_json
from gaussreg_tpu_torch.gs.extract import (
    adjust_point_cloud_volume,
    load_point_cloud_from_gs_ply,
)
from gaussreg_tpu_torch.gs.fine_registration import (
    default_cameras,
    fine_register,
    to_device_gaussians,
)
from gaussreg_tpu_torch.gs.fusion import gaussian_fuse  # noqa: F401 (re-export)
from gaussreg_tpu_torch.gs.ply import load_gaussians, write_ply_vertex
from gaussreg_tpu_torch.models.metrics import unnormalize_transform
from gaussreg_tpu_torch.models.registration import GaussRegModel


def coarse_register_clouds(
    cfg: Config,
    model: GaussRegModel,
    ref_points: np.ndarray,
    ref_feats: np.ndarray,
    src_points: np.ndarray,
    src_feats: np.ndarray,
    seed: int = 0,
    device: DeviceLike = None,
    transform: Optional[np.ndarray] = None,
) -> Dict:
    """Run the coarse model on already-normalized clouds. Returns the output
    dict with 'estimated_transform' in the normalized frame, plus the built
    'batch'. `transform` (the GT, when known) rides along in the batch.
    The call is the span `coarse_call`; its layers' spans nest inside it."""
    with annotate("coarse_call"):
        dev = resolve_device(device)
        batch = make_pair_batch(
            cfg, ref_points, ref_feats, src_points, src_feats, transform, device=dev
        )
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        with torch.no_grad():
            out = model(batch, generator)
        out["batch"] = batch
        return out


def register_gs_pair(
    ref_ply_path: str,
    src_ply_path: str,
    model: GaussRegModel,
    cfg: Optional[Config] = None,
    point_limit: Optional[int] = None,
    fine: bool = False,
    fine_steps: int = 100,
    max_fine_gaussians: int = 200000,
    cameras_json: Optional[str] = None,
    fine_views: int = 4,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict:
    """Register two 3DGS .ply models: returns {'transform': (4, 4) similarity
    mapping src into ref's frame, ...}: extract the clouds, volume-normalize,
    coarse registration, un-normalize; with `fine`, refine the result by
    render-and-compare (gs/fine_registration.py) from the viewpoints of a
    cameras.json (given, or found next to the ref model) or from synthetic
    orbit views.

    Spans: `gs_pair.extract` (both clouds read and extracted),
    `gs_pair.normalise`, `coarse_call`, and with `fine` `gs_pair.fine_load`
    (both models read and moved to the device) and `fine_call`."""
    dev = resolve_device(device)
    cfg = cfg or make_cfg()
    point_limit = point_limit or cfg.train.point_limit

    with annotate("gs_pair.extract"):
        ref_points, ref_feats = load_point_cloud_from_gs_ply(ref_ply_path, point_limit,
                                                             seed=seed)
        src_points, src_feats = load_point_cloud_from_gs_ply(src_ply_path, point_limit,
                                                             seed=seed + 1)
    with annotate("gs_pair.normalise"):
        ref_n, src_n, _, _, ref_scale, src_scale, ref_center, src_center = (
            adjust_point_cloud_volume(ref_points, src_points, np.eye(3), np.zeros(3),
                                      min_adjust_volume=30.0, apply_translation=True))
    out = coarse_register_clouds(
        cfg, model, ref_n, ref_feats, src_n, src_feats, seed=seed, device=dev
    )
    est = out["estimated_transform"].cpu().numpy()
    transform = unnormalize_transform(est, ref_scale, src_scale, ref_center, src_center)
    result = {
        "transform": transform,
        "coarse_transform": transform.copy(),
        "normalized_transform": est,
        "ransac_inliers": int(out["ransac_inliers"]),
        "num_correspondences": int(out["num_correspondences"]),
        # original-frame extracted clouds, features = [opacity, R, G, B]
        "ref_points": ref_points,
        "ref_colors": ref_feats[:, 1:4],
        "src_points": src_points,
        "src_colors": src_feats[:, 1:4],
    }
    if fine:
        with annotate("gs_pair.fine_load"):
            ref_g = to_device_gaussians(load_gaussians(ref_ply_path), max_fine_gaussians,
                                        device=dev)
            src_g = to_device_gaussians(load_gaussians(src_ply_path), max_fine_gaussians,
                                        device=dev)
        # the fine render compares views of the REF frame, so ref's cameras
        # are the right ones
        cams_path = cameras_json or find_cameras_json(ref_ply_path)
        if cams_path is not None:
            cams = load_cameras_json(cams_path, max_cameras=fine_views, max_size=640)
            result["fine_cameras"] = cams_path
        else:
            cams = default_cameras(ref_g.means.cpu().numpy(), num_views=fine_views)
        fine_out = fine_register(ref_g, src_g, transform, cams, num_steps=fine_steps)
        result["transform"] = fine_out.transform.cpu().numpy()
        result["fine_losses"] = fine_out.losses.cpu().numpy()
    return result


def write_demo_outputs(output_dir: str, result: Dict) -> List[str]:
    """Write `point_cloud_src_org.ply` / `point_cloud_ref.ply` (original
    frames), `point_cloud_src.ply` (src mapped into ref's frame by the
    estimated similarity) and `estimated_transform.npz`."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []

    def _write(name, points, colors):
        p = os.path.join(output_dir, name)
        cols = {c: points[:, i] for i, c in enumerate("xyz")}
        for i, c in enumerate(("red", "green", "blue")):
            cols[c] = colors[:, i]
        write_ply_vertex(p, cols)
        paths.append(p)

    t = np.asarray(result["transform"])
    src = np.asarray(result["src_points"])
    _write("point_cloud_src_org.ply", src, np.asarray(result["src_colors"]))
    _write("point_cloud_ref.ply", np.asarray(result["ref_points"]), np.asarray(result["ref_colors"]))
    _write("point_cloud_src.ply", src @ t[:3, :3].T + t[:3, 3], np.asarray(result["src_colors"]))
    npz = os.path.join(output_dir, "estimated_transform.npz")
    np.savez(npz, estimated_transform=t)
    paths.append(npz)
    return paths
