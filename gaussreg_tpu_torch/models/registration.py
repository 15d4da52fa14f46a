"""The GaussReg coarse registration model, eval forward
(port of gaussreg_tpu/models/registration.py, train=False).

One forward = KPConv-FPN backbone over the [ref, src] pair, geometric
transformer over superpoints, superpoint matching, Sinkhorn OT over
patch-local features, LGR, and a similarity RANSAC.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.data.pipeline import PairBatch
from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.models.backbone import KPConvFPN
from gaussreg_tpu_torch.models.geotransformer import GeometricTransformer
from gaussreg_tpu_torch.models.kpconv import batched_gather
from gaussreg_tpu_torch.models.matching import (
    local_to_global_registration,
    superpoint_matching,
)
from gaussreg_tpu_torch.ops.partition import point_to_node_partition
from gaussreg_tpu_torch.ops.ransac import ransac_similarity
from gaussreg_tpu_torch.ops.sinkhorn import log_optimal_transport


class GaussRegModel(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        bb, gt = cfg.backbone, cfg.geotransformer
        self.backbone = KPConvFPN(
            bb.input_dim, bb.output_dim, bb.init_dim, bb.kernel_size,
            bb.init_radius, bb.init_sigma, bb.group_norm, bb.shared_kpconv_geometry,
        )
        # flax infers in_proj's input width from the backbone's coarse
        # features (init_dim * 32); cfg.geotransformer.input_dim only
        # matches it at make_cfg() widths
        self.transformer = GeometricTransformer(
            bb.init_dim * 32, gt.output_dim, gt.hidden_dim, gt.num_heads, gt.blocks,
            gt.sigma_d, gt.sigma_a, gt.angle_k, gt.reduction_a,
        )
        self.ot_alpha = nn.Parameter(torch.ones(()))

    @torch.no_grad()
    def forward(self, batch: PairBatch, generator: torch.Generator) -> Dict[str, Any]:
        """Eval forward with the transform (the JAX model's train=False,
        with_transform=True); RANSAC hypotheses are drawn with `generator`."""
        cfg = self.cfg
        pyr = batch.pyramid
        out: Dict[str, Any] = {}
        points_f, masks_f = pyr.points[1], pyr.masks[1]
        points_c, masks_c = pyr.points[-1], pyr.masks[-1]

        parts = [
            point_to_node_partition(
                points_f[i], points_c[i], masks_f[i], masks_c[i],
                cfg.model.num_points_in_patch,
            )
            for i in range(2)
        ]
        node_masks = torch.stack([p[1] for p in parts])
        node_knn_indices = torch.stack([p[2] for p in parts])
        node_knn_masks = torch.stack([p[3] for p in parts])
        node_knn_points = batched_gather(points_f, node_knn_indices, fill=0.0)

        feats_f, feats_c = self.backbone(batch.features, pyr)

        ref_feats_c, src_feats_c = self.transformer(
            points_c[0:1], points_c[1:2], feats_c[0:1], feats_c[1:2],
            masks_c[0:1], masks_c[1:2],
        )
        ref_feats_c, src_feats_c = ref_feats_c[0], src_feats_c[0]
        ref_feats_c_norm = ref_feats_c * torch.rsqrt(
            torch.sum(ref_feats_c**2, dim=-1, keepdim=True) + 1e-12
        )
        src_feats_c_norm = src_feats_c * torch.rsqrt(
            torch.sum(src_feats_c**2, dim=-1, keepdim=True) + 1e-12
        )
        out["ref_feats_c"] = ref_feats_c_norm
        out["src_feats_c"] = src_feats_c_norm
        out["ref_node_masks"] = node_masks[0]
        out["src_node_masks"] = node_masks[1]

        ref_idx, src_idx, _, sel_valid = superpoint_matching(
            ref_feats_c_norm, src_feats_c_norm, node_masks[0], node_masks[1],
            cfg.coarse_matching.num_correspondences,
            cfg.coarse_matching.dual_normalization,
        )
        out["ref_node_corr_indices"] = ref_idx
        out["src_node_corr_indices"] = src_idx
        out["node_corr_valid"] = sel_valid

        ref_knn_pts = node_knn_points[0][ref_idx]  # (P, K, 3)
        src_knn_pts = node_knn_points[1][src_idx]
        ref_knn_msk = node_knn_masks[0][ref_idx] & sel_valid[:, None]
        src_knn_msk = node_knn_masks[1][src_idx] & sel_valid[:, None]
        ref_knn_feats = batched_gather(feats_f[0:1], node_knn_indices[0][ref_idx][None], fill=0.0)[0]
        src_knn_feats = batched_gather(feats_f[1:2], node_knn_indices[1][src_idx][None], fill=0.0)[0]
        out["ref_node_corr_knn_points"] = ref_knn_pts
        out["src_node_corr_knn_points"] = src_knn_pts
        out["ref_node_corr_knn_masks"] = ref_knn_msk
        out["src_node_corr_knn_masks"] = src_knn_msk

        c = feats_f.shape[-1]
        matching_scores = torch.einsum("pkc,plc->pkl", ref_knn_feats, src_knn_feats)
        matching_scores = matching_scores / torch.sqrt(
            torch.tensor(float(c), device=matching_scores.device)
        )
        matching_scores = log_optimal_transport(
            matching_scores, ref_knn_msk, src_knn_msk, self.ot_alpha,
            cfg.model.num_sinkhorn_iterations,
        )
        out["matching_scores"] = matching_scores

        fm = cfg.fine_matching
        lgr = local_to_global_registration(
            ref_knn_pts, src_knn_pts, ref_knn_msk, src_knn_msk,
            matching_scores[:, :-1, :-1], sel_valid,
            k=fm.topk,
            acceptance_radius=fm.acceptance_radius,
            mutual=fm.mutual,
            confidence_threshold=fm.confidence_threshold,
            correspondence_threshold=fm.correspondence_threshold,
            num_refinement_steps=fm.num_refinement_steps,
            max_correspondences=cfg.capacity.max_correspondences,
            max_patch_correspondences=cfg.capacity.max_patch_correspondences,
        )
        out["ref_corr_points"] = lgr.ref_corr_points
        out["src_corr_points"] = lgr.src_corr_points
        out["corr_scores"] = lgr.corr_scores
        out["corr_valid"] = lgr.corr_valid
        out["lgr_transform"] = lgr.transform
        out["num_correspondences"] = lgr.num_correspondences

        transform, inliers = ransac_similarity(
            generator, lgr.src_corr_points, lgr.ref_corr_points, lgr.corr_valid,
            cfg.ransac.distance_threshold,
            num_iterations=cfg.ransac.num_iterations_test,
            num_points=cfg.ransac.num_points_test,
            with_scale=cfg.ransac.with_scale,
        )
        out["estimated_transform"] = transform
        out["ransac_inliers"] = inliers
        return out


def create_model(cfg: Config, device: DeviceLike = None) -> GaussRegModel:
    """The model on `device` (default cuda), in eval mode, weights at their
    init values (load a checkpoint with engine/checkpoint.py)."""
    return GaussRegModel(cfg).to(resolve_device(device)).eval()
