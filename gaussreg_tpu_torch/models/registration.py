"""The GaussReg coarse registration model (port of
gaussreg_tpu/models/registration.py).

One forward = KPConv-FPN backbone over the [ref, src] pair, geometric
transformer over superpoints, superpoint matching, Sinkhorn OT over
patch-local features, and with the transform LGR and a similarity RANSAC.
In training, GT node overlaps supervise the coarse features and sampled
GT node pairs take the place of the proposals. The forward differentiates:
eval callers run it under torch.no_grad().
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.data.pipeline import PairBatch
from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.models.backbone import KPConvFPN
from gaussreg_tpu_torch.models.geotransformer import GeometricTransformer
from gaussreg_tpu_torch.models import initializers as init
from gaussreg_tpu_torch.models.kpconv import batched_gather
from gaussreg_tpu_torch.models.matching import (
    local_to_global_registration,
    node_overlap_matrix,
    sample_gt_node_correspondences,
    superpoint_matching,
)
from gaussreg_tpu_torch.ops.partition import point_to_node_partition
from gaussreg_tpu_torch.ops.ransac import ransac_similarity
from gaussreg_tpu_torch.ops.sinkhorn import log_optimal_transport


def _patch_membership(node_knn_indices, node_knn_masks, num_points):
    """(N,) flag: the point is inside some node's K-nearest patch."""
    member = torch.zeros(num_points + 1, dtype=torch.bool, device=node_knn_indices.device)
    member[node_knn_indices.reshape(-1)[node_knn_masks.reshape(-1)].long()] = True
    return member[:num_points]


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

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter as the JAX model's init does (flax's
        initialisers, models/initializers.py) from a CPU `generator`."""
        self.backbone.reset_parameters(generator)
        self.transformer.reset_parameters(generator)
        init.constant_(self.ot_alpha, 1.0)

    def forward(
        self,
        batch: PairBatch,
        generator: torch.Generator,
        train: bool = False,
        with_transform: bool = True,
        with_gt_overlaps: bool = False,
    ) -> Dict[str, Any]:
        """The JAX model's forward and its branches. `generator` (of the
        batch's device) draws the GT pairs' Gumbel noise under `train` and
        then RANSAC's hypotheses under `with_transform`. Each stage is a
        span (engine/debug.py `annotate`) of the stage's name."""
        cfg = self.cfg
        pyr = batch.pyramid
        out: Dict[str, Any] = {}
        points_f, masks_f = pyr.points[1], pyr.masks[1]
        points_c, masks_c = pyr.points[-1], pyr.masks[-1]
        nf = points_f.shape[1]

        with annotate("partition"):
            parts = [
                point_to_node_partition(
                    points_f[i], points_c[i], masks_f[i], masks_c[i],
                    cfg.model.num_points_in_patch,
                )
                for i in range(2)
            ]
            p2n = [p[0] for p in parts]
            node_masks = torch.stack([p[1] for p in parts])
            node_knn_indices = torch.stack([p[2] for p in parts])
            node_knn_masks = torch.stack([p[3] for p in parts])
            node_knn_points = batched_gather(points_f, node_knn_indices, fill=0.0)

        with annotate("backbone"):
            feats_f, feats_c = self.backbone(batch.features, pyr)

        with annotate("transformer"):
            ref_feats_c, src_feats_c = self.transformer(
                points_c[0:1], points_c[1:2], feats_c[0:1], feats_c[1:2],
                masks_c[0:1], masks_c[1:2],
            )
        ref_feats_c, src_feats_c = ref_feats_c[0], src_feats_c[0]
        # rsqrt(sum^2 + eps): a norm's gradient is NaN at the masked nodes'
        # exactly-zero rows
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

        node_pair_valid = node_masks[0][:, None] & node_masks[1][None, :]
        if train or with_gt_overlaps:
            with annotate("gt_overlaps"):
                overlaps = node_overlap_matrix(
                    points_f[0], points_f[1], masks_f[0], masks_f[1], p2n[0], p2n[1],
                    _patch_membership(node_knn_indices[0], node_knn_masks[0], nf),
                    _patch_membership(node_knn_indices[1], node_knn_masks[1], nf),
                    node_knn_masks[0].sum(dim=-1), node_knn_masks[1].sum(dim=-1),
                    points_c.shape[1], points_c.shape[1],
                    batch.transform, cfg.model.ground_truth_matching_radius,
                )
                out["gt_node_overlaps"] = torch.where(node_pair_valid, overlaps, 0.0)

        # proposals from features without gradient
        with annotate("matching"):
            ref_idx_prop, src_idx_prop, _, prop_valid = superpoint_matching(
                ref_feats_c_norm.detach(), src_feats_c_norm.detach(), node_masks[0],
                node_masks[1], cfg.coarse_matching.num_correspondences,
                cfg.coarse_matching.dual_normalization,
            )
        out["ref_node_corr_indices"] = ref_idx_prop
        out["src_node_corr_indices"] = src_idx_prop
        out["node_corr_valid"] = prop_valid

        if train:  # sampled GT node pairs take the place of the proposals
            with annotate("gt_sampling"):
                ref_idx, src_idx, _, sel_valid = sample_gt_node_correspondences(
                    generator, out["gt_node_overlaps"], node_pair_valid,
                    cfg.coarse_matching.num_targets, cfg.coarse_matching.overlap_threshold,
                )
        else:
            ref_idx, src_idx, sel_valid = ref_idx_prop, src_idx_prop, prop_valid

        with annotate("patch_scores"):
            ref_knn_pts = node_knn_points[0][ref_idx]  # (P, K, 3)
            src_knn_pts = node_knn_points[1][src_idx]
            ref_knn_msk = node_knn_masks[0][ref_idx] & sel_valid[:, None]
            src_knn_msk = node_knn_masks[1][src_idx] & sel_valid[:, None]
            ref_knn_feats = batched_gather(
                feats_f[0:1], node_knn_indices[0][ref_idx][None], fill=0.0)[0]
            src_knn_feats = batched_gather(
                feats_f[1:2], node_knn_indices[1][src_idx][None], fill=0.0)[0]
            out["ref_node_corr_knn_points"] = ref_knn_pts
            out["src_node_corr_knn_points"] = src_knn_pts
            out["ref_node_corr_knn_masks"] = ref_knn_msk
            out["src_node_corr_knn_masks"] = src_knn_msk

            c = feats_f.shape[-1]
            matching_scores = torch.einsum("pkc,plc->pkl", ref_knn_feats, src_knn_feats)
            matching_scores = matching_scores / torch.sqrt(
                torch.tensor(float(c), device=matching_scores.device)
            )
        with annotate("sinkhorn"):
            matching_scores = log_optimal_transport(
                matching_scores, ref_knn_msk, src_knn_msk, self.ot_alpha,
                cfg.model.num_sinkhorn_iterations,
            )
        out["matching_scores"] = matching_scores

        if not with_transform:
            return out
        fm = cfg.fine_matching
        with annotate("LGR"):
            lgr = local_to_global_registration(
                ref_knn_pts, src_knn_pts, ref_knn_msk, src_knn_msk,
                matching_scores.detach()[:, :-1, :-1], sel_valid,
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

        rs = cfg.ransac
        with annotate("RANSAC"):
            transform, inliers = ransac_similarity(
                generator, lgr.src_corr_points, lgr.ref_corr_points, lgr.corr_valid,
                rs.distance_threshold,
                num_iterations=rs.num_iterations_train if train else rs.num_iterations_test,
                num_points=rs.num_points_train if train else rs.num_points_test,
                with_scale=rs.with_scale,
            )
        out["estimated_transform"] = transform
        out["ransac_inliers"] = inliers
        return out


def create_model(cfg: Config, device: DeviceLike = None) -> GaussRegModel:
    """The model on `device` (default cuda), in eval mode; its weights hold
    placeholders until `reset_parameters(generator)` (the trainer's
    `create_train_state`) or a checkpoint (engine/checkpoint.py) sets
    them."""
    return GaussRegModel(cfg).to(resolve_device(device)).eval()
