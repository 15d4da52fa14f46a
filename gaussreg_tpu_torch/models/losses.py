"""Losses: weighted circle loss (coarse) and the optimal-transport negative
log-likelihood (fine) (port of gaussreg_tpu/models/losses.py).

Masked means stand where the reference indexes by boolean masks, so every
shape stays static; `_BIG` masks the weights of the circle loss.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.ops.pairwise import pairwise_sq_dist
from gaussreg_tpu_torch.ops.transforms import apply_transform

_BIG = 1e5


def _masked_mean(x, m):
    return torch.sum(torch.where(m, x, 0.0)) / torch.clamp_min(m.sum(), 1)


def weighted_circle_loss(
    pos_masks,
    neg_masks,
    feat_dists,
    pos_margin,
    neg_margin,
    pos_optimal,
    neg_optimal,
    log_scale,
    pos_scales=None,
):
    """Circle loss over (M, N) feature distances with boolean positive and
    negative masks; the pair weights carry no gradient."""
    row_masks = pos_masks.any(dim=-1) & neg_masks.any(dim=-1)
    col_masks = pos_masks.any(dim=-2) & neg_masks.any(dim=-2)

    pos_weights = feat_dists - _BIG * (~pos_masks).to(feat_dists.dtype)
    pos_weights = torch.clamp_min(pos_weights - pos_optimal, 0.0)
    if pos_scales is not None:
        pos_weights = pos_weights * pos_scales
    pos_weights = pos_weights.detach()

    neg_weights = feat_dists + _BIG * (~neg_masks).to(feat_dists.dtype)
    neg_weights = torch.clamp_min(neg_optimal - neg_weights, 0.0).detach()

    pos_logits = log_scale * (feat_dists - pos_margin) * pos_weights
    neg_logits = log_scale * (neg_margin - feat_dists) * neg_weights
    loss_row = F.softplus(
        torch.logsumexp(pos_logits, dim=-1) + torch.logsumexp(neg_logits, dim=-1)
    ) / log_scale
    loss_col = F.softplus(
        torch.logsumexp(pos_logits, dim=-2) + torch.logsumexp(neg_logits, dim=-2)
    ) / log_scale
    return (_masked_mean(loss_row, row_masks) + _masked_mean(loss_col, col_masks)) / 2.0


def coarse_matching_loss(cfg: Config, output: Dict) -> torch.Tensor:
    """Circle loss on the coarse feature distances, positives scaled by the
    square root of their GT overlap."""
    overlaps = output["gt_node_overlaps"]  # (Mr, Ms), 0 on invalid pairs
    valid = output["ref_node_masks"][:, None] & output["src_node_masks"][None, :]
    # the floor keeps sqrt' finite where two feature rows coincide
    feat_dists = torch.sqrt(torch.clamp_min(
        pairwise_sq_dist(output["ref_feats_c"], output["src_feats_c"], normalized=True), 1e-12
    ))
    cl = cfg.coarse_loss
    pos_masks = (overlaps > cl.positive_overlap) & valid
    neg_masks = (overlaps == 0.0) & valid
    pos_scales = torch.sqrt(torch.where(pos_masks, overlaps, 0.0))
    return weighted_circle_loss(
        pos_masks, neg_masks, feat_dists, cl.positive_margin, cl.negative_margin,
        cl.positive_optimal, cl.negative_optimal, cl.log_scale, pos_scales,
    )


def fine_matching_loss(cfg: Config, output: Dict, transform) -> torch.Tensor:
    """Mean negative log-likelihood, under the Sinkhorn log transport plan,
    of the GT correspondences within each patch pair and of the slack
    row/column labels of the points that have none."""
    ref_pts = output["ref_node_corr_knn_points"]  # (P, K, 3)
    ref_msk = output["ref_node_corr_knn_masks"]  # (P, K)
    src_msk = output["src_node_corr_knn_masks"]
    scores = output["matching_scores"]  # (P, K+1, K+1)

    src_t = apply_transform(output["src_node_corr_knn_points"], transform)
    d2 = pairwise_sq_dist(ref_pts, src_t)  # (P, K, K)
    gt_masks = ref_msk[:, :, None] & src_msk[:, None, :]
    gt_corr = (d2 < cfg.loss.fine_positive_radius**2) & gt_masks
    slack_row = (gt_corr.sum(dim=2) == 0) & ref_msk
    slack_col = (gt_corr.sum(dim=1) == 0) & src_msk

    p, k, _ = gt_corr.shape
    labels = torch.zeros((p, k + 1, k + 1), dtype=torch.bool, device=scores.device)
    labels[:, :k, :k] = gt_corr
    labels[:, :k, k] = slack_row
    labels[:, k, :k] = slack_col
    total = torch.sum(torch.where(labels, scores, 0.0))
    return -total / torch.clamp_min(labels.sum(), 1)


def overall_loss(cfg: Config, output: Dict, transform) -> Dict[str, torch.Tensor]:
    """{"loss", "c_loss", "f_loss"}: the weighted sum and its two terms."""
    c_loss = coarse_matching_loss(cfg, output)
    f_loss = fine_matching_loss(cfg, output, transform)
    loss = cfg.loss.weight_coarse_loss * c_loss + cfg.loss.weight_fine_loss * f_loss
    return {"loss": loss, "c_loss": c_loss, "f_loss": f_loss}
