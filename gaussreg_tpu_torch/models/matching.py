"""Superpoint matching and local-to-global registration, statically shaped
and mask-native (port of the eval-path parts of gaussreg_tpu/models/matching.py).

Every top-k here is a stable sort, which keeps lax.top_k's smaller-index
tie order. The mutual-top-k thresholds of a pair come from one
`kth_largest_rows_cols` call (K3's fused CUDA kernel on CUDA tensors);
`_rowwise_kth_largest` serves other callers through `select_min_k`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussreg_tpu_torch.ops.pairwise import pairwise_sq_dist
from gaussreg_tpu_torch.ops.procrustes import weighted_procrustes
from gaussreg_tpu_torch.ops.select_k import kth_largest_rows_cols, select_min_k
from gaussreg_tpu_torch.ops.transforms import apply_transform


def _topk_flat_desc(flat: torch.Tensor, k: int):
    """Descending top-k of a flat non-negative array. The JAX package uses
    an unstable sort here (ties are masked zeros or equal scores whose
    order is immaterial); the stable sort puts equal values in index order."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def _rowwise_kth_largest(scores: torch.Tensor, k: int):
    """k-th largest per row of (R, W) scores: the mutual-top-k threshold."""
    vals, _ = select_min_k(-scores.contiguous(), k)
    return -vals[:, k - 1]


def superpoint_matching(
    ref_feats: torch.Tensor,
    src_feats: torch.Tensor,
    ref_mask: torch.Tensor,
    src_mask: torch.Tensor,
    num_correspondences: int,
    dual_normalization: bool = True,
):
    """Global top-k superpoint correspondence proposal over L2-normalized
    features. Returns (ref_indices (P,), src_indices (P,), scores (P,),
    valid (P,))."""
    pair_valid = ref_mask[:, None] & src_mask[None, :]
    scores = torch.exp(-pairwise_sq_dist(ref_feats, src_feats, normalized=True))
    scores = torch.where(pair_valid, scores, 0.0)
    if dual_normalization:
        ref_norm = scores / torch.clamp_min(torch.sum(scores, dim=1, keepdim=True), 1e-12)
        src_norm = scores / torch.clamp_min(torch.sum(scores, dim=0, keepdim=True), 1e-12)
        scores = ref_norm * src_norm
    scores = torch.where(pair_valid, scores, -1.0)
    corr_scores, corr_indices = torch.sort(scores.reshape(-1), descending=True, stable=True)
    corr_scores = corr_scores[:num_correspondences]
    corr_indices = corr_indices[:num_correspondences]
    ns = src_feats.shape[0]
    ref_idx = torch.div(corr_indices, ns, rounding_mode="floor")
    src_idx = corr_indices % ns
    return ref_idx, src_idx, corr_scores, corr_scores > 0.0


class LGRResult(NamedTuple):
    ref_corr_points: torch.Tensor  # (C, 3)
    src_corr_points: torch.Tensor  # (C, 3)
    corr_scores: torch.Tensor  # (C,)
    corr_valid: torch.Tensor  # (C,)
    transform: torch.Tensor  # (4, 4)
    num_correspondences: torch.Tensor  # () int32, count before the cap


def local_to_global_registration(
    ref_knn_points: torch.Tensor,  # (P, K, 3)
    src_knn_points: torch.Tensor,  # (P, K, 3)
    ref_knn_masks: torch.Tensor,  # (P, K)
    src_knn_masks: torch.Tensor,  # (P, K)
    matching_scores: torch.Tensor,  # (P, K, K) log-domain, dustbin stripped
    patch_valid: torch.Tensor,  # (P,)
    k: int = 3,
    acceptance_radius: float = 0.1,
    mutual: bool = True,
    confidence_threshold: float = 0.05,
    correspondence_threshold: int = 3,
    num_refinement_steps: int = 5,
    max_correspondences: int = 2048,
    max_patch_correspondences: int = 128,
) -> LGRResult:
    """Local-to-global registration: mutual top-k correspondences, a global
    verification set of the best `max_correspondences`, one weighted
    Procrustes hypothesis per patch, best hypothesis by inliers, then
    iteratively re-weighted refinement."""
    p, kk, _ = matching_scores.shape
    scores = torch.exp(matching_scores)
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]

    row_thr, col_thr = kth_largest_rows_cols(scores, k)
    ref_sel = scores >= row_thr.reshape(p, kk, 1)
    src_sel = scores >= col_thr.reshape(p, 1, kk)
    sel = (ref_sel & src_sel) if mutual else (ref_sel | src_sel)
    corr_mat = sel & (scores > confidence_threshold) & mask_mat
    corr_mat = corr_mat & patch_valid[:, None, None]

    masked_scores = torch.where(corr_mat, scores, 0.0)
    num_corr_total = corr_mat.sum().to(torch.int32)

    top_scores, top_idx = _topk_flat_desc(masked_scores.reshape(-1), max_correspondences)
    corr_valid = top_scores > 0.0
    pi = torch.div(top_idx, kk * kk, rounding_mode="floor")
    ri = torch.div(top_idx, kk, rounding_mode="floor") % kk
    si = top_idx % kk
    ref_corr_points = ref_knn_points[pi, ri]
    src_corr_points = src_knn_points[pi, si]
    corr_scores = torch.where(corr_valid, top_scores, 0.0)

    pk = min(max_patch_correspondences, kk * kk)
    patch_scores, patch_idx = torch.sort(
        masked_scores.reshape(p, kk * kk), dim=1, descending=True, stable=True
    )
    patch_scores, patch_idx = patch_scores[:, :pk], patch_idx[:, :pk]
    pri = torch.div(patch_idx, kk, rounding_mode="floor")
    psi = patch_idx % kk
    batch_ref = torch.gather(ref_knn_points, 1, pri[..., None].expand(-1, -1, 3))
    batch_src = torch.gather(src_knn_points, 1, psi[..., None].expand(-1, -1, 3))
    hyp = weighted_procrustes(batch_src, batch_ref, torch.clamp_min(patch_scores, 0.0))

    r2 = acceptance_radius * acceptance_radius
    aligned = apply_transform(src_corr_points[None], hyp)  # (P, C, 3)
    resid2 = torch.sum((ref_corr_points[None] - aligned) ** 2, dim=-1)
    inlier = (resid2 < r2) & corr_valid[None, :]
    hyp_valid = corr_mat.sum(dim=(1, 2)) >= correspondence_threshold
    inlier_counts = torch.where(hyp_valid, inlier.sum(dim=1), -1)
    best = torch.argmax(inlier_counts)

    cur_scores = corr_scores * inlier[best].to(corr_scores.dtype)
    transform = None
    for _ in range(num_refinement_steps):
        transform = weighted_procrustes(src_corr_points, ref_corr_points, cur_scores)
        res2 = torch.sum((ref_corr_points - apply_transform(src_corr_points, transform)) ** 2, dim=-1)
        cur_scores = corr_scores * ((res2 < r2) & corr_valid).to(corr_scores.dtype)

    return LGRResult(
        ref_corr_points=ref_corr_points,
        src_corr_points=src_corr_points,
        corr_scores=corr_scores,
        corr_valid=corr_valid,
        transform=transform,
        num_correspondences=num_corr_total,
    )
