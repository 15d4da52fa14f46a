"""Superpoint matching, GT correspondence generation and local-to-global
registration, statically shaped and mask-native (port of
gaussreg_tpu/models/matching.py).

Every top-k here is a stable sort, which keeps lax.top_k's smaller-index
tie order. The mutual-top-k thresholds of a pair come from one
`kth_largest_rows_cols` call (K3's fused CUDA kernel on CUDA tensors);
`_rowwise_kth_largest` serves other callers through `select_min_k`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gaussreg_tpu_torch.ops.pairwise import masked_pairwise_sq_dist, pairwise_sq_dist
from gaussreg_tpu_torch.ops.procrustes import weighted_procrustes
from gaussreg_tpu_torch.ops.select_k import kth_largest_rows_cols, select_min_k
from gaussreg_tpu_torch.ops.transforms import apply_transform


_BIG = 1e12


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


def node_overlap_matrix(
    ref_points_f: torch.Tensor,
    src_points_f: torch.Tensor,
    ref_point_mask: torch.Tensor,
    src_point_mask: torch.Tensor,
    ref_point_to_node: torch.Tensor,
    src_point_to_node: torch.Tensor,
    ref_in_patch: torch.Tensor,
    src_in_patch: torch.Tensor,
    ref_patch_sizes: torch.Tensor,
    src_patch_sizes: torch.Tensor,
    num_ref_nodes: int,
    num_src_nodes: int,
    transform: torch.Tensor,
    pos_radius: float,
    block: int = 2048,
) -> torch.Tensor:
    """GT (M_ref, M_src) patch-overlap matrix: overlap(A, B) = 0.5 * (the
    share of patch A's points with a point of patch B within `pos_radius`
    after `transform`, plus the symmetric share of B), from one-hot
    products over blocks of `block` ref points, so that no (Nf, Nf)
    distance matrix is held. `*_in_patch` flags the points that made it into
    their node's patch; `*_patch_sizes` are the patches' point counts."""
    src_t = apply_transform(src_points_f, transform)
    r2 = pos_radius * pos_radius
    f32 = torch.float32
    ref_w = (ref_point_mask & ref_in_patch).to(f32)
    src_w = (src_point_mask & src_in_patch).to(f32)
    ref_onehot = F.one_hot(ref_point_to_node.long(), num_ref_nodes).to(f32) * ref_w[:, None]
    src_onehot = F.one_hot(src_point_to_node.long(), num_src_nodes).to(f32) * src_w[:, None]

    ref_cnt = torch.zeros((num_ref_nodes, num_src_nodes), dtype=f32, device=src_t.device)
    any_src = torch.zeros((src_t.shape[0], num_ref_nodes), dtype=torch.bool, device=src_t.device)
    for r0 in range(0, ref_points_f.shape[0], block):
        oh_blk = ref_onehot[r0 : r0 + block]  # (B, Mr)
        d2 = pairwise_sq_dist(ref_points_f[r0 : r0 + block], src_t)  # (B, Ns)
        match = (d2 < r2).to(f32) * ref_w[r0 : r0 + block, None] * src_w[None, :]
        # ref point i matched in src patch B; counted per ref node A
        any_ref = ((match @ src_onehot) > 0).to(f32)  # (B, Ms)
        ref_cnt += oh_blk.T @ any_ref
        # src point j matched in ref patch A, in any block
        any_src |= (match.T @ oh_blk) > 0  # (Ns, Mr)
    src_cnt = any_src.to(f32).T @ src_onehot  # (Mr, Ms)

    ref_sizes = torch.clamp_min(ref_patch_sizes.to(f32), 1.0)
    src_sizes = torch.clamp_min(src_patch_sizes.to(f32), 1.0)
    return 0.5 * (ref_cnt / ref_sizes[:, None] + src_cnt / src_sizes[None, :])


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise drawn with `generator`, -log(-log(u)) with u
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_gt_node_correspondences_from_gumbel(
    gumbel: torch.Tensor,
    overlaps: torch.Tensor,
    node_valid: torch.Tensor,
    num_targets: int,
    overlap_threshold: float,
):
    """Pick `num_targets` node pairs with overlap > threshold at random,
    without dynamic shapes: the top-k of the Gumbel noise over the eligible
    pairs. When no pair is eligible, the single best valid pair is. Returns
    (ref_idx (T,), src_idx (T,), overlaps (T,), valid (T,))."""
    ms = overlaps.shape[1]
    eligible = (overlaps > overlap_threshold) & node_valid
    best = torch.argmax(torch.where(node_valid, overlaps, -1.0))
    fallback = torch.zeros(overlaps.numel(), dtype=torch.bool, device=overlaps.device)
    fallback = fallback.index_fill(0, best.reshape(1), True).reshape(overlaps.shape)
    eligible = torch.where(eligible.any(), eligible, fallback)
    scores = torch.where(eligible, gumbel, -_BIG).reshape(-1)
    top_scores, flat_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, flat_idx = top_scores[:num_targets], flat_idx[:num_targets]
    ref_idx = torch.div(flat_idx, ms, rounding_mode="floor")
    src_idx = flat_idx % ms
    return ref_idx, src_idx, overlaps.reshape(-1)[flat_idx], top_scores > -_BIG / 2


def sample_gt_node_correspondences(
    generator: torch.Generator,
    overlaps: torch.Tensor,
    node_valid: torch.Tensor,
    num_targets: int,
    overlap_threshold: float,
):
    """`sample_gt_node_correspondences_from_gumbel` with the noise drawn from
    `generator` (a generator of the overlaps' device)."""
    gumbel = gumbel_noise(overlaps.shape, generator, overlaps.device)
    return sample_gt_node_correspondences_from_gumbel(
        gumbel, overlaps, node_valid, num_targets, overlap_threshold
    )


def _mutual_topk_mask(matching_scores, ref_knn_masks, src_knn_masks, k, mutual,
                      confidence_threshold):
    """Top-k (mutual) selection inside patch pairs: the exp'd (P, K, K)
    scores and the mask of the selected, confident, valid entries."""
    scores = torch.exp(matching_scores)
    p, kk, _ = scores.shape
    row_thr, col_thr = kth_largest_rows_cols(scores, k)
    ref_sel = scores >= row_thr.reshape(p, kk, 1)
    src_sel = scores >= col_thr.reshape(p, 1, kk)
    sel = (ref_sel & src_sel) if mutual else (ref_sel | src_sel)
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    return scores, sel & (scores > confidence_threshold) & mask_mat


def _top_correspondences(masked_scores, ref_knn_points, src_knn_points, max_correspondences):
    """The best `max_correspondences` entries of (P, K, K) masked scores as
    (ref_points (C, 3), src_points (C, 3), scores (C,), valid (C,))."""
    kk = masked_scores.shape[1]
    top_scores, top_idx = _topk_flat_desc(masked_scores.reshape(-1), max_correspondences)
    valid = top_scores > 0.0
    pi = torch.div(top_idx, kk * kk, rounding_mode="floor")
    ri = torch.div(top_idx, kk, rounding_mode="floor") % kk
    si = top_idx % kk
    return (
        ref_knn_points[pi, ri],
        src_knn_points[pi, si],
        torch.where(valid, top_scores, 0.0),
        valid,
    )


def point_matching_topk(
    ref_knn_points,
    src_knn_points,
    ref_knn_masks,
    src_knn_masks,
    matching_scores,
    k: int = 3,
    mutual: bool = True,
    confidence_threshold: float = 0.05,
    max_correspondences: int = 2048,
):
    """Pose-free top-k (mutual) point matching inside patch pairs: LGR's
    correspondence extraction without the transform. Returns (ref_points
    (C, 3), src_points (C, 3), scores (C,), valid (C,))."""
    scores, corr = _mutual_topk_mask(matching_scores, ref_knn_masks, src_knn_masks, k, mutual,
                                     confidence_threshold)
    return _top_correspondences(torch.where(corr, scores, 0.0), ref_knn_points, src_knn_points,
                                max_correspondences)


def dense_to_node_correspondences(
    ref_points,
    src_points,
    ref_nodes,
    src_nodes,
    corr_ref_idx,
    corr_src_idx,
    corr_valid,
    point_masks,
):
    """Aggregate dense point correspondences into a node-pair count matrix
    with overlap-proxy scores; each point belongs to its nearest node.
    Returns (counts (Mr, Ms), scores (Mr, Ms))."""
    ref_point_mask, src_point_mask = point_masks
    mr, ms = ref_nodes.shape[0], src_nodes.shape[0]
    f32 = torch.float32
    ref_p2n = torch.argmin(masked_pairwise_sq_dist(ref_points, ref_nodes, ref_point_mask, None), dim=1)
    src_p2n = torch.argmin(masked_pairwise_sq_dist(src_points, src_nodes, src_point_mask, None), dim=1)
    ref_sizes = torch.clamp_min(
        torch.zeros(mr, dtype=f32, device=ref_points.device)
        .index_add_(0, ref_p2n, ref_point_mask.to(f32)), 1.0)
    src_sizes = torch.clamp_min(
        torch.zeros(ms, dtype=f32, device=src_points.device)
        .index_add_(0, src_p2n, src_point_mask.to(f32)), 1.0)
    pair_ids = ref_p2n[corr_ref_idx] * ms + src_p2n[corr_src_idx]
    counts = (
        torch.zeros(mr * ms, dtype=f32, device=ref_points.device)
        .index_add_(0, pair_ids, corr_valid.to(f32))
        .reshape(mr, ms)
    )
    scores = 0.5 * (counts / ref_sizes[:, None] + counts / src_sizes[None, :])
    return counts, scores


def patch_overlap_ratios(
    ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks, transform, radius
):
    """Per patch pair of (P, K, 3) patches, the share of each side's valid
    points with a point of the other side within `radius` after `transform`.
    Returns (ref_overlap (P,), src_overlap (P,))."""
    src_t = apply_transform(src_knn_points, transform)
    d2 = pairwise_sq_dist(ref_knn_points, src_t)
    mask = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    close = (d2 < radius * radius) & mask
    ref_ratio = close.any(dim=2).sum(dim=1) / torch.clamp_min(ref_knn_masks.sum(dim=1), 1)
    src_ratio = close.any(dim=1).sum(dim=1) / torch.clamp_min(src_knn_masks.sum(dim=1), 1)
    return ref_ratio, src_ratio


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
    # an invalid patch pair masks all of its ref points
    scores, corr_mat = _mutual_topk_mask(matching_scores, ref_knn_masks & patch_valid[:, None],
                                         src_knn_masks, k, mutual, confidence_threshold)
    masked_scores = torch.where(corr_mat, scores, 0.0)
    num_corr_total = corr_mat.sum().to(torch.int32)
    ref_corr_points, src_corr_points, corr_scores, corr_valid = _top_correspondences(
        masked_scores, ref_knn_points, src_knn_points, max_correspondences)

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
