"""Vectorized correspondence-based RANSAC with scale
(port of gaussreg_tpu/ops/ransac.py).

The hypothesis draw is split from the rest so a test can hand in the
(iterations, points) sample indices that JAX drew: `draw_ransac_samples`
draws uniformly over the valid correspondences with a seeded
torch.Generator, `ransac_similarity_from_samples` does everything else.
"""

from __future__ import annotations

import torch

from gaussreg_tpu_torch.ops.procrustes import umeyama_similarity
from gaussreg_tpu_torch.ops.transforms import apply_transform


def draw_ransac_samples(
    corr_mask: torch.Tensor, num_iterations: int, num_points: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """(I, P) int64 indices drawn uniformly from the valid correspondences
    (from all of them when none is valid, as jax.random.categorical does
    with all logits equal)."""
    valid = torch.nonzero(corr_mask).reshape(-1)
    if valid.numel() == 0:
        valid = torch.arange(corr_mask.shape[0], device=corr_mask.device)
    pick = torch.randint(
        0, valid.numel(), (num_iterations, num_points),
        generator=generator, device=corr_mask.device,
    )
    return valid[pick]


def _inlier_counts(src_points, ref_points, corr_mask, transforms, thr2, block=1024):
    counts = []
    for i in range(0, transforms.shape[0], block):
        aligned = apply_transform(src_points[None], transforms[i : i + block])
        r2 = torch.sum((ref_points[None] - aligned) ** 2, dim=-1)
        counts.append(torch.sum((r2 < thr2) & corr_mask[None, :], dim=-1))
    return torch.cat(counts)


def ransac_similarity_from_samples(
    sample_idx: torch.Tensor,  # (I, P) correspondence indices
    src_points: torch.Tensor,  # (C, 3)
    ref_points: torch.Tensor,  # (C, 3)
    corr_mask: torch.Tensor,  # (C,) bool
    distance_threshold: float,
    with_scale: bool = True,
    refine_steps: int = 2,
):
    """Best hypothesis by inlier count, refit on its inliers `refine_steps`
    times (each refit kept only if it loses no inliers).
    Returns (transform (4, 4), inlier_count () int32)."""
    hyp = umeyama_similarity(
        src_points[sample_idx], ref_points[sample_idx], with_scale=with_scale
    )  # (I, 4, 4)
    thr2 = distance_threshold * distance_threshold
    counts = _inlier_counts(src_points, ref_points, corr_mask, hyp, thr2)
    transform = hyp[torch.argmax(counts)]

    def inliers_of(t):
        aligned = apply_transform(src_points, t)
        r2 = torch.sum((ref_points - aligned) ** 2, dim=-1)
        return (r2 < thr2) & corr_mask

    for _ in range(refine_steps):
        inliers = inliers_of(transform)
        new_t = umeyama_similarity(
            src_points, ref_points, inliers.to(src_points.dtype), with_scale=with_scale
        )
        keep = inliers_of(new_t).sum() >= inliers.sum()
        transform = torch.where(keep, new_t, transform)

    return transform, inliers_of(transform).sum().to(torch.int32)


def ransac_similarity(
    generator: torch.Generator,
    src_points: torch.Tensor,
    ref_points: torch.Tensor,
    corr_mask: torch.Tensor,
    distance_threshold: float,
    num_iterations: int = 10000,
    num_points: int = 5,
    with_scale: bool = True,
    refine_steps: int = 2,
):
    """Estimate the similarity src -> ref from padded correspondences."""
    sample_idx = draw_ransac_samples(corr_mask, num_iterations, num_points, generator)
    return ransac_similarity_from_samples(
        sample_idx, src_points, ref_points, corr_mask, distance_threshold,
        with_scale, refine_steps,
    )
