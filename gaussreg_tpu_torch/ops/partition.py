"""Point-to-node (superpoint patch) partition
(port of gaussreg_tpu/ops/partition.py).

Every point is assigned to its nearest valid node; each node's patch is its
`point_limit` nearest assigned points, sentinel-padded with index N.
`knn_partition` and `ball_query_partition` select each node's k nearest
points through `select_min_k` (K3 on CUDA tensors), whose tie order is
lax.top_k's.
"""

from __future__ import annotations

import torch

from gaussreg_tpu_torch.ops.pairwise import masked_pairwise_sq_dist
from gaussreg_tpu_torch.ops.select_k import select_min_k

_BIG = 1e12


def point_to_node_partition(
    points: torch.Tensor,  # (N, 3)
    nodes: torch.Tensor,  # (M, 3)
    point_mask: torch.Tensor,  # (N,)
    node_mask: torch.Tensor,  # (M,)
    point_limit: int,
):
    """Returns (point_to_node (N,) int32, node_masks (M,), node_knn_indices
    (M, K) int32 with sentinel N, node_knn_masks (M, K), node_sizes (M,))."""
    n = points.shape[0]
    m = nodes.shape[0]
    sq = masked_pairwise_sq_dist(nodes, points, node_mask, point_mask)  # (M, N)
    point_to_node = torch.argmin(sq, dim=0)  # first minimum, as jnp.argmin

    # sort the points by (node, distance to it, index): a node's patch is
    # then a contiguous run. Two stable passes give the JAX package's
    # two-key stable lax.sort order.
    d_own = torch.gather(sq, 0, point_to_node[None, :])[0]
    node_key = torch.where(point_mask, point_to_node, m)
    by_dist = torch.sort(d_own, stable=True)[1]
    by_node = torch.sort(node_key[by_dist], stable=True)[1]
    idx_s = by_dist[by_node]
    node_s = node_key[idx_s].contiguous()
    starts = torch.searchsorted(node_s, torch.arange(m + 1, device=points.device))
    node_sizes = torch.diff(starts).to(torch.int32)
    node_masks = (node_sizes > 0) & node_mask

    slot = torch.arange(point_limit, device=points.device)
    pos = starts[:m, None] + slot[None, :]
    node_knn_masks = slot[None, :] < node_sizes[:, None]
    gathered = idx_s[torch.clamp(pos, 0, n - 1)]
    node_knn_indices = torch.where(node_knn_masks, gathered, n).to(torch.int32)
    return (
        point_to_node.to(torch.int32),
        node_masks,
        node_knn_indices,
        node_knn_masks,
        node_sizes,
    )


def get_point_to_node_indices(points, nodes, point_mask, node_mask):
    """Nearest valid node of every point (N,) int32, and each node's count
    of valid assigned points (M,) int32."""
    sq = masked_pairwise_sq_dist(nodes, points, node_mask, point_mask)
    indices = torch.argmin(sq, dim=0)
    counts = torch.zeros(nodes.shape[0], dtype=torch.int32, device=points.device)
    counts.index_add_(0, indices, point_mask.to(torch.int32))
    return indices.to(torch.int32), counts


def knn_partition(points, nodes, point_mask, node_mask, k: int):
    """k nearest valid points per node. Returns (sq_distances (M, k), _BIG
    where missing; indices (M, k) int32, sentinel N)."""
    n = points.shape[0]
    sq = masked_pairwise_sq_dist(nodes, points, node_mask, point_mask)
    vals, idx = select_min_k(sq.contiguous(), k)
    ok = vals < _BIG / 2
    return (torch.where(ok, vals, torch.full_like(vals, _BIG)),
            torch.where(ok, idx, n).to(torch.int32))


def ball_query_partition(points, nodes, point_mask, node_mask, radius, point_limit: int):
    """The `point_limit` nearest points per node within `radius`. Returns
    (indices (M, K) int32 sentinel N, masks (M, K), sizes (M,) int32)."""
    n = points.shape[0]
    sq, idx = knn_partition(points, nodes, point_mask, node_mask, point_limit)
    masks = sq < radius * radius
    idx = torch.where(masks, idx, n).to(torch.int32)
    return idx, masks, torch.sum(masks, dim=1).to(torch.int32)
