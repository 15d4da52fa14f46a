"""Point-to-node (superpoint patch) partition
(port of gaussreg_tpu/ops/partition.py: point_to_node_partition).

Every point is assigned to its nearest valid node; each node's patch is its
`point_limit` nearest assigned points, sentinel-padded with index N.
"""

from __future__ import annotations

import torch

from gaussreg_tpu_torch.ops.pairwise import masked_pairwise_sq_dist


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
