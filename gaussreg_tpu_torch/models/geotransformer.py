"""Geometric Transformer: pairwise-distance + triplet-angle structure
embedding feeding an RPE conditional transformer
(port of gaussreg_tpu/models/geotransformer.py).

The angular embedding is computed in row chunks so the (N, N, k, hidden)
intermediate never materializes at full size.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.models import initializers as init
from gaussreg_tpu_torch.models.transformer import (
    RPEConditionalTransformer,
    sinusoidal_embedding,
)
from gaussreg_tpu_torch.ops.pairwise import masked_pairwise_sq_dist

_BIG = 1e12


class GeometricStructureEmbedding(nn.Module):
    def __init__(self, hidden_dim, sigma_d, sigma_a, angle_k, reduction_a="max",
                 row_chunk=64):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.sigma_d = sigma_d
        self.factor_a = 180.0 / (sigma_a * np.pi)
        self.angle_k = angle_k
        self.reduction_a = reduction_a
        self.row_chunk = row_chunk
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.dense_(self.proj_d, generator)
        init.dense_(self.proj_a, generator)

    def forward(self, points, mask):
        # points: (B, N, 3), mask: (B, N)
        b, n, _ = points.shape
        k = self.angle_k
        sq = masked_pairwise_sq_dist(points, points, mask, mask)
        dist = torch.sqrt(torch.clamp_max(sq, _BIG))
        d_indices = torch.where(sq < _BIG / 2, dist, 0.0) / self.sigma_d

        # k nearest *other* points per row; the stable sort keeps
        # lax.top_k's smaller-index tie order
        eye = torch.eye(n, dtype=torch.bool, device=points.device)[None]
        sq_knn = sq.masked_fill(eye, _BIG)
        knn_indices = torch.sort(sq_knn, dim=-1, stable=True)[1][..., :k]  # (B, N, k)
        knn_points = torch.gather(
            points[:, None].expand(b, n, n, 3), 2, knn_indices[..., None].expand(b, n, k, 3)
        )
        ref_vectors = knn_points - points[:, :, None, :]  # (B, N, k, 3)

        d_emb = self.proj_d(sinusoidal_embedding(d_indices, self.hidden_dim))

        chunks = []
        for r0 in range(0, n, self.row_chunk):
            pts_chunk = points[:, r0 : r0 + self.row_chunk]  # (B, C, 3)
            refv = ref_vectors[:, r0 : r0 + self.row_chunk]  # (B, C, k, 3)
            anc = points[:, None, :, :] - pts_chunk[:, :, None, :]  # (B, C, N, 3)
            cross = torch.linalg.cross(
                refv[:, :, None, :, :].expand(-1, -1, n, -1, -1),
                anc[:, :, :, None, :].expand(-1, -1, -1, k, -1),
                dim=-1,
            )  # (B, C, N, k, 3)
            sin = torch.linalg.norm(cross, dim=-1)
            cos = torch.einsum("bckt,bcnt->bcnk", refv, anc)
            angles = torch.atan2(sin, cos)
            a_emb = self.proj_a(sinusoidal_embedding(angles * self.factor_a, self.hidden_dim))
            if self.reduction_a == "max":
                chunks.append(torch.amax(a_emb, dim=3))
            else:
                chunks.append(torch.mean(a_emb, dim=3))
        return d_emb + torch.cat(chunks, dim=1)


class GeometricTransformer(nn.Module):
    def __init__(self, input_dim, output_dim, hidden_dim, num_heads, blocks, sigma_d,
                 sigma_a, angle_k, reduction_a="max"):
        super().__init__()
        self.embedding = GeometricStructureEmbedding(
            hidden_dim, sigma_d, sigma_a, angle_k, reduction_a
        )
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.transformer = RPEConditionalTransformer(blocks, hidden_dim, num_heads)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.reset_parameters(generator)
        init.dense_(self.in_proj, generator)
        self.transformer.reset_parameters(generator)
        init.dense_(self.out_proj, generator)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_mask, src_mask):
        """Spans: `transformer.embedding` (both clouds), `transformer.layers`."""
        with annotate("transformer.embedding"):
            ref_embed = self.embedding(ref_points, ref_mask)
            src_embed = self.embedding(src_points, src_mask)
        ref_f = self.in_proj(ref_feats)
        src_f = self.in_proj(src_feats)
        with annotate("transformer.layers"):
            ref_f, src_f = self.transformer(
                ref_f, src_f, ref_embed, src_embed, ref_mask, src_mask
            )
        return self.out_proj(ref_f), self.out_proj(src_f)
