"""KPConv layers and blocks, batched and mask-native
(port of gaussreg_tpu/models/kpconv.py).

All ops take a leading cloud axis (B, N, ...). Kernel influences come from
a |n|^2 - 2 n.kp + |kp|^2 gram expansion; GroupNorm statistics span all
valid points of the whole batch. Every KPConv aggregation goes through
`kpconv_fused_apply` (the CUDA kernel K2 on CUDA tensors), whatever its
channel widths; the bf16 casts sit where the JAX package puts them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussreg_tpu_torch.models import initializers as init
from gaussreg_tpu_torch.ops.kpconv_kernel import kpconv_fused_apply

_SENTINEL_COORD = 1e6


@functools.lru_cache(maxsize=None)
def generate_kernel_points(num_points: int = 15, seed: int = 42) -> np.ndarray:
    """Deterministic well-spread kernel points in the unit ball, first point
    at the center, by inverse-square repulsion descent (the JAX package's
    construction, bit for bit in numpy)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(num_points, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.uniform(0.3, 1.0, size=(num_points, 1))
    pts[0] = 0.0
    lr = 0.01
    for _ in range(2000):
        diff = pts[:, None, :] - pts[None, :, :]
        d = np.linalg.norm(diff, axis=-1) + 1e-9
        np.fill_diagonal(d, np.inf)
        force = np.sum(diff / (d**3)[..., None], axis=1)
        pts += lr * force
        pts[0] = 0.0
        norms = np.linalg.norm(pts[1:], axis=1, keepdims=True)
        pts[1:] = np.where(norms > 1.0, pts[1:] / norms, pts[1:])
        lr *= 0.999
    return pts.astype(np.float32)


def batched_gather(values: torch.Tensor, indices: torch.Tensor, fill=0.0):
    """Gather (B, N, C...) at (B, M, K...) indices; sentinel index == N
    returns `fill`."""
    b, n = values.shape[:2]
    flat = values.reshape((b * n,) + values.shape[2:])
    clipped = torch.clamp_max(indices, n - 1).long()
    off = (torch.arange(b, device=values.device) * n).reshape((b,) + (1,) * (indices.dim() - 1))
    # index_select, not advanced indexing: its backward is index_add_, where
    # advanced indexing's sorts the indices first (~2 s of a make_cfg()
    # train step's 2.2 s on the H100)
    out = torch.index_select(flat, 0, (clipped + off).reshape(-1))
    out = out.reshape(indices.shape + values.shape[2:])
    sentinel = (indices == n).reshape(indices.shape + (1,) * (values.dim() - 2))
    return torch.where(sentinel, torch.as_tensor(fill, dtype=values.dtype, device=values.device), out)


def gather_bf16(s_feats, neighbor_indices):
    """Neighbour features (B, M, H, C) in bf16, the same values whichever
    comes first. Without a gradient the cast precedes the gather, as in the
    JAX package: the gather moves half the bytes. Under grad it follows the
    gather, so that the gather's backward (index_add_) sums the features'
    gradients in f32."""
    if s_feats.requires_grad:
        return batched_gather(s_feats, neighbor_indices, fill=0.0).to(torch.bfloat16)
    return batched_gather(s_feats.to(torch.bfloat16), neighbor_indices, fill=0.0)


def kpconv_geometry(q_points, s_points, neighbor_indices, kernel_points, sigma):
    """Feature-independent part of KPConv: (B, M, H, K) bf16 kernel
    influences and per-query neighbor counts, shared by every conv on the
    same neighbor list."""
    nbr = batched_gather(s_points, neighbor_indices, fill=_SENTINEL_COORD)
    nbr = nbr - q_points[:, :, None, :]  # (B, M, H, 3)
    n2 = torch.sum(nbr * nbr, dim=-1)[..., None]
    cross = torch.einsum("bmhc,kc->bmhk", nbr, kernel_points)
    k2 = torch.sum(kernel_points * kernel_points, dim=-1)
    sq = torch.clamp_min(n2 - 2.0 * cross + k2, 0.0)
    influence = torch.clamp_min(1.0 - torch.sqrt(sq) / sigma, 0.0)
    count = torch.sum(neighbor_indices != s_points.shape[1], dim=-1)
    return influence.to(torch.bfloat16), count


Geometry = Tuple[torch.Tensor, torch.Tensor]


class KPConv(nn.Module):
    """Kernel point convolution. forward(s_feats (B,N,Cin), q_points (B,M,3),
    s_points (B,N,3), neighbor_indices (B,M,H), geometry=None) -> (B,M,Cout).
    A precomputed `geometry` (influence, count) replaces this layer's own
    kernel points, as in the JAX package."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma):
        super().__init__()
        self.sigma = sigma
        self.radius = radius
        kp = generate_kernel_points(kernel_size) * radius
        self.kernel_points = nn.Parameter(torch.from_numpy(kp), requires_grad=False)
        self.weights = nn.Parameter(torch.zeros(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: weights variance_scaling(1/3, fan_in, uniform) with
        fan_in = K * Cin, bias zeros, kernel points the generated
        disposition (a parameter without gradient, as in the JAX tree)."""
        k, c_in, _ = self.weights.shape
        init.variance_scaling_uniform_(self.weights, 1.0 / 3.0, k * c_in, generator)
        init.constant_(self.bias, 0.0)
        init.fill_(self.kernel_points, torch.from_numpy(generate_kernel_points(k) * self.radius))

    def forward(self, s_feats, q_points, s_points, neighbor_indices,
                geometry: Optional[Geometry] = None):
        if geometry is None:
            geometry = kpconv_geometry(
                q_points, s_points, neighbor_indices, self.kernel_points, self.sigma
            )
        influence, count = geometry
        # bf16 features and influences, f32 accumulation inside the fused
        # aggregation
        nf = gather_bf16(s_feats, neighbor_indices)
        out = kpconv_fused_apply(nf, influence, self.weights)
        out = out / torch.clamp_min(count, 1)[..., None].to(out.dtype)
        return out + self.bias


class MaskedGroupNorm(nn.Module):
    """GroupNorm whose statistics span all valid points of the whole batch."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.norm_(self)

    def forward(self, x, mask):
        c = x.shape[-1]
        g = self.num_groups
        m = mask[..., None].to(x.dtype)
        xg = (x * m).reshape(x.shape[:-1] + (g, c // g))
        denom = torch.clamp_min(torch.sum(m), 1.0) * (c // g)
        mean = torch.sum(xg, dim=(0, 1, 3)) / denom  # (g,)
        dev2 = torch.where(mask[..., None, None], (xg - mean[:, None]) ** 2, 0.0)
        var = torch.sum(dev2, dim=(0, 1, 3)) / denom
        xg = (xg - mean[:, None]) * torch.rsqrt(var[:, None] + self.eps)
        return (xg.reshape(x.shape) * self.weight + self.bias) * m


class UnaryBlock(nn.Module):
    """Linear -> GroupNorm -> LeakyReLU(0.1)."""

    def __init__(self, in_channels, out_channels, group_norm, has_relu=True):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)
        self.norm = MaskedGroupNorm(group_norm, out_channels)
        self.has_relu = has_relu

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.dense_(self.linear, generator)
        self.norm.reset_parameters(generator)

    def forward(self, x, mask):
        x = self.norm(self.linear(x), mask)
        return F.leaky_relu(x, 0.1) if self.has_relu else x


class ConvBlock(nn.Module):
    """KPConv -> GroupNorm -> LeakyReLU(0.1)."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, group_norm):
        super().__init__()
        self.conv = KPConv(in_channels, out_channels, kernel_size, radius, sigma)
        self.norm = MaskedGroupNorm(group_norm, out_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_mask, geometry=None):
        x = self.conv(s_feats, q_points, s_points, neighbor_indices, geometry)
        return F.leaky_relu(self.norm(x, q_mask), 0.1)


def maxpool(s_feats, neighbor_indices):
    """Max over neighbors; the sentinel contributes 0."""
    return torch.amax(batched_gather(s_feats, neighbor_indices, fill=0.0), dim=2)


def nearest_upsample(s_feats, upsample_indices):
    """Features of the first (nearest) neighbor."""
    return batched_gather(s_feats, upsample_indices[:, :, :1], fill=0.0)[:, :, 0]


class ResidualBlock(nn.Module):
    """Bottleneck residual KPConv block; when `strided`, the queries live on
    the next level and the shortcut is a neighbor max-pool."""

    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma,
                 group_norm, strided=False):
        super().__init__()
        mid = out_channels // 4
        self.strided = strided
        self.unary1 = UnaryBlock(in_channels, mid, group_norm) if in_channels != mid else None
        self.conv = KPConv(mid, mid, kernel_size, radius, sigma)
        self.norm = MaskedGroupNorm(group_norm, mid)
        self.unary2 = UnaryBlock(mid, out_channels, group_norm, has_relu=False)
        self.unary_shortcut = (
            UnaryBlock(in_channels, out_channels, group_norm, has_relu=False)
            if in_channels != out_channels
            else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_mask, s_mask,
                geometry=None):
        x = self.unary1(s_feats, s_mask) if self.unary1 is not None else s_feats
        x = self.conv(x, q_points, s_points, neighbor_indices, geometry)
        x = F.leaky_relu(self.norm(x, q_mask), 0.1)
        x = self.unary2(x, q_mask)
        shortcut = maxpool(s_feats, neighbor_indices) if self.strided else s_feats
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask)
        return F.leaky_relu(x + shortcut, 0.1)
