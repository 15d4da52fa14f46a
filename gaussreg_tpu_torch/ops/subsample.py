"""Voxel-grid subsampling, Morton sort and host furthest point sampling
(port of gaussreg_tpu/ops/subsample.py).

Points are packed into integer voxel keys, stably sorted and averaged with
a fixed-capacity segmented sum. Every sort here is stable, as jnp.argsort is,
so equal keys keep their input order exactly as in the JAX package. Scalar
divisors are passed as tensors on the points' device: a CUDA division by a
host scalar is computed as a multiplication by its reciprocal, which can
move a point across a voxel boundary. A cell size may be a Python float
(uploaded at each call) or an f32 scalar tensor already on the device
(used as it is: no copy, so no wait for the device). Nothing here reads a
value back to the host, so a build can be captured in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

_BITS = 10  # voxel coords clipped to [0, 2^10); 30-bit packed key fits int32
_CMAX = (1 << _BITS) - 1


def _cells(points: torch.Tensor, mask: torch.Tensor, cell_size) -> torch.Tensor:
    """Integer cell coordinates relative to the min valid point, clipped."""
    big = torch.finfo(points.dtype).max
    pmin = torch.where(mask[:, None], points, big).amin(dim=0)
    cs = torch.as_tensor(cell_size, dtype=points.dtype, device=points.device)
    return torch.clamp(torch.floor((points - pmin) / cs).to(torch.int32), 0, _CMAX)


def segment_lengths(seg: torch.Tensor, capacity: int) -> torch.Tensor:
    """torch.bincount(seg, minlength=capacity + 1) of a non-decreasing int64
    seg in [0, capacity]: where each value's run starts, by searchsorted,
    and the differences. bincount sizes its output from the largest value,
    which it reads back to the host; this reads nothing back."""
    starts = torch.searchsorted(seg, torch.arange(capacity + 2, device=seg.device))
    return starts[1:] - starts[:-1]


def grid_subsample(
    points: torch.Tensor, mask: torch.Tensor, voxel_size, capacity: int
):
    """Average-pool points (N, 3) with validity mask (N,) into voxels.

    Returns (out_points (C, 3), out_mask (C,), num_voxels () int32): voxel
    centroids in scrambled-key order, padded slots 0; num_voxels may exceed
    C, in which case the last voxels of the key order are dropped."""
    coords = _cells(points, mask, voxel_size)
    key = (coords[:, 0] << (2 * _BITS)) | (coords[:, 1] << _BITS) | coords[:, 2]
    # bijective 32-bit scramble, computed exactly in int64
    key = (key.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    # invalid rows sort last; 2^32 sits above every 32-bit key, so the valid
    # voxels stay one contiguous, non-decreasing block of segments
    key = torch.where(mask, key, torch.full_like(key, 1 << 32))

    order = torch.argsort(key, stable=True)
    skey = key[order]
    spts = points[order]
    svalid = mask[order]

    first = torch.cat([svalid[:1], (skey[1:] != skey[:-1]) & svalid[1:]])
    seg = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1
    num_voxels = torch.clamp_min(seg[-1] + 1, 0)

    # seg is non-decreasing (valid voxels in key order, then the overflow and
    # invalid rows in slot `capacity`), so each voxel is a contiguous run: a
    # segmented sum adds each run in order, deterministically on the card
    # (a scatter-add would use atomics) and in the JAX package's order
    seg = torch.where(svalid & (seg >= 0) & (seg < capacity), seg, capacity).long()
    lengths = segment_lengths(seg, capacity)
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    sums = torch.segment_reduce(
        torch.where(svalid[:, None], spts, zero), "sum", lengths=lengths, axis=0, unsafe=True
    )
    counts = lengths[:capacity].to(points.dtype)
    out_points = sums[:capacity] / torch.clamp_min(counts[:, None], 1.0)
    out_mask = counts > 0
    return out_points, out_mask, num_voxels


def morton_code(points: torch.Tensor, mask: torch.Tensor, cell_size) -> torch.Tensor:
    """30-bit Morton (Z-order) code per point; invalid points get 2^30."""
    c = _cells(points, mask, cell_size)

    def spread(x):  # 10 bits -> every 3rd bit of 30
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(c[:, 0]) | (spread(c[:, 1]) << 1) | (spread(c[:, 2]) << 2)
    return torch.where(mask, code, torch.full_like(code, 2**30))


def spatial_sort(points: torch.Tensor, mask: torch.Tensor, cell_size):
    """Stable sort of points into Morton order (padding last). Returns
    (points, mask, permutation)."""
    order = torch.argsort(morton_code(points, mask, cell_size), stable=True)
    return points[order], mask[order], order


def furthest_point_sample_host(points: np.ndarray, num_samples: int, seed: int = 0):
    """Host-side furthest point sampling (numpy). Uses the native C++
    library (utils/native.py) when it builds, else an O(K*N) numpy loop.
    Returns int64 indices of the selected points."""
    from gaussreg_tpu_torch.utils import native

    n = points.shape[0]
    if num_samples >= n:
        return np.arange(n)
    if native.available():
        return native.furthest_point_sample(
            np.ascontiguousarray(points, dtype=np.float32), num_samples, seed
        )

    pts = points.astype(np.float32)
    selected = np.empty(num_samples, dtype=np.int64)
    rng = np.random.default_rng(seed)
    selected[0] = rng.integers(n)
    d2 = np.sum((pts - pts[selected[0]]) ** 2, axis=1)
    for i in range(1, num_samples):
        idx = int(np.argmax(d2))
        selected[i] = idx
        nd2 = np.sum((pts - pts[idx]) ** 2, axis=1)
        np.minimum(d2, nd2, out=d2)
    return selected
