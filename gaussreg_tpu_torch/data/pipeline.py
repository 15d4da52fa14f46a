"""Pyramid precompute for the KPConv FPN (port of gaussreg_tpu/data/pipeline.py).

The 5-level grid pyramid and its 13 neighbor index sets per pair (5 self,
4 subsampling, 4 upsampling searches) are computed on the device with
static padded capacities. The pair is a leading axis of size 2 (ref, src)
with per-level masks; index arrays use sentinel == level capacity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.ops.neighbors import grid_radius_search
from gaussreg_tpu_torch.ops.subsample import grid_subsample, spatial_sort


class Pyramid(NamedTuple):
    points: Tuple[torch.Tensor, ...]  # level l: (B, N_l, 3)
    masks: Tuple[torch.Tensor, ...]  # (B, N_l)
    neighbors: Tuple[torch.Tensor, ...]  # (B, N_l, K_l) self-level neighbors
    subsampling: Tuple[torch.Tensor, ...]  # (B, N_{l+1}, K_l) into level l
    upsampling: Tuple[torch.Tensor, ...]  # (B, N_l, min(4, K_{l+1})) into l+1
    num_voxels: Tuple[torch.Tensor, ...]  # (B,) true voxel counts
    perm0: torch.Tensor  # (B, N0) Morton permutation of the level-0 input
    search_overflow: torch.Tensor  # () int32 run entries beyond the windows


def _per_cloud(fn, *args):
    """Apply a per-cloud function over the leading batch axis and stack."""
    outs = [fn(*(a[i] for a in args)) for i in range(args[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def build_pyramid(
    points: torch.Tensor,
    mask: torch.Tensor,
    init_voxel_size: float,
    init_radius: float,
    levels: Tuple[int, ...],
    neighbor_limits: Tuple[int, ...],
    num_stages: int = 5,
    window_rows0: int = 5,
) -> Pyramid:
    """Build the pyramid for a batch of clouds (B, N0, 3): level l > 0 is a
    grid subsample at voxel_size * 2^l, each level kept in Morton order;
    self-neighbors at radius init_radius * 2^l capped at neighbor_limits[l];
    subsampling and upsampling lists between adjacent levels (upsampling at
    twice the radius, 4 wide). Each sort, subsample and search is a span
    `pair_batch.{sort,subsample}.<level>`, `pair_batch.search.{self,down,up}.<level>`."""
    if not num_stages == len(levels) == len(neighbor_limits):
        raise ValueError("num_stages, levels and neighbor_limits disagree")

    with annotate("pair_batch.sort.0"):
        points, mask, perm0 = _per_cloud(
            lambda p, m: spatial_sort(p, m, init_voxel_size), points, mask
        )
    pts = [points]
    msks = [mask]
    nvox = [mask.sum(dim=-1).to(torch.int32)]
    voxel = init_voxel_size
    for lvl in range(1, num_stages):
        voxel = voxel * 2.0
        with annotate(f"pair_batch.subsample.{lvl}"):
            p, m, nv = _per_cloud(
                lambda pp, mm: grid_subsample(pp, mm, voxel, capacity=levels[lvl]),
                pts[-1], msks[-1],
            )
        with annotate(f"pair_batch.sort.{lvl}"):
            p, m, _ = _per_cloud(lambda pp, mm: spatial_sort(pp, mm, voxel), p, m)
        pts.append(p)
        msks.append(m)
        nvox.append(nv)

    neighbors, subsampling, upsampling = [], [], []
    overflow = torch.zeros((), dtype=torch.int32, device=points.device)
    radius = init_radius
    for lvl in range(num_stages):
        rows = window_rows0 if lvl == 0 else 2
        with annotate(f"pair_batch.search.self.{lvl}"):
            nbr, of = grid_radius_search(
                pts[lvl], pts[lvl], msks[lvl], msks[lvl], radius,
                neighbor_limits[lvl], window_rows=rows,
            )
        neighbors.append(nbr)
        overflow = overflow + of
        if lvl < num_stages - 1:
            with annotate(f"pair_batch.search.down.{lvl}"):
                sub, of = grid_radius_search(
                    pts[lvl + 1], pts[lvl], msks[lvl + 1], msks[lvl], radius,
                    neighbor_limits[lvl], window_rows=rows,
                )
            subsampling.append(sub)
            overflow = overflow + of
            with annotate(f"pair_batch.search.up.{lvl}"):
                up, of = grid_radius_search(
                    pts[lvl], pts[lvl + 1], msks[lvl], msks[lvl + 1],
                    radius * 2.0, min(4, neighbor_limits[lvl + 1]),
                )
            upsampling.append(up)
            overflow = overflow + of
        radius = radius * 2.0

    return Pyramid(
        points=tuple(pts),
        masks=tuple(msks),
        neighbors=tuple(neighbors),
        subsampling=tuple(subsampling),
        upsampling=tuple(upsampling),
        num_voxels=tuple(nvox),
        perm0=perm0,
        search_overflow=overflow,
    )


class PairBatch(NamedTuple):
    """One registration pair: pyramid levels with leading axis 2 (0 = ref,
    1 = src), features (2, N0, C_in) = [opacity, R, G, B], and the (4, 4)
    GT similarity src -> ref (identity when unknown)."""

    pyramid: Pyramid
    features: torch.Tensor
    transform: torch.Tensor


def pad_cloud(points, features, capacity: int):
    """Host helper: pad (n, 3)/(n, C) numpy arrays to `capacity` rows."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"cloud of {n} points exceeds capacity {capacity}")
    p = np.zeros((capacity, 3), np.float32)
    p[:n] = points
    f = np.zeros((capacity, features.shape[1]), np.float32)
    f[:n] = features
    m = np.zeros(capacity, bool)
    m[:n] = True
    return p, f, m


def augment_pair_pose(pb: PairBatch, rng: np.random.Generator) -> PairBatch:
    """Rigid pose augmentation of a built PairBatch, on the host in numpy
    and scipy with the JAX package's draws from `rng`: independent rigid
    motions Tr, Ts move the ref and src clouds at every pyramid level.
    Rigid maps keep every distance, so the neighbour, subsampling and
    upsampling lists stay valid; the GT becomes Tr @ gt @ Ts^-1. The
    result lies on the batch's device."""
    from scipy.spatial.transform import Rotation

    tr = np.eye(4, dtype=np.float32)
    ts = np.eye(4, dtype=np.float32)
    tr[:3, :3] = Rotation.random(random_state=rng).as_matrix()
    ts[:3, :3] = Rotation.random(random_state=rng).as_matrix()
    tr[:3, 3] = rng.normal(scale=0.5, size=3)
    ts[:3, 3] = rng.normal(scale=0.5, size=3)
    both = np.stack([tr, ts])  # (2, 4, 4) per-cloud motions
    rot = both[:, :3, :3]
    off = both[:, None, :3, 3]
    dev = pb.transform.device
    pts = tuple(
        torch.from_numpy(
            (np.einsum("bnc,bdc->bnd", p.cpu().numpy().astype(np.float32), rot) + off)
            .astype(np.float32)
        ).to(dev)
        for p in pb.pyramid.points
    )
    gt = (tr @ pb.transform.cpu().numpy() @ np.linalg.inv(ts)).astype(np.float32)
    return pb._replace(pyramid=pb.pyramid._replace(points=pts),
                       transform=torch.from_numpy(gt).to(dev))


def make_pair_batch(
    cfg: Config,
    ref_points,
    ref_features,
    src_points,
    src_features,
    transform=None,
    device: DeviceLike = None,
) -> PairBatch:
    """Build a PairBatch from host numpy clouds on `device` (default cuda),
    in the span `pair_batch` (the padding and the clouds' copies to the
    device in `pair_batch.upload`, then build_pyramid's spans)."""
    with annotate("pair_batch"):
        dev = resolve_device(device)
        cap0 = cfg.capacity.levels[0]
        with annotate("pair_batch.upload"):
            rp, rf, rm = pad_cloud(ref_points, ref_features, cap0)
            sp, sf, sm = pad_cloud(src_points, src_features, cap0)
            points = torch.from_numpy(np.stack([rp, sp])).to(dev)
            feats = torch.from_numpy(np.stack([rf, sf])).to(dev)
            masks = torch.from_numpy(np.stack([rm, sm])).to(dev)
        pyramid = build_pyramid(
            points,
            masks,
            cfg.backbone.init_voxel_size,
            cfg.backbone.init_radius,
            cfg.capacity.levels,
            cfg.capacity.neighbor_limits,
            cfg.backbone.num_stages,
            window_rows0=cfg.capacity.window_rows0,
        )
        # level-0 points were Morton-sorted: apply the permutation to the features
        feats = torch.gather(feats, 1, pyramid.perm0[:, :, None].expand(-1, -1, feats.shape[2]))
        t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)
        return PairBatch(pyramid, feats, torch.from_numpy(t).to(dev))
