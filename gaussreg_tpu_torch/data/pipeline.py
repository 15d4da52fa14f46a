"""Pyramid precompute for the KPConv FPN (port of gaussreg_tpu/data/pipeline.py).

The 5-level grid pyramid and its 13 neighbor index sets per pair (5 self,
4 subsampling, 4 upsampling searches) are computed on the device with
static padded capacities. The pair is a leading axis of size 2 (ref, src)
with per-level masks; index arrays use sentinel == level capacity.

Every shape of the build is static and nothing in it reads a value back
to the host, so on the card `make_pair_batch` replays it as one CUDA graph
per shape; `make_pair_batch_eager` launches it op by op.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.ops import _cuda
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


# (device, init_voxel_size, init_radius, num_stages) -> (voxel sizes, radii)
_LEVEL_SCALARS: Dict[tuple, Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]] = {}


def level_scalars(device, init_voxel_size: float, init_radius: float, num_stages: int):
    """The pyramid's voxel sizes init_voxel_size * 2^l and radii
    init_radius * 2^l, l < num_stages, as f32 scalar tensors on `device`:
    each doubled level by level as a Python float, then rounded to f32 as
    torch.as_tensor(x, torch.float32) rounds it. Uploaded once for a key
    and cached, so that a build uploads no scalar (each upload waits for
    the device) and a captured build keeps the same tensors."""
    key = (torch.device(device), init_voxel_size, init_radius, num_stages)
    if key not in _LEVEL_SCALARS:
        voxels, radii = [init_voxel_size], [init_radius]
        for _ in range(1, num_stages):
            voxels.append(voxels[-1] * 2.0)
            radii.append(radii[-1] * 2.0)
        flat = torch.tensor(voxels + radii, dtype=torch.float32).to(device)
        _LEVEL_SCALARS[key] = (tuple(flat[:num_stages].unbind()),
                               tuple(flat[num_stages:].unbind()))
    return _LEVEL_SCALARS[key]


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
    twice the radius, 4 wide). The voxel sizes and radii are
    `level_scalars`' device scalars, and nothing reads a value back to the
    host. Each sort, subsample and search is a span
    `pair_batch.{sort,subsample}.<level>`, `pair_batch.search.{self,down,up}.<level>`."""
    if not num_stages == len(levels) == len(neighbor_limits):
        raise ValueError("num_stages, levels and neighbor_limits disagree")
    voxels, radii = level_scalars(points.device, init_voxel_size, init_radius, num_stages)

    with annotate("pair_batch.sort.0"):
        points, mask, perm0 = _per_cloud(
            lambda p, m: spatial_sort(p, m, voxels[0]), points, mask
        )
    pts = [points]
    msks = [mask]
    nvox = [mask.sum(dim=-1).to(torch.int32)]
    for lvl in range(1, num_stages):
        with annotate(f"pair_batch.subsample.{lvl}"):
            p, m, nv = _per_cloud(
                lambda pp, mm: grid_subsample(pp, mm, voxels[lvl], capacity=levels[lvl]),
                pts[-1], msks[-1],
            )
        with annotate(f"pair_batch.sort.{lvl}"):
            p, m, _ = _per_cloud(lambda pp, mm: spatial_sort(pp, mm, voxels[lvl]), p, m)
        pts.append(p)
        msks.append(m)
        nvox.append(nv)

    neighbors, subsampling, upsampling = [], [], []
    overflow = torch.zeros((), dtype=torch.int32, device=points.device)
    for lvl in range(num_stages):
        rows = window_rows0 if lvl == 0 else 2
        with annotate(f"pair_batch.search.self.{lvl}"):
            nbr, of = grid_radius_search(
                pts[lvl], pts[lvl], msks[lvl], msks[lvl], radii[lvl],
                neighbor_limits[lvl], window_rows=rows,
            )
        neighbors.append(nbr)
        overflow = overflow + of
        if lvl < num_stages - 1:
            with annotate(f"pair_batch.search.down.{lvl}"):
                sub, of = grid_radius_search(
                    pts[lvl + 1], pts[lvl], msks[lvl + 1], msks[lvl], radii[lvl],
                    neighbor_limits[lvl], window_rows=rows,
                )
            subsampling.append(sub)
            overflow = overflow + of
            # twice this level's radius: the next level's
            with annotate(f"pair_batch.search.up.{lvl}"):
                up, of = grid_radius_search(
                    pts[lvl], pts[lvl + 1], msks[lvl], msks[lvl + 1],
                    radii[lvl + 1], min(4, neighbor_limits[lvl + 1]),
                )
            upsampling.append(up)
            overflow = overflow + of

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


def _padded(cfg: Config, ref_points, ref_features, src_points, src_features):
    """The pair's (2, cap0, 3) points, (2, cap0, C) features and (2, cap0)
    masks, padded on the host (numpy)."""
    cap0 = cfg.capacity.levels[0]
    rp, rf, rm = pad_cloud(ref_points, ref_features, cap0)
    sp, sf, sm = pad_cloud(src_points, src_features, cap0)
    return np.stack([rp, sp]), np.stack([rf, sf]), np.stack([rm, sm])


def _build(cfg: Config, points, feats, masks) -> Tuple[Pyramid, torch.Tensor]:
    """build_pyramid on the padded pair, and the features in its level-0
    order."""
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
    return pyramid, feats


def _transform(transform, dev) -> torch.Tensor:
    t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)
    return torch.from_numpy(t).to(dev)


def make_pair_batch_eager(
    cfg: Config,
    ref_points,
    ref_features,
    src_points,
    src_features,
    transform=None,
    device: DeviceLike = None,
) -> PairBatch:
    """make_pair_batch launched op by op, on any device, in the span
    `pair_batch` (the padding and the clouds' copies to the device in
    `pair_batch.upload`, then build_pyramid's spans). make_pair_batch takes
    this path off the card; on the card it is what the graph is held
    against, and the path for a caller that interposes on the build's
    functions call by call (a replay calls none of them)."""
    with annotate("pair_batch"):
        dev = resolve_device(device)
        with annotate("pair_batch.upload"):
            points, feats, masks = (
                torch.from_numpy(a).to(dev)
                for a in _padded(cfg, ref_points, ref_features, src_points, src_features)
            )
        pyramid, feats = _build(cfg, points, feats, masks)
        return PairBatch(pyramid, feats, _transform(transform, dev))


_CAPTURES = _cuda.counter("pyramid_graph.capture")
_REPLAYS = _cuda.counter("pyramid_graph.replay")


def _cloned(pyramid: Pyramid) -> Pyramid:
    return Pyramid(*(tuple(t.clone() for t in f) if isinstance(f, tuple) else f.clone()
                     for f in pyramid))


class _PairGraph:
    """`_build` on one CUDA device as a CUDA graph: the input buffers it
    reads, the graph, the outputs each replay overwrites, and the kernel
    launches its capture recorded (a replay adds them to the counts, as an
    eager build's launches count)."""

    def __init__(self, cfg: Config, dev: torch.device, feat_dim: int):
        cap0 = cfg.capacity.levels[0]
        self.points = torch.zeros((2, cap0, 3), dtype=torch.float32, device=dev)
        self.feats = torch.zeros((2, cap0, feat_dim), dtype=torch.float32, device=dev)
        self.masks = torch.zeros((2, cap0), dtype=torch.bool, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None
        self.launches: Dict[str, int] = {}

    def capture(self, cfg: Config) -> Tuple[Pyramid, torch.Tensor]:
        """Build eagerly from the filled buffers, which loads every kernel
        and the level scalars before the capture, then capture the same
        build. Returns the eager build: the first call's result."""
        first = _build(cfg, self.points, self.feats, self.masks)
        before = _cuda.launch_counts()
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = _build(cfg, self.points, self.feats, self.masks)
        finally:
            # a capture launches nothing: its launches count at each replay
            after = _cuda.launch_counts()
            self.launches = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            _cuda.add_launches({n: -c for n, c in self.launches.items()})
        _CAPTURES.launches += 1
        return first

    def replay(self) -> Tuple[Pyramid, torch.Tensor]:
        """Replay on the current stream and return clones of the outputs,
        which the caller owns: the next replay overwrites the graph's."""
        self.graph.replay()
        _cuda.add_launches(self.launches)
        _REPLAYS.launches += 1
        pyramid, feats = self.out
        return _cloned(pyramid), feats.clone()


# shape key (see make_pair_batch) -> its _PairGraph
_GRAPHS: Dict[tuple, _PairGraph] = {}


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
    in the span `pair_batch`. Off the card, `make_pair_batch_eager`.

    On a CUDA device the build is one CUDA graph, captured at the first
    call for its key and replayed at every later one. The key holds all
    that fixes the graph's shapes and constants: the device, the
    capacities, neighbour limits, level-0 window, stages, voxel size,
    radius and feature width, and the search and subsample functions the
    build calls (a graph replays what it captured, so a caller's patch of
    one gets a capture of its own). A call pads the clouds on the host,
    copies them into the graph's input buffers and the transform to the
    device (`pair_batch.upload`), replays the graph and clones its outputs
    (`pair_batch.replay`), and returns with the card still at work. The
    first call for a key returns an eager build of the same inputs
    (build_pyramid's spans) and captures after it. The outputs are those
    of the eager build bit for bit: the same kernels in the same order on
    the same inputs."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return make_pair_batch_eager(cfg, ref_points, ref_features, src_points, src_features,
                                     transform, device=dev)
    with annotate("pair_batch"):
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with annotate("pair_batch.upload"):
            arrays = _padded(cfg, ref_points, ref_features, src_points, src_features)
            feat_dim = arrays[1].shape[-1]
            key = (dev, cfg.capacity.levels, cfg.capacity.neighbor_limits,
                   cfg.capacity.window_rows0, cfg.backbone.num_stages,
                   cfg.backbone.init_voxel_size, cfg.backbone.init_radius, feat_dim,
                   grid_radius_search, grid_subsample, spatial_sort)
            graph = _GRAPHS.get(key)
            fresh = graph is None
            if fresh:
                graph = _PairGraph(cfg, dev, feat_dim)
            for buf, a in zip((graph.points, graph.feats, graph.masks), arrays):
                buf.copy_(torch.from_numpy(a))
            # before the build: a copy from pageable memory waits for the stream
            t = _transform(transform, dev)
        with torch.cuda.device(dev):
            if fresh:
                pyramid, feats = graph.capture(cfg)
                _GRAPHS[key] = graph
            else:
                with annotate("pair_batch.replay"):
                    pyramid, feats = graph.replay()
        return PairBatch(pyramid, feats, t)
