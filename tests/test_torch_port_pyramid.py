"""The pyramid's build without host reads (gaussreg_tpu_torch/data/pipeline.py,
ops/subsample.py): the segment count that replaces torch.bincount, the
cached per-level scalars, and build_pyramid on those scalars against the
same build with Python floats. Each must be exact (tolerance 0): on the card
the build is captured as a CUDA graph and must give the eager outputs.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # several xdist workers share the cores


def _sorted_segments(rng, n, capacity, invalid):
    """A non-decreasing int64 seg of n rows in [0, capacity]: runs of valid
    voxels (some past the capacity, so in its slot), then `invalid` rows in
    the overflow slot, as grid_subsample makes it."""
    valid = n - invalid
    seg = np.sort(rng.integers(0, capacity + 3, size=valid))
    seg = np.minimum(seg, capacity)
    return torch.from_numpy(np.concatenate([seg, np.full(invalid, capacity)]).astype(np.int64))


@pytest.mark.parametrize("n,capacity,invalid", [
    (500, 64, 0),  # some voxels past the capacity: its slot counts them
    (500, 64, 120),  # padding rows in the overflow slot
    (300, 1, 40),  # capacity 1
    (200, 32, 200),  # an all-invalid cloud: every row in the overflow slot
    (1000, 700, 10),  # more slots than distinct values: empty slots between runs
])
def test_segment_lengths_equal_bincount(n, capacity, invalid):
    from gaussreg_tpu_torch.ops.subsample import segment_lengths

    rng = np.random.default_rng(n + capacity + invalid)
    seg = _sorted_segments(rng, n, capacity, invalid)
    got = segment_lengths(seg, capacity)
    want = torch.bincount(seg, minlength=capacity + 1)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("voxel,radius,stages", [(0.025, 0.0625, 5), (0.1, 0.3, 4), (0.03, 0.07, 5)])
def test_level_scalars_are_the_floats_rounded(voxel, radius, stages):
    from gaussreg_tpu_torch.data.pipeline import level_scalars

    voxels, radii = level_scalars("cpu", voxel, radius, stages)
    assert len(voxels) == len(radii) == stages
    v, r = voxel, radius
    for lvl in range(stages):
        for got, x in ((voxels[lvl], v), (radii[lvl], r)):
            want = torch.as_tensor(x, dtype=torch.float32)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert got.view(torch.int32) == want.view(torch.int32), (lvl, x)
        v, r = v * 2.0, r * 2.0
    # one upload per key: the same tensors at the next call
    again = level_scalars("cpu", voxel, radius, stages)
    assert all(a is b for a, b in zip(voxels + radii, again[0] + again[1]))


def _float_pyramid(points, mask, voxel, radius, levels, limits, stages, window_rows0):
    """build_pyramid's loop with the voxel sizes and radii as Python floats,
    each doubled from the last, as library callers pass them."""
    from gaussreg_tpu_torch.data.pipeline import _per_cloud
    from gaussreg_tpu_torch.ops.neighbors import grid_radius_search
    from gaussreg_tpu_torch.ops.subsample import grid_subsample, spatial_sort

    points, mask, perm0 = _per_cloud(lambda p, m: spatial_sort(p, m, voxel), points, mask)
    pts, msks, nvox = [points], [mask], [mask.sum(dim=-1).to(torch.int32)]
    for lvl in range(1, stages):
        voxel = voxel * 2.0
        p, m, nv = _per_cloud(lambda pp, mm: grid_subsample(pp, mm, voxel, capacity=levels[lvl]),
                              pts[-1], msks[-1])
        p, m, _ = _per_cloud(lambda pp, mm: spatial_sort(pp, mm, voxel), p, m)
        pts.append(p)
        msks.append(m)
        nvox.append(nv)
    lists = {"neighbors": [], "subsampling": [], "upsampling": []}
    overflow = torch.zeros((), dtype=torch.int32)
    for lvl in range(stages):
        rows = window_rows0 if lvl == 0 else 2
        searches = [("neighbors", pts[lvl], pts[lvl], msks[lvl], msks[lvl], radius, limits[lvl],
                     rows)]
        if lvl < stages - 1:
            searches += [
                ("subsampling", pts[lvl + 1], pts[lvl], msks[lvl + 1], msks[lvl], radius,
                 limits[lvl], rows),
                ("upsampling", pts[lvl], pts[lvl + 1], msks[lvl], msks[lvl + 1], radius * 2.0,
                 min(4, limits[lvl + 1]), 2),
            ]
        for name, q, s, qm, sm, r, k, w in searches:
            idx, of = grid_radius_search(q, s, qm, sm, r, k, window_rows=w)
            lists[name].append(idx)
            overflow = overflow + of
        radius = radius * 2.0
    return dict(points=pts, masks=msks, num_voxels=nvox, perm0=perm0, search_overflow=overflow,
                **lists)


@pytest.mark.parametrize("seed", [3, 8])
def test_build_pyramid_on_device_scalars_equals_the_float_build(seed):
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import _padded, build_pyramid
    from gaussreg_tpu_torch.data.synthetic import random_pair

    cfg = make_tiny_cfg()
    points, _, masks = (torch.from_numpy(a) for a in _padded(cfg, *random_pair(cfg, seed)[:4]))
    args = (cfg.backbone.init_voxel_size, cfg.backbone.init_radius, cfg.capacity.levels,
            cfg.capacity.neighbor_limits, cfg.backbone.num_stages, cfg.capacity.window_rows0)
    got = build_pyramid(points, masks, *args[:5], window_rows0=args[5])
    want = _float_pyramid(points, masks, *args)
    for field, value in want.items():
        mine = getattr(got, field)
        for a, b in zip(mine, value) if isinstance(value, list) else [(mine, value)]:
            assert a.dtype == b.dtype and torch.equal(a, b), field
