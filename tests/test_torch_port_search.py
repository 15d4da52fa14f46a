"""The port's grid radius search and pyramid against the JAX package's.

Neighbor lists must be equal entry for entry, sentinel N and overflow
count included (tolerance 0). The port is handed the JAX level points, so
float noise in a subsample cannot move a point across a radius boundary;
build_pyramid is then compared whole, subsampled points included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch


def _clouds(seed, b=2, n=900, dense=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 2.0, size=(b, n, 3)).astype(np.float32)
    if dense:
        # a tight clump: hundreds of points in one radius-sized cell column,
        # longer than the gathered window (truncated runs, overflow > 0)
        pts[:, :dense] = (1.0 + rng.normal(scale=0.01, size=(b, dense, 3))).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, n - 100 :] = False  # padding in the second cloud
    return pts, mask


def _search_both(q, s, qm, sm, radius, limit, window_rows, cell_factor=1.0):
    from gaussreg_tpu.ops.neighbors import grid_radius_search as jax_search
    from gaussreg_tpu_torch.ops.neighbors import grid_radius_search

    j = {
        kern: jax_search(
            jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm), radius, limit,
            window_rows=window_rows, select_kernel=kern, cell_factor=cell_factor,
        )
        for kern in ("fused", "topk")
    }
    t = torch.from_numpy
    p = {
        kern: grid_radius_search(
            t(q), t(s), t(qm), t(sm), radius, limit, window_rows=window_rows,
            select_kernel=kern, cell_factor=cell_factor,
        )
        for kern in ("auto", "topk")
    }
    return j, p


@pytest.mark.parametrize(
    "seed,dense,window_rows,radius,limit",
    [
        (0, 0, 2, 0.15, 24),  # plain case
        (1, 400, 2, 0.15, 35),  # runs longer than the 2-row window: truncated
        (2, 300, 1, 0.1, 16),  # 1-row windows truncate more
    ],
)
def test_grid_radius_search_matches_jax(seed, dense, window_rows, radius, limit):
    pts, mask = _clouds(seed, dense=dense)
    q, qm = pts[:, ::3], mask[:, ::3]  # a subsampling-style query set
    for qq, qqm in ((pts, mask), (q, qm)):
        j, p = _search_both(qq, pts, qqm, mask, radius, limit, window_rows)
        ref_idx, ref_of = (np.asarray(x) for x in j["fused"])
        np.testing.assert_array_equal(np.asarray(j["topk"][0]), ref_idx)
        for kern in ("auto", "topk"):
            idx, of = p[kern]
            np.testing.assert_array_equal(idx.numpy(), ref_idx)
            assert int(of) == int(ref_of)
    if dense:
        assert int(ref_of) > 0  # the truncated-window case really truncates


def test_grid_radius_search_cell_factor_two_matches_jax():
    pts, mask = _clouds(3, n=600)
    j, p = _search_both(pts, pts, mask, mask, 0.1, 20, 2, cell_factor=2.0)
    for kern in ("auto", "topk"):
        np.testing.assert_array_equal(p[kern][0].numpy(), np.asarray(j["fused"][0]))
        assert int(p[kern][1]) == int(j["fused"][1])


@pytest.mark.parametrize("cell_factor", [1.5, 1.01, 0.5])
def test_grid_radius_search_rejects_undercovering_cell_factor(cell_factor):
    """Cells smaller than 2r (but not r-sized) under-cover the query ball in
    the 2x2 neighborhood; the JAX package silently drops neighbors there,
    the port refuses."""
    from gaussreg_tpu_torch.ops.neighbors import grid_radius_search

    pts, mask = _clouds(4, n=200)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="cell_factor"):
        grid_radius_search(t(pts), t(pts), t(mask), t(mask), 0.1, 8, cell_factor=cell_factor)


def test_build_pyramid_matches_jax_tiny_cfg():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu.data.pipeline import make_pair_batch as jax_make
    from gaussreg_tpu.data.synthetic import random_pair
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch

    rp, rf, sp, sf, m = random_pair(make_tiny_cfg(), 11)
    jb = jax_make(make_tiny_cfg(), rp, rf, sp, sf, m)
    tb = make_pair_batch(t_tiny(), rp, rf, sp, sf, m, device="cpu")
    jp, tp = jb.pyramid, tb.pyramid
    for lvl in range(5):
        # level >= 1 points are voxel means: float sums, compared with a
        # tolerance of a few f32 ulps at these coordinates (~1e-6)
        np.testing.assert_allclose(tp.points[lvl].numpy(), np.asarray(jp.points[lvl]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tp.masks[lvl].numpy(), np.asarray(jp.masks[lvl]))
        np.testing.assert_array_equal(tp.neighbors[lvl].numpy(), np.asarray(jp.neighbors[lvl]))
        np.testing.assert_array_equal(tp.num_voxels[lvl].numpy(), np.asarray(jp.num_voxels[lvl]))
        if lvl < 4:
            np.testing.assert_array_equal(tp.subsampling[lvl].numpy(), np.asarray(jp.subsampling[lvl]))
            np.testing.assert_array_equal(tp.upsampling[lvl].numpy(), np.asarray(jp.upsampling[lvl]))
    np.testing.assert_array_equal(tp.perm0.numpy(), np.asarray(jp.perm0))
    assert int(tp.search_overflow) == int(jp.search_overflow)
    np.testing.assert_array_equal(tb.features.numpy(), np.asarray(jb.features))
