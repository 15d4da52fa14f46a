"""The port's library surface beyond the main path against the JAX
package's, on the CPU: the legacy "pallas" branch of grid_radius_search,
the brute-force searches and partitions, gather_padded, the transforms,
KPConv past 16 kernel points (the einsum route) with Lloyd points past 30,
knn_interpolate and global_avgpool, the transformer variants with flax
weights carried across, composite_pixels, grid_subsample_host and
segment_accumulate.

Tolerances:
- the grid search's branches: equal index for index (sentinel N and
  overflow included);
- the brute-force searches and partitions compute distances in the gram
  form |q|^2 - 2 q.s + |s|^2, which XLA and torch round differently, so two
  candidates whose distances differ only in the last bits may swap slots,
  and a candidate on the radius may fall on either side. `_swaps` allows
  exactly those (float64 distances within SWAP_TOL of each other, or of
  r^2) and counts them; the distances within 1e-6 (relative, and absolute
  for the cancellation of the gram form at coordinates of order 1);
- gather_padded, knn_interpolate, global_avgpool, the transforms: 1e-6;
- Lloyd points, grid_subsample_host, segment_accumulate against its plain
  version: equal;
- KPConvFPN at kernel_size 20 and 36: within 4e-3 of the max (K2's stated
  tolerance: one bf16 rounding step of a weighted sum);
- the transformer variants, composite_pixels: 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)  # several xdist workers share the cores

SWAP_TOL = 1e-5  # float64 squared distances that f32 gram forms cannot order


def _t(x):
    return torch.from_numpy(np.array(x))


def _pad(a, n):
    m = np.zeros(n, bool)
    m[: a.shape[0]] = True
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out, m


def _grid_cases():
    """tests/test_select_k.py's case, and a batched one with a clump longer
    than the gathered window and invalid queries and supports."""
    rng = np.random.default_rng(11)
    q, qm = _pad(rng.uniform(0, 1, size=(60, 3)).astype(np.float32), 64)
    s, sm = _pad(rng.uniform(0, 1, size=(220, 3)).astype(np.float32), 256)
    yield q[None], s[None], qm[None], sm[None], 0.12, 10
    rng = np.random.default_rng(101)
    q = rng.uniform(0, 1, size=(2, 128, 3)).astype(np.float32)
    s = rng.uniform(0, 1, size=(2, 384, 3)).astype(np.float32)
    s[0, :80] = s[0, 0] + rng.normal(scale=0.01, size=(80, 3))
    s[1, :300] = s[1, 0] + rng.normal(scale=0.02, size=(300, 3))
    qm = np.ones((2, 128), bool)
    qm[:, 70:] = False
    sm = np.ones((2, 384), bool)
    sm[:, 300:] = False
    yield q, s, qm, sm, 0.1, 12


@pytest.mark.parametrize("case", [0, 1])
def test_grid_radius_search_pallas_branch_matches_topk_and_fused(case):
    from gaussreg_tpu.ops.neighbors import grid_radius_search as jsearch
    from gaussreg_tpu_torch.ops.neighbors import grid_radius_search

    q, s, qm, sm, radius, limit = list(_grid_cases())[case]
    j_idx, j_of = jsearch(jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
                          radius, limit, select_kernel="topk")
    outs = {kern: grid_radius_search(_t(q), _t(s), _t(qm), _t(sm), radius, limit,
                                     select_kernel=kern)
            for kern in ("pallas", "topk", "fused")}
    for kern, (idx, of) in outs.items():
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx), err_msg=kern)
        assert int(of) == int(j_of), kern
    if case == 1:
        assert int(j_of) > 0  # the clump overflows its windows


def _swaps(j_idx, t_idx, d2_of, n, r2=None):
    """Slots where the two index lists differ; each must be a last-bit
    swap: both candidates at float64 squared distances within SWAP_TOL of
    each other, or (one side the sentinel) the candidate within SWAP_TOL of
    the radius^2. Returns the count."""
    bad = np.argwhere(j_idx != t_idx)
    for i, j in bad:
        a, b = j_idx[i, j], t_idx[i, j]
        if a != n and b != n:
            assert abs(d2_of(i, a) - d2_of(i, b)) <= SWAP_TOL, (i, j, a, b)
        else:
            assert r2 is not None, (i, j, a, b)
            assert abs(d2_of(i, a if a != n else b) - r2) <= SWAP_TOL, (i, j, a, b)
    return len(bad)


def _cloud_pair(seed, m=300, n=700):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, size=(m, 3)).astype(np.float32)
    s = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    s[:50] = s[0] + rng.normal(scale=0.005, size=(50, 3))  # near-ties
    q[:5] = s[:5]  # queries on support points
    qm = rng.uniform(size=m) > 0.05
    sm = rng.uniform(size=n) > 0.05
    return q, s, qm, sm


def _d2_fn(q, s):
    q64, s64 = q.astype(np.float64), s.astype(np.float64)
    return lambda i, a: float(np.sum((q64[i] - s64[a]) ** 2))


@pytest.mark.parametrize("seed,radius,limit,block", [(0, 0.1, 12, 128), (1, 0.2, 35, 1024)])
def test_radius_and_knn_search_match_jax(seed, radius, limit, block):
    from gaussreg_tpu.ops import neighbors as jn
    from gaussreg_tpu_torch.ops import neighbors as tn

    q, s, qm, sm = _cloud_pair(seed)
    n = s.shape[0]
    d2_of = _d2_fn(q, s)
    j = np.asarray(jn.radius_search(q, s, qm, sm, radius, limit, block=block))
    t = tn.radius_search(_t(q), _t(s), _t(qm), _t(sm), radius, limit, block=block).numpy()
    assert t.dtype == np.int32 and t.shape == j.shape
    assert (t[~qm] == n).all()
    swaps = _swaps(j, t, d2_of, n, r2=radius * radius)
    assert swaps <= 0.01 * t.size, swaps

    ji, jd = jn.knn_search(q, s, qm, sm, limit, block=block)
    ti, td = tn.knn_search(_t(q), _t(s), _t(qm), _t(sm), limit, block=block)
    ji, jd, ti, td = np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy()
    assert (ti[~qm] == n).all() and not np.isin(np.nonzero(~sm)[0], ti).any()
    swaps = _swaps(ji, ti, d2_of, n)
    assert swaps <= 0.01 * ti.size, swaps
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)


def test_partitions_match_jax():
    from gaussreg_tpu.ops import partition as jp
    from gaussreg_tpu_torch.ops import partition as tp

    pts, nodes, pm, nm = _cloud_pair(3, m=40, n=600)
    pts, nodes = nodes, pts  # 600 points, 40 nodes
    pm, nm = nm, pm
    n = pts.shape[0]
    d2_of = _d2_fn(nodes, pts)
    ji, jc = jp.get_point_to_node_indices(pts, nodes, pm, nm)
    ti, tc = tp.get_point_to_node_indices(_t(pts), _t(nodes), _t(pm), _t(nm))
    # the nearest node: equal up to last-bit ties of the gram form
    d2_pts = _d2_fn(pts, nodes)
    diff = np.nonzero(np.asarray(ji) != ti.numpy())[0]
    for i in diff:
        assert abs(d2_pts(i, int(ji[i])) - d2_pts(i, int(ti[i]))) <= SWAP_TOL
    if len(diff) == 0:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) == int(pm.sum())

    jd, jk = jp.knn_partition(pts, nodes, pm, nm, 16)
    td, tk = tp.knn_partition(_t(pts), _t(nodes), _t(pm), _t(nm), 16)
    assert _swaps(np.asarray(jk), tk.numpy(), d2_of, n) <= 0.01 * tk.numel()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert (tk.numpy()[~nm] == n).all() and (td.numpy()[~nm] == 1e12).all()

    radius = 0.15
    jb = jp.ball_query_partition(pts, nodes, pm, nm, radius, 24)
    tb = tp.ball_query_partition(_t(pts), _t(nodes), _t(pm), _t(nm), radius, 24)
    swaps = _swaps(np.asarray(jb[0]), tb[0].numpy(), d2_of, n, r2=radius * radius)
    assert swaps <= 0.01 * tb[0].numel()
    if swaps == 0:
        np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
        np.testing.assert_array_equal(tb[2].numpy(), np.asarray(jb[2]))
    assert tb[0].dtype == torch.int32 and tb[2].dtype == torch.int32


def test_gather_padded_knn_interpolate_global_avgpool_match_jax():
    from gaussreg_tpu.models import kpconv as jk
    from gaussreg_tpu.ops.neighbors import gather_padded as jgather
    from gaussreg_tpu_torch.models import kpconv as tk
    from gaussreg_tpu_torch.ops.neighbors import gather_padded

    rng = np.random.default_rng(5)
    vals = rng.normal(size=(50, 3, 2)).astype(np.float32)
    idx = rng.integers(0, 51, size=(7, 9)).astype(np.int32)  # 50 = sentinel
    for fill in (0.0, 1e6):
        np.testing.assert_allclose(gather_padded(_t(vals), _t(idx), fill).numpy(),
                                   np.asarray(jgather(vals, idx, fill)), rtol=1e-6, atol=1e-6)

    b, n, m, c = 2, 60, 40, 5
    s_feats = rng.normal(size=(b, n, c)).astype(np.float32)
    s_pts = rng.uniform(size=(b, n, 3)).astype(np.float32)
    q_pts = rng.uniform(size=(b, m, 3)).astype(np.float32)
    nbr = rng.integers(0, n + 1, size=(b, m, 6)).astype(np.int32)
    nbr[0, 0] = n  # all sentinel
    want = np.asarray(jk.knn_interpolate(s_feats, q_pts, s_pts, nbr, 4))
    got = tk.knn_interpolate(_t(s_feats), _t(q_pts), _t(s_pts), _t(nbr), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    mask = rng.uniform(size=(b, n)) > 0.3
    mask[1] = False  # an empty cloud
    np.testing.assert_allclose(tk.global_avgpool(_t(s_feats), _t(mask)).numpy(),
                               np.asarray(jk.global_avgpool(s_feats, mask)), rtol=1e-6, atol=1e-6)


def test_transforms_match_jax():
    from gaussreg_tpu.ops import transforms as jt
    from gaussreg_tpu_torch.ops import transforms as tt

    rng = np.random.default_rng(6)
    axis = rng.normal(size=(4, 3)).astype(np.float32)
    angle = rng.uniform(-3, 3, size=4).astype(np.float32)
    rot = np.asarray(jt.rodrigues_rotation(axis, angle))
    np.testing.assert_allclose(tt.rodrigues_rotation(_t(axis), _t(angle)).numpy(), rot,
                               rtol=1e-6, atol=1e-6)
    pts = rng.normal(size=(4, 30, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.apply_rotation(_t(pts), _t(rot)).numpy(),
                               np.asarray(jt.apply_rotation(pts, rot)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.apply_rotation(_t(pts[0]), _t(rot[0])).numpy(),
                               np.asarray(jt.apply_rotation(pts[0], rot[0])), rtol=1e-6, atol=1e-6)
    tf = np.asarray(jt.transform_from_rotation_translation(
        rot, rng.normal(size=(4, 3)).astype(np.float32)))
    inv = tt.inverse_rigid_transform(_t(tf)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jt.inverse_rigid_transform(tf)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(inv @ tf, np.broadcast_to(np.eye(4), tf.shape), atol=1e-5)

    for dev_seed in range(3):
        r = tt.random_rotation(torch.Generator().manual_seed(dev_seed), 0.5).double()
        np.testing.assert_allclose((r @ r.T).numpy(), np.eye(3), atol=1e-6)
        assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-6


def test_lloyd_kernel_points_equal_jax():
    from gaussreg_tpu.models.kpconv import generate_kernel_points_lloyd as jlloyd
    from gaussreg_tpu_torch.models.kpconv import generate_kernel_points_lloyd, kernel_points

    for k in (31, 36):
        np.testing.assert_array_equal(generate_kernel_points_lloyd(k), jlloyd(k))
    np.testing.assert_array_equal(kernel_points(36), jlloyd(36))


@pytest.fixture(scope="module")
def tiny_pyramid():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu.data.pipeline import make_pair_batch
    from gaussreg_tpu.data.synthetic import random_pair

    cfg = make_tiny_cfg()
    batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=600))
    return cfg, batch


@pytest.mark.parametrize("kernel_size", [20, 36])
def test_kpconv_fpn_past_16_kernel_points_matches_jax(tiny_pyramid, kernel_size):
    """KPConvFPN at kernel_size 20 (the einsum route: K > 16) and 36 (also
    Lloyd points) against the JAX backbone with its weights, the port fed
    the JAX pyramid: within 4e-3 of each output's max. K2 is never
    launched (there is no card here; the einsum route counts its calls)."""
    from gaussreg_tpu.models.backbone import KPConvFPN as JFPN
    from gaussreg_tpu_torch.data.pipeline import Pyramid
    from gaussreg_tpu_torch.engine.checkpoint import module_params_from_flax
    from gaussreg_tpu_torch.models import kpconv as tk
    from gaussreg_tpu_torch.models.backbone import KPConvFPN

    cfg, batch = tiny_pyramid
    bc = cfg.backbone
    kw = dict(input_dim=batch.features.shape[-1], output_dim=bc.output_dim,
              init_dim=bc.init_dim, kernel_size=kernel_size, init_radius=bc.init_radius,
              init_sigma=bc.init_sigma, group_norm=bc.group_norm)
    jmodel = JFPN(**kw)
    params = jmodel.init(jax.random.PRNGKey(kernel_size), batch.features, batch.pyramid)
    jf, jc = jmodel.apply(params, batch.features, batch.pyramid)

    tmodel = KPConvFPN(**kw)
    tmodel.load_state_dict(module_params_from_flax(
        tmodel, jax.tree_util.tree_map(np.asarray, params["params"])))
    pyr = Pyramid(*[tuple(_t(a) for a in f) if isinstance(f, tuple) else _t(f)
                    for f in batch.pyramid])
    before = tk.EinsumRoute.calls
    with torch.no_grad():
        tf, tc = tmodel(_t(batch.features), pyr)
    assert tk.EinsumRoute.calls - before == 14
    for name, t, j in (("feats_f", tf, jf), ("feats_c", tc, jc)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=4e-3 * np.abs(j).max(),
                                   err_msg=name)


def _carry(tmodule, jparams):
    from gaussreg_tpu_torch.engine.checkpoint import module_params_from_flax

    tmodule.load_state_dict(module_params_from_flax(
        tmodule, jax.tree_util.tree_map(np.asarray, jparams["params"])))
    return tmodule


def _transformer_cases():
    rng = np.random.default_rng(8)
    d, h = 32, 4
    x0 = rng.normal(size=(2, 7, d)).astype(np.float32)
    x1 = rng.normal(size=(2, 9, d)).astype(np.float32)
    v0 = np.ones((2, 7), bool)
    v0[1, 5:] = False
    v1 = np.ones((2, 9), bool)
    v1[0, 7:] = False
    e0 = rng.normal(size=(2, 7, d)).astype(np.float32)
    e1 = rng.normal(size=(2, 9, d)).astype(np.float32)
    rel = rng.integers(0, 40, size=(2, 7, 9)).astype(np.int32)  # past the bank: clamped
    return {
        "LearnablePositionalEmbedding": ((30, d), (rel,)),
        "PEMultiHeadAttention": ((d, h), (x0, x1, x1, e0, e1, v1)),
        "LRPEMultiHeadAttention": ((d, h, 30), (x0, x1, x1, rel, v1)),
        "TransformerEncoder": ((d, h, 2), (x0, v0)),
        "TransformerDecoder": ((d, h, 2), (x0, x1, v0, v1)),
        "VanillaConditionalTransformer": ((("self", "cross", "self"), d, h), (x0, x1, v0, v1)),
    }


@pytest.mark.parametrize("name", sorted(_transformer_cases()))
def test_transformer_variants_match_jax(name):
    """Each variant with the JAX module's weights (its init perturbed so
    that the zero-initialised kernels matter) carried across by
    module_params_from_flax: outputs within 1e-5."""
    import gaussreg_tpu.models.transformer as jtr
    import gaussreg_tpu_torch.models.transformer as ttr

    ctor, args = _transformer_cases()[name]
    jmod = getattr(jtr, name)(*ctor)
    params = jmod.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args])
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    want = jmod.apply(params, *[jnp.asarray(a) for a in args])
    tmod = _carry(getattr(ttr, name)(*ctor), params)
    got = tmod(*[_t(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    tmod.reset_parameters(gen)  # the flax initialisers, drawn in torch
    assert all(torch.isfinite(p).all() for p in tmod.parameters())


def test_composite_pixels_matches_jax():
    from gaussreg_tpu.gs.rasterizer.camera import look_at_camera as jlook_at
    from gaussreg_tpu.gs.rasterizer.project import project_gaussians as jproject
    from gaussreg_tpu.gs.rasterizer.reference import composite_pixels as jcomposite
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
    from gaussreg_tpu_torch.gs.rasterizer.project import project_gaussians
    from gaussreg_tpu_torch.gs.rasterizer.reference import composite_pixels

    rng = np.random.default_rng(9)
    n = 60
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(-2.0, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    sh = rng.normal(scale=0.3, size=(n, 3, 16)).astype(np.float32)
    kw = dict(eye=[0, 0, -4.0], target=[0, 0, 0], up=[0, 1, 0], fov_deg=60, width=40, height=30)
    pj = jproject(*[jnp.asarray(a) for a in (means, scales, quats, opac, sh)], jlook_at(**kw))
    pt = project_gaussians(*[_t(a) for a in (means, scales, quats, opac, sh)], look_at_camera(**kw))
    px = (np.stack(np.meshgrid(np.arange(40), np.arange(30), indexing="xy"), -1) + 0.5)
    px = px.astype(np.float32)
    order = np.argsort(np.where(np.asarray(pj.valid), np.asarray(pj.depths), np.inf),
                       kind="stable").astype(np.int32)
    jr, jt = jcomposite(jnp.asarray(px), jnp.asarray(order), pj)
    tr, tt = composite_pixels(_t(px), _t(order).long(), pt)
    assert tr.shape == (30, 40, 4) and tt.shape == (30, 40)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


def test_grid_subsample_host_equals_jax():
    from gaussreg_tpu.utils import native as jnative
    from gaussreg_tpu_torch.utils import native

    rng = np.random.default_rng(10)
    pts = rng.uniform(-1, 1, size=(5000, 3)).astype(np.float32)
    for capacity in (10_000, 100):
        want, total = jnative.grid_subsample_host(pts, 0.1, capacity)
        got, got_total = native.grid_subsample_host(pts, 0.1, capacity)
        assert got_total == total
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "unsorted_empty", "dropped", "one_run",
                                  "boundary_runs"])
def test_segment_accumulate_matches_jax_kernel(case):
    """The public K6 signature on the CPU (its plain version): equal to a
    sequential scatter-add in row order, and to the interpreted Pallas
    kernel within the bound of tests/test_torch_port_raster.py's plain
    test (the kernel's one-hot product adds each 128-row block at once).
    `one_run` puts every row on one id; `boundary_runs` makes runs of 15-17
    and 31-33 rows, either side of the CUDA entry's 16-row batches and its
    32-row register path."""
    from gaussreg_tpu.gs.rasterizer.accumulate import segment_accumulate as jseg
    from gaussreg_tpu_torch.gs.rasterizer.accumulate import segment_accumulate

    rng = np.random.default_rng(12)
    r, num_out = 128 * 10, 257
    rows = rng.normal(size=(r, 16)).astype(np.float32)
    gid = rng.integers(0, num_out, size=r).astype(np.int32)
    if case == "unsorted_empty":
        gid = rng.permutation(np.repeat(np.arange(0, num_out, 3), 15)[:r]).astype(np.int32)
    elif case == "dropped":
        gid[::3] = num_out
    elif case == "one_run":
        gid[:] = 100
    elif case == "boundary_runs":
        lengths = np.resize([15, 16, 17, 31, 32, 33], 48)  # 1 152 rows, then 128 more
        ids = rng.permutation(num_out)[:lengths.size + 1]
        runs = np.repeat(ids[:-1], lengths)
        gid = rng.permutation(np.concatenate([runs, np.repeat(ids[-1:], r - runs.size)]))
        gid = gid.astype(np.int32)
    out = segment_accumulate(_t(rows), _t(gid), num_out)
    seq = torch.zeros((num_out, 16))
    for i in range(r):
        if gid[i] < num_out:
            seq[gid[i]] += _t(rows[i])
    assert torch.equal(out, seq)
    want = np.asarray(jseg(jnp.asarray(rows), jnp.asarray(gid), num_out, interpret=True))
    longest = np.bincount(gid).max()
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5 * np.abs(rows).max() * longest)
