"""The port's model-side modules and the whole eval forward against the JAX
package, on the same numpy inputs and the same weights (model.init at
make_tiny_cfg(), carried across with params_from_flax).

Tolerances, each with its reason:
- Sinkhorn, Procrustes/Umeyama and RANSAC with the JAX draws handed in:
  f32 arithmetic in another order; 1e-4 absolute on O(1) values.
- Backbone/transformer features: both sides round neighbor features,
  influences and weighted sums to bf16, and an f32 sum taken in another
  order can land on the neighbouring bf16 value (2^-8 relative); these
  steps compound through 14 KPConvs. Tolerance 1e-2 of the features' max
  magnitude (the measured difference is about 2e-3 of it).

Discrete selections: the superpoint top-k keeps the P best of all node
pairs. Feature differences of ~1e-3 flip pairs whose dual-normalized
scores lie within a hair of the P-th best score, so the node pair sets may
differ by such near-ties, and the test checks that every differing pair
is one. Downstream values are compared on what both sides selected.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# the test run spreads files over several worker processes that share the
# host's cores; torch's default of one thread per core oversubscribes them
torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_log_optimal_transport_matches_jax():
    from gaussreg_tpu.ops.sinkhorn import log_optimal_transport as jax_ot
    from gaussreg_tpu_torch.ops.sinkhorn import log_optimal_transport

    rng = np.random.default_rng(0)
    scores = rng.normal(size=(3, 10, 12)).astype(np.float32)
    rm = rng.uniform(size=(3, 10)) > 0.2
    cm = rng.uniform(size=(3, 12)) > 0.2
    j = np.asarray(jax_ot(jnp.asarray(scores), jnp.asarray(rm), jnp.asarray(cm), 1.3, 100))
    t = log_optimal_transport(_t(scores), _t(rm), _t(cm), torch.tensor(1.3), 100).numpy()
    finite = j > -1e11
    np.testing.assert_array_equal(finite, t > -1e11)
    np.testing.assert_allclose(t[finite], j[finite], rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_scale", [True, False])
def test_procrustes_and_umeyama_match_jax(with_scale):
    from gaussreg_tpu.ops import procrustes as jp
    from gaussreg_tpu_torch.ops import procrustes as tp

    rng = np.random.default_rng(1)
    src = rng.normal(size=(6, 40, 3)).astype(np.float32)
    ref = (src @ rng.normal(size=(3, 3)).astype(np.float32) * 0.3
           + rng.normal(size=(6, 40, 3)).astype(np.float32))
    w = rng.uniform(size=(6, 40)).astype(np.float32)
    a = np.asarray(jp.umeyama_similarity(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(w),
                                         with_scale=with_scale))
    b = tp.umeyama_similarity(_t(src), _t(ref), _t(w), with_scale=with_scale).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    a = np.asarray(jp.weighted_procrustes(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(w)))
    b = tp.weighted_procrustes(_t(src), _t(ref), _t(w)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


def test_horn_rotation_matches_svd_oracle():
    from gaussreg_tpu_torch.ops.procrustes import _horn_rotation, _svd_rotation

    h = torch.from_numpy(np.random.default_rng(2).normal(size=(50, 3, 3)).astype(np.float32))
    torch.testing.assert_close(_horn_rotation(h), _svd_rotation(h), rtol=0, atol=1e-4)


def test_ransac_with_jax_draws_matches_jax():
    from gaussreg_tpu.ops.ransac import ransac_similarity as jax_ransac
    from gaussreg_tpu_torch.ops.ransac import ransac_similarity_from_samples

    rng = np.random.default_rng(3)
    c = 300
    src = rng.uniform(-1, 1, size=(c, 3)).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = 1.7 * np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    m[:3, 3] = [0.3, -0.2, 0.5]
    ref = src @ m[:3, :3].T + m[:3, 3]
    outl = rng.uniform(size=c) < 0.4
    ref[outl] = rng.uniform(-2, 2, size=(outl.sum(), 3))
    ref += rng.normal(scale=0.005, size=ref.shape)
    ref = ref.astype(np.float32)
    mask = rng.uniform(size=c) > 0.1
    key = jax.random.PRNGKey(7)
    tj, nj = jax_ransac(key, jnp.asarray(src), jnp.asarray(ref), jnp.asarray(mask), 0.05,
                        num_iterations=500, num_points=5)
    draws = jax.random.categorical(key, jnp.where(jnp.asarray(mask), 0.0, -1e30), shape=(500, 5))
    tt, nt = ransac_similarity_from_samples(_t(draws).long(), _t(src), _t(ref), _t(mask), 0.05)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def forward_pair():
    """JAX and port eval forwards on one tiny-config pair, same weights,
    the port fed the JAX pyramid."""
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu.data.pipeline import make_pair_batch
    from gaussreg_tpu.data.synthetic import random_pair
    from gaussreg_tpu.models.registration import create_model
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny
    from gaussreg_tpu_torch.data.pipeline import PairBatch, Pyramid
    from gaussreg_tpu_torch.engine.checkpoint import params_from_flax
    from gaussreg_tpu_torch.models.registration import create_model as t_create

    cfg = make_tiny_cfg()
    rp, rf, sp, sf, m = random_pair(cfg, 0)
    batch = make_pair_batch(cfg, rp, rf, sp, sf, m)
    model = create_model(cfg)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "ransac": jax.random.PRNGKey(2)},
        batch, train=False, with_transform=False,
    )
    jout = model.apply(params, batch, train=False, with_transform=True,
                       rngs={"ransac": jax.random.PRNGKey(3)})
    jout = {k: np.asarray(v) for k, v in jout.items()}

    tmodel = t_create(t_tiny(), "cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params["params"])))
    pyr = Pyramid(*[tuple(_t(a) for a in f) if isinstance(f, tuple) else _t(f)
                    for f in batch.pyramid])
    tbatch = PairBatch(pyr, _t(batch.features), _t(batch.transform))
    with torch.no_grad():  # the eval forward, as api.coarse_register_clouds runs it
        tout = tmodel(tbatch, torch.Generator().manual_seed(0))
    return cfg, jout, {k: v.numpy() for k, v in tout.items()}


def test_forward_coarse_features_match_jax(forward_pair):
    _, j, t = forward_pair
    for key in ("ref_feats_c", "src_feats_c"):
        scale = np.abs(j[key]).max()
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-2 * scale)
    np.testing.assert_array_equal(t["ref_node_masks"], j["ref_node_masks"])
    np.testing.assert_array_equal(t["src_node_masks"], j["src_node_masks"])


def _node_scores(j):
    """The JAX side's dual-normalized superpoint scores (models/matching.py)."""
    rf, sf = j["ref_feats_c"], j["src_feats_c"]
    valid = j["ref_node_masks"][:, None] & j["src_node_masks"][None, :]
    s = np.where(valid, np.exp(-np.maximum(2.0 - 2.0 * rf @ sf.T, 0.0)), 0.0)
    s = (s / np.maximum(s.sum(1, keepdims=True), 1e-12)) * (s / np.maximum(s.sum(0, keepdims=True), 1e-12))
    return np.where(valid, s, -1.0)


def test_forward_superpoint_pairs_differ_only_by_near_ties(forward_pair):
    cfg, j, t = forward_pair
    jp = set(zip(j["ref_node_corr_indices"].tolist(), j["src_node_corr_indices"].tolist()))
    tp = set(zip(t["ref_node_corr_indices"].tolist(), t["src_node_corr_indices"].tolist()))
    scores = _node_scores(j)
    cut = np.sort(scores.ravel())[::-1][cfg.coarse_matching.num_correspondences - 1]
    assert len(jp ^ tp) <= 4, (jp ^ tp)
    for pair in jp ^ tp:
        # a flipped pair sits within 1% of the cut score: a near-tie that the
        # ~1e-3 bf16 feature noise can reorder
        assert abs(scores[pair] - cut) <= 1e-2 * cut, (pair, scores[pair], cut)


def test_forward_matching_scores_and_lgr_match_jax(forward_pair):
    _, j, t = forward_pair
    jpos = {p: i for i, p in enumerate(zip(j["ref_node_corr_indices"].tolist(),
                                           j["src_node_corr_indices"].tolist()))}
    common = [(ti, jpos[p]) for ti, p in enumerate(zip(t["ref_node_corr_indices"].tolist(),
                                                       t["src_node_corr_indices"].tolist()))
              if p in jpos]
    ti, ji = map(np.array, zip(*common))
    a, b = j["matching_scores"][ji], t["matching_scores"][ti]
    finite = a > -1e11
    np.testing.assert_array_equal(finite, b > -1e11)
    # log-domain scores after 20 Sinkhorn iterations over the bf16-noisy
    # features (see the module docstring): 1e-2 absolute on values of O(1-10)
    np.testing.assert_allclose(b[finite], a[finite], rtol=0, atol=1e-2)
    np.testing.assert_allclose(t["lgr_transform"], j["lgr_transform"], rtol=0, atol=1e-3)


def test_forward_estimated_transform_with_jax_draws(forward_pair):
    """RANSAC on the forward's correspondences with the JAX draws handed in.
    The verification sets share all but the near-tie correspondences (the
    flipped node pair's and those at the set's score cut), so the draws and
    the inlier counts run over the shared correspondences on both sides."""
    from gaussreg_tpu.ops.ransac import ransac_similarity as jax_ransac
    from gaussreg_tpu_torch.ops.ransac import ransac_similarity_from_samples

    cfg, j, t = forward_pair

    def ids(o):
        return [o["ref_corr_points"][i].tobytes() + o["src_corr_points"][i].tobytes()
                if o["corr_valid"][i] else None for i in range(len(o["corr_valid"]))]

    jid, tid = ids(j), ids(t)
    tpos = {k: i for i, k in enumerate(tid) if k is not None}
    shared = np.array([k is not None and k in tpos for k in jid])
    assert shared.sum() >= 0.9 * j["corr_valid"].sum()
    key = jax.random.PRNGKey(11)
    n_it, n_pt, thr = cfg.ransac.num_iterations_test, cfg.ransac.num_points_test, cfg.ransac.distance_threshold
    tj, nj = jax_ransac(key, jnp.asarray(j["src_corr_points"]), jnp.asarray(j["ref_corr_points"]),
                        jnp.asarray(shared), thr, num_iterations=n_it, num_points=n_pt)
    draws = np.asarray(jax.random.categorical(key, jnp.where(jnp.asarray(shared), 0.0, -1e30),
                                              shape=(n_it, n_pt)))
    to_port = np.array([tpos[k] if k in tpos else 0 for k in jid])
    t_shared = np.zeros(len(tid), bool)
    t_shared[to_port[shared]] = True
    tt, nt = ransac_similarity_from_samples(
        torch.from_numpy(to_port[draws]), _t(t["src_corr_points"]), _t(t["ref_corr_points"]),
        torch.from_numpy(t_shared), thr,
    )
    assert int(nt) == int(nj)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
