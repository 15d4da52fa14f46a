"""The port's losses, GT matching helpers and metrics against the JAX
package, on the same inputs made with numpy from a seed.

Tolerances, each with its reason:
- The four losses and their gradients (JAX side: one `jax.value_and_grad`
  per loss in a module-scoped fixture): 1e-5 absolute on values and
  gradients of O(1) and below. Both sides run the same f32 operations;
  logsumexp and the sums over up to 64 x 80 entries add in another order,
  which moves the result by a few ulp. The gradients also hold the circle
  loss's detached pair weights: without the detach they differ.
- `node_overlap_matrix`, `dense_to_node_correspondences` and
  `patch_overlap_ratios`: exact. The counts are integers, and the inputs
  keep every distance at least 0.04 away from the radius, so no
  comparison can flip on the last bit of a distance.
- The GT sampler with JAX's own Gumbel noise handed in: the valid targets
  equal, index for index (the invalid -1e12 entries sort in another order,
  as the two sides break ties otherwise).
- `point_matching_topk`: the valid correspondences equal, in order
  (continuous scores, so no ties among them); their scores within 1e-6
  relative, as XLA's exp and torch's differ in the last bit.
- The metrics: 1e-5 relative (f32 arithmetic in another order; the
  chamfer distance and the euler angles pass through sums, atan2 and a 4x4
  inverse).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny

    return make_tiny_cfg(), t_tiny()


def _similarity(rng, scale=1.3):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = scale * q
    m[:3, 3] = rng.normal(scale=0.5, size=3)
    return m


def _loss_inputs():
    """Coarse and fine outputs as the model produces them: unit-norm
    features, overlaps with zeros and positives, random masks, a
    log-domain score tensor and patches with true correspondences."""
    rng = np.random.default_rng(0)
    mr, ms, d = 64, 80, 32
    rf = rng.normal(size=(mr, d)).astype(np.float32)
    sf = rng.normal(size=(ms, d)).astype(np.float32)
    rf /= np.linalg.norm(rf, axis=1, keepdims=True)
    sf /= np.linalg.norm(sf, axis=1, keepdims=True)
    overlaps = np.where(rng.uniform(size=(mr, ms)) < 0.7, 0.0,
                        rng.uniform(size=(mr, ms))).astype(np.float32)
    rmask = rng.uniform(size=mr) > 0.15
    smask = rng.uniform(size=ms) > 0.15
    overlaps *= rmask[:, None] & smask[None, :]

    p, k = 12, 16
    m = _similarity(rng)
    ref_pts = rng.uniform(-1, 1, size=(p, k, 3)).astype(np.float32)
    src_pts = ((ref_pts - m[:3, 3]) @ np.linalg.inv(m[:3, :3]).T).astype(np.float32)
    src_pts = src_pts[:, rng.permutation(k)]
    src_pts[:, : k // 2] += rng.normal(scale=0.5, size=(p, k // 2, 3)).astype(np.float32)
    out = {
        "ref_feats_c": rf, "src_feats_c": sf, "gt_node_overlaps": overlaps,
        "ref_node_masks": rmask, "src_node_masks": smask,
        "ref_node_corr_knn_points": ref_pts, "src_node_corr_knn_points": src_pts,
        "ref_node_corr_knn_masks": rng.uniform(size=(p, k)) > 0.2,
        "src_node_corr_knn_masks": rng.uniform(size=(p, k)) > 0.2,
        "matching_scores": rng.normal(size=(p, k + 1, k + 1)).astype(np.float32) - 2.0,
    }
    return out, m


_DIFF = ("ref_feats_c", "src_feats_c", "matching_scores")


@pytest.fixture(scope="module")
def jax_losses():
    """Every JAX loss value and its gradients with respect to the features
    and the scores, by jax.value_and_grad."""
    from gaussreg_tpu.models import losses as jl

    cfg, _ = _cfgs()
    out, m = _loss_inputs()
    rng = np.random.default_rng(1)
    circle = {
        "pos": rng.uniform(size=(30, 40)) < 0.2,
        "neg": rng.uniform(size=(30, 40)) < 0.6,
        "dists": rng.uniform(0.0, 2.0, size=(30, 40)).astype(np.float32),
        "scales": rng.uniform(size=(30, 40)).astype(np.float32),
    }
    res = {}
    f = lambda d: jl.weighted_circle_loss(jnp.asarray(circle["pos"]), jnp.asarray(circle["neg"]),
                                          d, 0.1, 1.4, 0.1, 1.4, 24.0, jnp.asarray(circle["scales"]))
    res["circle"] = jax.value_and_grad(f)(jnp.asarray(circle["dists"]))
    const = {k: jnp.asarray(v) for k, v in out.items() if k not in _DIFF}
    diff = {k: jnp.asarray(out[k]) for k in _DIFF}
    res["coarse"] = jax.value_and_grad(
        lambda d: jl.coarse_matching_loss(cfg, {**const, **d}))(diff)
    res["fine"] = jax.value_and_grad(
        lambda d: jl.fine_matching_loss(cfg, {**const, **d}, jnp.asarray(m)))(diff)
    res["overall"] = jax.value_and_grad(
        lambda d: jl.overall_loss(cfg, {**const, **d}, jnp.asarray(m))["loss"])(diff)
    parts = jl.overall_loss(cfg, {**const, **diff}, jnp.asarray(m))
    res["overall_parts"] = {k: float(v) for k, v in parts.items()}
    return out, m, circle, res


def test_weighted_circle_loss_and_gradient_match_jax(jax_losses):
    from gaussreg_tpu_torch.models.losses import weighted_circle_loss

    _, _, c, res = jax_losses
    d = _t(c["dists"]).requires_grad_()
    loss = weighted_circle_loss(_t(c["pos"]), _t(c["neg"]), d, 0.1, 1.4, 0.1, 1.4, 24.0,
                                _t(c["scales"]))
    (grad,) = torch.autograd.grad(loss, [d])
    value_j, grad_j = res["circle"]
    np.testing.assert_allclose(loss.item(), float(value_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["coarse", "fine", "overall"])
def test_matching_losses_and_gradients_match_jax(jax_losses, which):
    from gaussreg_tpu_torch.models import losses as tl

    out, m, _, res = jax_losses
    _, cfg = _cfgs()
    tout = {k: _t(v) for k, v in out.items()}
    inputs = [tout[k].requires_grad_() for k in _DIFF]
    if which == "coarse":
        loss = tl.coarse_matching_loss(cfg, tout)
    elif which == "fine":
        loss = tl.fine_matching_loss(cfg, tout, _t(m))
    else:
        parts = tl.overall_loss(cfg, tout, _t(m))
        loss = parts["loss"]
        for key, v in res["overall_parts"].items():
            np.testing.assert_allclose(parts[key].item(), v, rtol=0, atol=1e-5, err_msg=key)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    value_j, grads_j = res[which]
    np.testing.assert_allclose(loss.item(), float(value_j), rtol=0, atol=1e-5)
    for key, g in zip(_DIFF, grads):
        gj = np.asarray(grads_j[key])
        g = np.zeros_like(gj) if g is None else g.numpy()
        np.testing.assert_allclose(g, gj, rtol=0, atol=1e-5, err_msg=key)


def _overlap_scene(seed, n=300, m_nodes=12):
    """Points on a 0.1 grid (so every cross-cloud distance is either under
    0.002 or over 0.09, far from the 0.05 radius), src the ref points under
    the inverse of a similarity, random node labels and patch flags."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3) * 0.1
    ref = grid[rng.permutation(len(grid))[:n]].astype(np.float32)
    m = _similarity(rng, scale=1.0)
    src = ref[rng.permutation(n)]
    src = src[: n - 40] + rng.uniform(-5e-4, 5e-4, size=(n - 40, 3))
    src = np.concatenate([src, rng.uniform(2, 3, size=(40, 3))])
    src = ((src - m[:3, 3]) @ np.linalg.inv(m[:3, :3]).T).astype(np.float32)
    lab = lambda: rng.integers(0, m_nodes, size=n).astype(np.int32)
    return dict(
        ref_points_f=ref, src_points_f=src,
        ref_point_mask=rng.uniform(size=n) > 0.1, src_point_mask=rng.uniform(size=n) > 0.1,
        ref_point_to_node=lab(), src_point_to_node=lab(),
        ref_in_patch=rng.uniform(size=n) > 0.2, src_in_patch=rng.uniform(size=n) > 0.2,
        ref_patch_sizes=rng.integers(0, 30, size=m_nodes).astype(np.int32),
        src_patch_sizes=rng.integers(0, 30, size=m_nodes).astype(np.int32),
    ), m


@pytest.mark.parametrize("block", [64, 2048])
def test_node_overlap_matrix_matches_jax(block):
    from gaussreg_tpu.models.matching import node_overlap_matrix as jax_fn
    from gaussreg_tpu_torch.models.matching import node_overlap_matrix

    args, m = _overlap_scene(0)
    j = np.asarray(jax_fn(**{k: jnp.asarray(v) for k, v in args.items()}, num_ref_nodes=12,
                          num_src_nodes=12, transform=jnp.asarray(m), pos_radius=0.05,
                          block=block))
    t = node_overlap_matrix(**{k: _t(v) for k, v in args.items()}, num_ref_nodes=12,
                            num_src_nodes=12, transform=_t(m), pos_radius=0.05,
                            block=block).numpy()
    assert (j > 0).sum() > 20
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("threshold", [0.1, 2.0])  # 2.0: nothing eligible, the fallback
def test_gt_sampler_from_jax_gumbel_matches_jax(threshold):
    from gaussreg_tpu.models.matching import sample_gt_node_correspondences as jax_fn
    from gaussreg_tpu_torch.models.matching import sample_gt_node_correspondences_from_gumbel

    rng = np.random.default_rng(2)
    overlaps = np.where(rng.uniform(size=(20, 24)) < 0.5, 0.0,
                        rng.uniform(size=(20, 24))).astype(np.float32)
    valid = rng.uniform(size=(20, 24)) > 0.1
    key = jax.random.PRNGKey(5)
    j = [np.asarray(x) for x in jax_fn(key, jnp.asarray(overlaps), jnp.asarray(valid), 32,
                                        threshold)]
    gumbel = np.asarray(jax.random.gumbel(key, overlaps.shape))
    t = [x.numpy() for x in sample_gt_node_correspondences_from_gumbel(
        _t(gumbel), _t(overlaps), _t(valid), 32, threshold)]
    np.testing.assert_array_equal(t[3], j[3])
    v = j[3]
    assert v.sum() == (32 if threshold < 1 else 1)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(a[v], b[v])


def test_gt_sampler_draws_with_the_generator():
    from gaussreg_tpu_torch.models.matching import sample_gt_node_correspondences

    overlaps = torch.rand(10, 12, generator=torch.Generator().manual_seed(0))
    valid = torch.ones(10, 12, dtype=torch.bool)
    a = sample_gt_node_correspondences(torch.Generator().manual_seed(1), overlaps, valid, 8, 0.2)
    b = sample_gt_node_correspondences(torch.Generator().manual_seed(1), overlaps, valid, 8, 0.2)
    c = sample_gt_node_correspondences(torch.Generator().manual_seed(2), overlaps, valid, 8, 0.2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0] * 12 + a[1], c[0] * 12 + c[1])
    assert bool((overlaps[a[0], a[1]] > 0.2).all())


@pytest.mark.parametrize("mutual", [True, False])
def test_point_matching_topk_matches_jax(mutual):
    from gaussreg_tpu.models.matching import point_matching_topk as jax_fn
    from gaussreg_tpu_torch.models.matching import point_matching_topk

    rng = np.random.default_rng(3)
    p, k = 10, 16
    args = (rng.normal(size=(p, k, 3)).astype(np.float32),
            rng.normal(size=(p, k, 3)).astype(np.float32),
            rng.uniform(size=(p, k)) > 0.2, rng.uniform(size=(p, k)) > 0.2,
            (rng.normal(size=(p, k, k)) * 2.0 - 3.0).astype(np.float32))
    j = [np.asarray(x) for x in jax_fn(*map(jnp.asarray, args), k=3, mutual=mutual,
                                        confidence_threshold=0.05, max_correspondences=1000)]
    t = [x.numpy() for x in point_matching_topk(*map(_t, args), k=3, mutual=mutual,
                                                 confidence_threshold=0.05,
                                                 max_correspondences=1000)]
    np.testing.assert_array_equal(t[3], j[3])
    assert 20 < j[3].sum() < 1000
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_array_equal(a[j[3]], b[j[3]])
    np.testing.assert_allclose(t[2], j[2], rtol=1e-6, atol=0)


def test_dense_to_node_correspondences_matches_jax():
    from gaussreg_tpu.models.matching import dense_to_node_correspondences as jax_fn
    from gaussreg_tpu_torch.models.matching import dense_to_node_correspondences

    rng = np.random.default_rng(4)
    n, mr, ms, c = 200, 9, 11, 150
    args = (rng.uniform(size=(n, 3)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32),
            rng.uniform(size=(mr, 3)).astype(np.float32), rng.uniform(size=(ms, 3)).astype(np.float32),
            rng.integers(0, n, size=c), rng.integers(0, n, size=c), rng.uniform(size=c) > 0.3)
    masks = (rng.uniform(size=n) > 0.1, rng.uniform(size=n) > 0.1)
    j = jax_fn(*map(jnp.asarray, args), tuple(map(jnp.asarray, masks)))
    t = dense_to_node_correspondences(*map(_t, args), tuple(map(_t, masks)))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_patch_overlap_ratios_matches_jax():
    from gaussreg_tpu.models.matching import patch_overlap_ratios as jax_fn
    from gaussreg_tpu_torch.models.matching import patch_overlap_ratios

    args, m = _overlap_scene(5, n=160)
    ref = args["ref_points_f"].reshape(10, 16, 3)
    src = args["src_points_f"].reshape(10, 16, 3)
    rng = np.random.default_rng(6)
    rm, sm = rng.uniform(size=(10, 16)) > 0.2, rng.uniform(size=(10, 16)) > 0.2
    j = jax_fn(*map(jnp.asarray, (ref, src, rm, sm, m)), 0.05)
    t = patch_overlap_ratios(*map(_t, (ref, src, rm, sm, m)), 0.05)
    assert float(np.asarray(j[0]).max()) > 0
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=0)


def test_metrics_match_jax():
    from gaussreg_tpu.models import metrics as jm
    from gaussreg_tpu_torch.models import metrics as tm

    rng = np.random.default_rng(7)
    gt, est = _similarity(rng, 1.2), _similarity(rng, 1.25)
    est[:3, :3] = gt[:3, :3] @ _similarity(rng, 1.0)[:3, :3] * 0.02 + gt[:3, :3]
    n = 120
    raw = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    src = ((raw - gt[:3, 3]) @ np.linalg.inv(gt[:3, :3]).T).astype(np.float32)
    src += rng.normal(scale=0.01, size=src.shape).astype(np.float32)
    src[: n // 3] += rng.normal(scale=0.2, size=(n // 3, 3)).astype(np.float32)
    rmask, smask = rng.uniform(size=n) > 0.1, rng.uniform(size=n) > 0.1
    cvalid = rng.uniform(size=n) > 0.3
    J, T = lambda *a: map(jnp.asarray, a), lambda *a: map(_t, a)
    pairs = [
        (jm.inlier_ratio(*J(raw, src, cvalid, gt), 0.05),
         tm.inlier_ratio(*T(raw, src, cvalid, gt), 0.05)),
        (jm.overlap_ratio(*J(raw, src, rmask, smask, est), 0.1),
         tm.overlap_ratio(*T(raw, src, rmask, smask, est), 0.1)),
        (jm.modified_chamfer_distance(*J(raw, raw, src, gt, est), raw_mask=jnp.asarray(rmask),
                                      src_mask=jnp.asarray(smask)),
         tm.modified_chamfer_distance(*T(raw, raw, src, gt, est), raw_mask=_t(rmask),
                                      src_mask=_t(smask))),
    ]
    pairs += list(zip(jm.anisotropic_transform_error(*J(gt, est)),
                      tm.anisotropic_transform_error(*T(gt, est))))
    assert 0.1 < float(pairs[0][0]) < 1.0 and float(pairs[1][0]) > 0
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
