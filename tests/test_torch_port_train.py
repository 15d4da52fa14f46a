"""The port's training path against the JAX package on the CPU: the
train-mode forward, its losses and gradients, the optimizer, checkpoints
with optimizer state, the initialisers and the pose augmentation.

The model runs at make_tiny_cfg() on one pair of 500-point clouds
(`random_pair(cfg, 0, num_points=500)`), the pyramid built by the port and
handed to both sides, weights from the JAX init (`params_from_flax`), and
the same numpy Gumbel noise for the GT node-pair draw on both sides (the
JAX model's `sample_gt_node_correspondences` replaced, for this test, by
a twin that reads the noise instead of its key). Two weight sets: the JAX
init ("init"), and the init with every zero-initialised kernel (the
residual branches' last Dense layers) drawn at random ("moved"), so that
the attention layers, which sit behind those kernels, get gradients too.
The JAX side is one jitted `jax.value_and_grad` in a module-scoped
fixture.

Tolerances, each with its reason:
- Losses (loss, c_loss, f_loss): each within 3x LOSS_SENSITIVITY of
  itself, the largest relative change of the port's own losses when
  every weight moves by 1e-6 of itself (measured 1.6e-4). Both sides round
  the backbone's neighbour features, influences and weighted sums to
  bf16, and an f32 sum in another order can land on the neighbouring bf16
  value, so the coarse features differ by ~2e-3 of their max; the losses
  differ by up to 1.8e-4 of themselves (measured).
- GT node overlaps and the sampled node pairs: exact (they depend on the
  points only).
- Gradients, per module (the parameters of one backbone block, one
  transformer layer, the embedding, the in/out projections, ot_alpha):
  the relative Frobenius distance to JAX's within 3x the port's own
  sensitivity (SENSITIVITY), measured as chip_smoke.py's "k2 backward"
  measures the backbone's: the largest distance between the port's gradients and those with every
  weight moved by 1e-6 of itself (N(0, 1) factors, five seeds, both
  weight sets). The backbone's gradients are chaotic in the forward's last
  bits (bf16 roundings flip, LeakyReLU pre-activations cross zero), so a
  tighter bound would test the rounding order, not the port.
- The optimizer against optax over 12 steps: parameters and moments within
  1e-6 relative (f32 in another order: measured 4e-7).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

# the largest relative change of the port's losses, and of each module's
# gradients (relative Frobenius distance), when every weight moves by 1e-6
# of itself: five seeds, both weight sets (tools: this file's
# `measure_sensitivity`)
LOSS_SENSITIVITY = 1.6e-4
SENSITIVITY = {
    "backbone.decoder2": 0.001,
    "backbone.decoder3": 0.0058,
    "backbone.decoder4": 0.013,
    "backbone.encoder1_1": 0.075,
    "backbone.encoder1_2": 0.031,
    "backbone.encoder2_1": 0.047,
    "backbone.encoder2_2": 0.031,
    "backbone.encoder2_3": 0.028,
    "backbone.encoder3_1": 0.035,
    "backbone.encoder3_2": 0.068,
    "backbone.encoder3_3": 0.053,
    "backbone.encoder4_1": 0.12,
    "backbone.encoder4_2": 0.097,
    "backbone.encoder4_3": 0.093,
    "backbone.encoder5_1": 0.081,
    "backbone.encoder5_2": 0.062,
    "backbone.encoder5_3": 0.048,
    "ot_alpha": 0.00015,
    "transformer.embedding": 0.07,
    "transformer.in_proj": 0.068,
    "transformer.out_proj": 0.08,
    "transformer.transformer.layers.0": 0.071,
    "transformer.transformer.layers.1": 0.073,
    "transformer.transformer.layers.2": 0.074,
    "transformer.transformer.layers.3": 0.075,
    "transformer.transformer.layers.4": 0.078,
    "transformer.transformer.layers.5": 0.081,
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny

    return make_tiny_cfg(), t_tiny()


def _jax_batch(pb):
    from gaussreg_tpu.data.pipeline import PairBatch, Pyramid

    conv = lambda f: tuple(jnp.asarray(a.numpy()) for a in f) if isinstance(f, tuple) \
        else jnp.asarray(f.numpy())
    return PairBatch(Pyramid(*[conv(f) for f in pb.pyramid]), jnp.asarray(pb.features.numpy()),
                     jnp.asarray(pb.transform.numpy()))


def _jax_sampler(gumbel):
    """The JAX sampler with `gumbel` in place of jax.random.gumbel(key)."""

    def sample(key, overlaps, node_valid, num_targets, overlap_threshold):
        ms = overlaps.shape[1]
        eligible = (overlaps > overlap_threshold) & node_valid
        best = jnp.argmax(jnp.where(node_valid, overlaps, -1.0))
        fallback = jnp.zeros_like(eligible).reshape(-1).at[best].set(True).reshape(eligible.shape)
        eligible = jnp.where(jnp.any(eligible), eligible, fallback)
        scores = jnp.where(eligible, jnp.asarray(gumbel), -1e12)
        top, idx = jax.lax.top_k(scores.reshape(-1), num_targets)
        return ((idx // ms).astype(jnp.int32), (idx % ms).astype(jnp.int32),
                overlaps.reshape(-1)[idx], top > -0.5e12)

    return sample


def _moved(tree, seed=0):
    """The JAX init with every zero-initialised kernel drawn N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, tree)  # new dicts, same leaves
    for leaf_path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]:
        if leaf.ndim == 2 and not leaf.any():
            keys = [p.key for p in leaf_path]
            node = out
            for k in keys[:-1]:
                node = node[k]
            node[keys[-1]] = (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
    return out


_OUT_KEYS = ("ref_feats_c", "src_feats_c", "gt_node_overlaps", "matching_scores",
             "ref_node_corr_knn_points", "src_node_corr_knn_points",
             "ref_node_corr_knn_masks", "src_node_corr_knn_masks")


@pytest.fixture(scope="module")
def train_pair():
    """The pair, the JAX init, the Gumbel noise, and for each weight set the
    JAX losses, outputs and gradients (mapped to the port's names)."""
    from gaussreg_tpu.models import registration as jreg
    from gaussreg_tpu.models.losses import overall_loss
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.checkpoint import params_from_flax

    cfg, tcfg = _cfgs()
    pb = make_pair_batch(tcfg, *random_pair(tcfg, 0, num_points=500), device="cpu")
    jb = _jax_batch(pb)
    model = jreg.create_model(cfg)
    init = jax.jit(lambda k, b: model.init({"params": k, "sample": jax.random.fold_in(k, 1),
                                            "ransac": jax.random.fold_in(k, 2)},
                                           b, train=False, with_transform=False))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jb))
    nc = pb.pyramid.points[-1].shape[1]
    gumbel = np.random.default_rng(0).gumbel(size=(nc, nc)).astype(np.float32)

    def loss_fn(p):
        out = model.apply(p, jb, train=True, with_transform=False,
                          rngs={"sample": jax.random.PRNGKey(1)})
        losses = overall_loss(cfg, out, jb.transform)
        return losses["loss"], (losses, {k: out[k] for k in _OUT_KEYS})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreg, "sample_gt_node_correspondences", _jax_sampler(gumbel))
        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        weights, jax_res = {}, {}
        for name, tree in (("init", variables["params"]), ("moved", _moved(variables["params"]))):
            (_, (losses, out)), grads = value_and_grad({"params": tree})
            weights[name] = params_from_flax(tree)
            jax_res[name] = ({k: float(v) for k, v in losses.items()},
                             {k: np.asarray(v) for k, v in out.items()},
                             params_from_flax(jax.tree_util.tree_map(np.asarray, grads["params"])))
    return dict(tcfg=tcfg, pb=pb, gumbel=gumbel, variables=variables, weights=weights,
                jax=jax_res)


def port_loss_and_grads(tcfg, pb, gumbel, state_dict):
    """The port's train-mode forward, losses and backward at `state_dict`,
    with the GT draw fed `gumbel`."""
    from gaussreg_tpu_torch.models import registration as treg
    from gaussreg_tpu_torch.models.losses import overall_loss
    from gaussreg_tpu_torch.models.matching import sample_gt_node_correspondences_from_gumbel

    model = treg.create_model(tcfg, "cpu")
    model.load_state_dict(state_dict)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, "sample_gt_node_correspondences",
                   lambda gen, *a: sample_gt_node_correspondences_from_gumbel(_t(gumbel), *a))
        out = model(pb, torch.Generator().manual_seed(0), train=True, with_transform=False)
    losses = overall_loss(tcfg, out, pb.transform)
    losses["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: out[k].detach().numpy() for k in _OUT_KEYS}, grads)


def module_of(name: str) -> str:
    """The module a parameter belongs to for the gradient comparison."""
    parts = name.split(".")
    return ".".join(parts[:4] if name.startswith("transformer.transformer.") else parts[:2])


def module_distances(grads, ref):
    """Per module, the relative Frobenius distance of `grads` to `ref` and
    the norm of `ref` (the kernel points take no gradient)."""
    out = {}
    for mod in sorted({module_of(n) for n in ref}):
        names = [n for n in ref if module_of(n) == mod and "kernel_points" not in n]
        a = torch.cat([grads[n].reshape(-1) for n in names])
        b = torch.cat([ref[n].reshape(-1) for n in names])
        norm = float(b.norm())
        out[mod] = (float((a - b).norm()) / norm if norm else float(a.norm()), norm)
    return out


@pytest.fixture(scope="module")
def port_results(train_pair):
    tp = train_pair
    return {name: port_loss_and_grads(tp["tcfg"], tp["pb"], tp["gumbel"], sd)
            for name, sd in tp["weights"].items()}


@pytest.mark.parametrize("weights", ["init", "moved"])
def test_train_losses_match_jax(train_pair, port_results, weights):
    losses_t, _, _ = port_results[weights]
    losses_j, _, _ = train_pair["jax"][weights]
    for key in ("loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(losses_t[key], losses_j[key], rtol=3 * LOSS_SENSITIVITY,
                                   atol=0, err_msg=key)


def _slot_permutation(pts_t, pts_j, mask_j):
    """Per patch, the port's slot holding each valid JAX slot's point."""
    perm = np.tile(np.arange(pts_j.shape[1]), (pts_j.shape[0], 1))
    for p in range(pts_j.shape[0]):
        where = {pts_t[p, s].tobytes(): s for s in range(pts_t.shape[1])}
        for s in np.flatnonzero(mask_j[p]):
            perm[p, s] = where[pts_j[p, s].tobytes()]
    return perm


@pytest.mark.parametrize("weights", ["init", "moved"])
def test_train_outputs_match_jax(train_pair, port_results, weights):
    """GT overlaps equal, so the sampled node pairs are the same. A patch
    holds the same points on both sides, but two points whose distances to
    their node differ in the last bit (the gram form rounds otherwise in
    XLA and torch) may swap slots: the port's slots are mapped onto JAX's
    by their points (a few percent of the slots move). Coarse features
    within 1e-2 of their max (bf16, see test_torch_port_model.py); the
    Sinkhorn scores of the valid entries within 2e-2 of their max."""
    _, out_t, _ = port_results[weights]
    _, out_j, _ = train_pair["jax"][weights]
    np.testing.assert_array_equal(out_t["gt_node_overlaps"], out_j["gt_node_overlaps"])
    assert (out_j["gt_node_overlaps"] > 0.1).sum() > 10
    perms = []
    for side in ("ref", "src"):
        pts_t, pts_j = out_t[f"{side}_node_corr_knn_points"], out_j[f"{side}_node_corr_knn_points"]
        mask_t, mask_j = out_t[f"{side}_node_corr_knn_masks"], out_j[f"{side}_node_corr_knn_masks"]
        np.testing.assert_array_equal(mask_t.sum(1), mask_j.sum(1))
        perm = _slot_permutation(pts_t, pts_j, mask_j)
        rows = np.arange(perm.shape[0])[:, None]
        np.testing.assert_array_equal(pts_t[rows, perm][mask_j], pts_j[mask_j])
        assert (perm != np.arange(perm.shape[1]))[mask_j].mean() < 0.05
        perms.append(perm)
    for key in ("ref_feats_c", "src_feats_c"):
        scale = np.abs(out_j[key]).max()
        np.testing.assert_allclose(out_t[key], out_j[key], rtol=0, atol=1e-2 * scale)
    k = perms[0].shape[1]
    scores_t = out_t["matching_scores"][:, :k, :k]
    scores_t = np.take_along_axis(np.take_along_axis(scores_t, perms[0][:, :, None], 1),
                                  perms[1][:, None, :], 2)
    valid = (out_j["ref_node_corr_knn_masks"][:, :, None]
             & out_j["src_node_corr_knn_masks"][:, None, :])
    a, b = scores_t[valid], out_j["matching_scores"][:, :k, :k][valid]
    assert valid.sum() > 1000
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * np.abs(b).max())


@pytest.mark.parametrize("weights", ["init", "moved"])
def test_train_gradients_match_jax_per_module(train_pair, port_results, weights):
    _, _, grads_t = port_results[weights]
    _, _, grads_j = train_pair["jax"][weights]
    dist = module_distances(grads_t, grads_j)
    assert set(dist) == set(SENSITIVITY)
    for mod, (d, norm) in dist.items():
        if norm == 0.0:  # behind a zero kernel at init: zero on both sides
            assert d == 0.0, mod
        else:
            assert d <= 3.0 * SENSITIVITY[mod], (mod, d, SENSITIVITY[mod])
    if weights == "moved":
        assert all(norm > 0 for _, norm in dist.values())


def test_every_parameter_gets_a_gradient(port_results):
    """Grad mode reaches every parameter (no in-place op cuts the graph);
    the kernel points take none."""
    _, _, grads = port_results["moved"]
    for name, g in grads.items():
        if name.endswith("kernel_points"):
            assert g is None, name
        else:
            assert g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, name


def measure_sensitivity(train_pair, seeds=5):
    """The port's own sensitivity: per module, the largest relative
    Frobenius distance between its gradients at the weights and at the
    weights moved by 1e-6 of themselves; and the largest relative change of
    the three losses."""
    tp = train_pair
    loss_sens, sens = 0.0, {}
    for sd in tp["weights"].values():
        losses, _, grads = port_loss_and_grads(tp["tcfg"], tp["pb"], tp["gumbel"], sd)
        for seed in range(seeds):
            gen = torch.Generator().manual_seed(100 + seed)
            moved = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen)) for k, v in sd.items()}
            losses2, _, grads2 = port_loss_and_grads(tp["tcfg"], tp["pb"], tp["gumbel"], moved)
            loss_sens = max(loss_sens, *(abs(losses2[k] - losses[k]) / abs(losses[k])
                                         for k in losses))
            for mod, (d, _) in module_distances(grads2, grads).items():
                sens[mod] = max(sens.get(mod, 0.0), d)
    return loss_sens, sens


# ------------------------------------------------------------- optimizer


def _optax_pair(scheduler, acc):
    from gaussreg_tpu.engine.trainer import make_optimizer as jax_make
    from gaussreg_tpu_torch.engine.trainer import make_optimizer

    over = dict(lr=1e-2, lr_decay=0.5, scheduler=scheduler, warmup_steps=3, max_epoch=4,
                grad_acc_steps=acc, weight_decay=1e-2)
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, optim=dataclasses.replace(jcfg.optim, **over))
    tcfg = dataclasses.replace(tcfg, optim=dataclasses.replace(tcfg.optim, **over))
    return jax_make(jcfg, 3), make_optimizer(tcfg, 3)


def _assert_rel(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("scheduler", ["step", "cosine"])
@pytest.mark.parametrize("acc", [1, 2])
@pytest.mark.parametrize("nan_step", [None, 5])
def test_optimizer_matches_optax(scheduler, acc, nan_step):
    """12 steps of a seeded gradient sequence on a small tree with a
    zero-gradient leaf ("kp", as the kernel points), the JAX step's NaN
    guard on both sides. Three steps per epoch: the staircase decays, and
    the cosine warms up over 3 updates."""
    import optax
    from flax import serialization
    from gaussreg_tpu_torch.engine.checkpoint import opt_state_to_flax
    from gaussreg_tpu_torch.engine.trainer import apply_gradients

    jtx, ttx = _optax_pair(scheduler, acc)
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,), "kp": (5, 3), "alpha": ()}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # the JAX tree is wrapped as the model's variables are, {"params": ...}
    jp = {"params": {k: jnp.asarray(v) for k, v in p0.items()}}
    js = jtx.init(jp)
    tp = {k: _t(v) for k, v in p0.items()}
    ts = ttx.init(tp)
    skipped = 0
    for step in range(12):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        g["kp"][:] = 0.0
        if step == nan_step:
            g["w"][1, 2] = np.nan
        finite = all(np.isfinite(v).all() for v in g.values())
        jg = {"params": {k: jnp.asarray(v if finite else np.zeros_like(v)) for k, v in g.items()}}
        updates, js = jtx.update(jg, js, jp)
        if finite:
            jp = optax.apply_updates(jp, updates)
        ts, ok = apply_gradients(ttx, tp, ts, {k: _t(v) for k, v in g.items()})
        assert ok == finite
        skipped += not ok
    assert skipped == (nan_step is not None)
    for k in shapes:
        _assert_rel(tp[k].numpy(), jp["params"][k], k)
    assert np.abs(tp["kp"].numpy() - p0["kp"]).min() > 1e-3  # moved by weight decay alone
    # the moments and counts, in the checkpoint's layout (a per-parameter
    # dict becomes {"params": tree}; here the tree is the dict itself)
    from gaussreg_tpu_torch.engine import checkpoint as ck

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "flax_from_params", lambda d: {k: v.numpy() for k, v in d.items()})
        tflat = dict(jax.tree_util.tree_leaves_with_path(opt_state_to_flax(ts)))
    jflat = dict(jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(js)))
    assert set(tflat) == set(jflat)
    for key, v in jflat.items():
        _assert_rel(tflat[key], v, jax.tree_util.keystr(key))


def test_schedules_match_optax():
    import optax
    from gaussreg_tpu_torch.engine.trainer import exponential_decay, warmup_cosine

    j = optax.exponential_decay(3e-4, 7, 0.95, staircase=True)
    t = exponential_decay(3e-4, 7, 0.95)
    for c in range(0, 60, 3):
        np.testing.assert_allclose(t(c), float(j(jnp.int32(c))), rtol=1e-7)
    t = warmup_cosine(1e-3, 5, 40, 0.1, 0.1)
    assert t(0) == pytest.approx(1e-4, rel=1e-6) and t(5) == pytest.approx(1e-3, rel=1e-6)
    assert t(40) == pytest.approx(1e-4, rel=1e-6) and t(100) == pytest.approx(1e-4, rel=1e-6)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("acc", [1, 2])
def test_port_checkpoint_loads_in_jax(train_pair, tmp_path, acc):
    """save_checkpoint (the port's own msgpack writer) read by the JAX
    load_checkpoint onto the JAX model's params and make_optimizer state:
    every leaf equal."""
    from flax import serialization
    from gaussreg_tpu.engine.checkpoint import load_checkpoint as jax_load
    from gaussreg_tpu_torch.engine.checkpoint import (
        flax_from_params,
        load_metadata,
        opt_state_to_flax,
        save_checkpoint,
    )
    from gaussreg_tpu_torch.engine.trainer import apply_gradients

    jtx, ttx = _optax_pair("step", acc)
    params = {k: v.clone() for k, v in train_pair["weights"]["init"].items()}
    state = ttx.init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(acc + 1):
        state, _ = apply_gradients(ttx, params, state,
                                   {k: torch.randn(v.shape, generator=gen) for k, v in params.items()})
    path = save_checkpoint(str(tmp_path), "port", params, state, {"step": acc + 1})
    assert load_metadata(str(tmp_path), "port") == {"step": acc + 1}
    variables = train_pair["variables"]
    jparams, jopt = jax_load(path, variables, jtx.init(variables))
    want = jax.tree_util.tree_leaves(flax_from_params(params))
    got = jax.tree_util.tree_leaves(jparams["params"])
    assert len(want) == len(got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)
    want = jax.tree_util.tree_leaves_with_path(opt_state_to_flax(state))
    got = dict(jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(jopt)))
    assert len(want) == len(got)
    for p, b in want:
        np.testing.assert_array_equal(np.asarray(got[p]), b, err_msg=jax.tree_util.keystr(p))


def test_jax_checkpoint_loads_in_port(train_pair, tmp_path):
    """The JAX save_checkpoint (params and one make_optimizer update's
    state) read by the port's load_checkpoint onto its optimizer's init:
    every leaf equal."""
    from flax import serialization
    from gaussreg_tpu.engine.checkpoint import save_checkpoint as jax_save
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint, opt_state_to_flax

    jtx, ttx = _optax_pair("cosine", 1)
    variables = train_pair["variables"]
    jopt = jtx.init(variables)
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                   variables)
    _, jopt = jtx.update(grads, jopt, variables)
    path = jax_save(str(tmp_path), "jax", variables, jopt)
    template = ttx.init({k: torch.zeros_like(v) for k, v in train_pair["weights"]["init"].items()})
    params, state = load_checkpoint(path, template)
    for k, v in train_pair["weights"]["init"].items():
        assert torch.equal(params[k], v), k
    assert state[1][0].count == 1 and state[1][1].count == 1
    want = dict(jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(jopt)))
    got = jax.tree_util.tree_leaves_with_path(opt_state_to_flax(state))
    assert len(want) == len(got)
    for p, b in got:
        np.testing.assert_array_equal(b, np.asarray(want[p]), err_msg=jax.tree_util.keystr(p))


# ----------------------------------------------------------- initialisers


def test_initialisers_match_flax_distributions(train_pair):
    """reset_parameters against the JAX init, leaf by leaf: the same shapes;
    zeros, ones and the kernel points exact; each random leaf's mean and
    standard deviation within five sampling errors of JAX's, and its range
    inside the distribution's support (lecun_normal truncated at two of its
    standard deviations, KPConv's uniform limit)."""
    from gaussreg_tpu_torch.engine.checkpoint import flax_from_params
    from gaussreg_tpu_torch.models.registration import create_model

    model = create_model(train_pair["tcfg"], "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    port = dict(jax.tree_util.tree_leaves_with_path(flax_from_params(model.state_dict())))
    jaxs = dict(jax.tree_util.tree_leaves_with_path(train_pair["variables"]["params"]))
    assert set(port) == set(jaxs)
    n_random = 0
    for path, j in jaxs.items():
        t, name = port[path], jax.tree_util.keystr(path)
        assert t.shape == j.shape, name
        if "kernel_points" in name or not j.any() or (j == 1).all():
            np.testing.assert_array_equal(t, j, err_msg=name)
            continue
        n_random += 1
        n, sd = j.size, j.std()
        assert abs(t.std() - sd) <= 5 * sd * np.sqrt(1.0 / n), name
        assert abs(t.mean() - j.mean()) <= 5 * sd * np.sqrt(2.0 / n), name
        if j.ndim == 3:  # KPConv weights: uniform in +-sqrt(1 / (K * Cin))
            limit = np.sqrt(1.0 / (j.shape[0] * j.shape[1]))
        else:  # lecun_normal: 2 * sqrt(1 / fan_in) / 0.8796...
            limit = 2 * np.sqrt(1.0 / j.shape[0]) / 0.87962566103423978
        assert np.abs(t).max() <= limit * (1 + 1e-6) and np.abs(j).max() <= limit * (1 + 1e-6), name
    assert n_random > 50


# ----------------------------------------------------------- augmentation


def test_augment_pair_pose_matches_jax(train_pair):
    from gaussreg_tpu.data.pipeline import augment_pair_pose as jax_augment
    from gaussreg_tpu_torch.data.pipeline import augment_pair_pose

    pb = train_pair["pb"]
    jb = jax.tree_util.tree_map(np.asarray, _jax_batch(pb))
    j = jax_augment(jb, np.random.default_rng(3))
    t = augment_pair_pose(pb, np.random.default_rng(3))
    for a, b in zip(t.pyramid.points, j.pyramid.points):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(t.transform.numpy(), j.transform)
    assert not np.allclose(t.transform.numpy(), pb.transform.numpy())


# -------------------------------------------------------- steps and tools


def test_train_step_moves_every_parameter_then_eval_step(train_pair):
    """Two steps of make_train_step with make_optimizer on the CPU: finite
    gradients, every parameter moved (the kernel points by weight decay);
    then the eval step's metrics."""
    from gaussreg_tpu_torch.data.synthetic import make_synthetic_batch
    from gaussreg_tpu_torch.engine.trainer import (
        create_train_state,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from gaussreg_tpu_torch.models.registration import create_model

    cfg = train_pair["tcfg"]
    model = create_model(cfg, "cpu")
    tx = make_optimizer(cfg, steps_per_epoch=10)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device="cpu")
    start = {k: v.detach().clone() for k, v in state.params.items()}
    step = make_train_step(model, cfg, tx)
    batches = make_synthetic_batch(cfg, [1], num_points=500, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, metrics = step(state, batches, gen)
        assert metrics["grad_finite"] == 1.0
        assert set(metrics) == {"loss", "c_loss", "f_loss", "PIR", "grad_finite", "vox_overflow"}
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 2 and state.skipped == 0
    still = [k for k, v in state.params.items() if torch.equal(v.detach(), start[k])]
    assert still == []
    est, ev = make_eval_step(model, cfg)(batches[0], torch.Generator().manual_seed(2))
    assert est.shape == (4, 4) and bool(torch.isfinite(est).all())
    assert set(ev) == {"RRE", "RTE", "RTE_abs", "RSE", "RMSE", "RR", "PIR", "IR",
                       "vox_overflow", "corr_overflow"}
    assert all(np.isfinite(float(v)) for v in ev.values())


def test_train_step_skips_a_non_finite_gradient(train_pair):
    """A NaN in the gradient: no parameter moves, the skip is counted, and
    the optimizer still advanced (Adam's count and the schedule's, and its
    first moment holds (1 - b1) * wd * p)."""
    from gaussreg_tpu_torch.engine.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from gaussreg_tpu_torch.models.registration import create_model

    cfg = train_pair["tcfg"]
    model = create_model(cfg, "cpu")
    tx = make_optimizer(cfg, steps_per_epoch=10)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device="cpu")
    with torch.no_grad():
        model.ot_alpha.fill_(float("nan"))
    start = {k: v.detach().clone() for k, v in state.params.items()}
    state, metrics = make_train_step(model, cfg, tx)(state, [train_pair["pb"]],
                                                     torch.Generator().manual_seed(1))
    assert metrics["grad_finite"] == 0.0 and state.skipped == 1 and state.step == 1
    for k, v in state.params.items():
        torch.testing.assert_close(v.detach(), start[k], rtol=0, atol=0, equal_nan=True)
    _, (adam, sched) = state.opt_state
    assert adam.count == 1 and sched.count == 1
    kp = "backbone.encoder2_2.conv.kernel_points"
    torch.testing.assert_close(adam.mu[kp], 0.1 * cfg.optim.weight_decay * start[kp])


def test_sinkhorn_gradients_match_jax():
    """Under grad the port checkpoints each iteration; the gradients with
    respect to the scores and the dustbin score against jax.grad, within
    1e-4 of their max (f32 in another order over 100 iterations); the
    forward equal to the no-grad forward bit for bit."""
    from gaussreg_tpu.ops.sinkhorn import log_optimal_transport as jax_ot
    from gaussreg_tpu_torch.ops.sinkhorn import log_optimal_transport

    rng = np.random.default_rng(0)
    scores = rng.normal(size=(3, 10, 12)).astype(np.float32)
    rm, cm = rng.uniform(size=(3, 10)) > 0.2, rng.uniform(size=(3, 12)) > 0.2
    w = rng.normal(size=(3, 11, 13)).astype(np.float32)
    fin = np.asarray(jax_ot(jnp.asarray(scores), jnp.asarray(rm), jnp.asarray(cm), 1.3, 100)) > -1e11
    gj = jax.grad(
        lambda s, a: (jnp.where(fin, jax_ot(s, jnp.asarray(rm), jnp.asarray(cm), a, 100), 0.0)
                      * w).sum(),
        argnums=(0, 1),
    )(jnp.asarray(scores), jnp.float32(1.3))
    s_t, a_t = _t(scores).requires_grad_(), torch.tensor(1.3).requires_grad_()
    out = log_optimal_transport(s_t, _t(rm), _t(cm), a_t, 100)
    gt = torch.autograd.grad((torch.where(_t(fin), out, 0.0) * _t(w)).sum(), [s_t, a_t])
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())
    with torch.no_grad():
        plain = log_optimal_transport(_t(scores), _t(rm), _t(cm), torch.tensor(1.3), 100)
    assert torch.equal(out.detach(), plain)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from gaussreg_tpu_torch.data.synthetic import make_synthetic_batch
    from gaussreg_tpu_torch.engine.trainer import adam, create_train_state
    from gaussreg_tpu_torch.models.registration import GaussRegModel
    from gaussreg_tpu_torch.tools import overfit_gate, smoke_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_batch(cfg, [0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(cfg, GaussRegModel(cfg), torch.Generator(), adam(1e-3))
    for tool in (smoke_train, overfit_gate):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--tiny"])


def test_overfit_gate_twin_on_the_cpu(tmp_path, capsys):
    """The tool's path at make_tiny_cfg() for two steps: its printed lines,
    its verdict line, and the checkpoint it dumps (read back by the port)."""
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.tools import overfit_gate

    rc = overfit_gate.main(["--tiny", "--cpu", "--steps", "2", "--log_every", "1",
                            "--dump_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert rc in (0, 1) and "[step 0] PIR" in text and "step 2: loss" in text
    assert ("GATE PASS" in text) == (rc == 0) and ("GATE FAIL" in text) == (rc == 1)
    sd = load_checkpoint(os.path.join(tmp_path, "overfit.msgpack"))
    assert all(bool(torch.isfinite(v).all()) for v in sd.values())
    assert os.path.exists(os.path.join(tmp_path, "transforms_0.npz"))


def test_engine_utilities(tmp_path):
    from gaussreg_tpu_torch.engine import debug, loops, summary

    g1, g2 = debug.seed_everything(3), debug.seed_everything(3)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    debug.enable_anomaly_detection()
    assert torch.is_anomaly_enabled()
    debug.enable_anomaly_detection(nans=False)
    assert not torch.is_anomaly_enabled()
    with debug.profile_trace(str(tmp_path)):
        with debug.annotate("span"):
            torch.ones(3).sum()
    assert os.path.exists(os.path.join(tmp_path, "trace.json"))

    logged = []
    data = loops.cycle_loader(lambda epoch: iter([epoch, epoch + 10]))
    final = loops.run_iterations(0, data, lambda s, b: (s + 1, {"loss": float(b)}), 5,
                                 log_steps=2, on_log=lambda it, m: logged.append((it, m)))
    assert final == 5 and [it for it, _ in logged] == [2, 4]
    assert logged[0][1]["loss"] == pytest.approx(5.0)
    assert summary.process_index() == 0
    assert summary.get_logger().name == "gaussreg"
    writer = summary.ScalarWriter(None)
    writer.write("train", {"loss": 1.0}, 0)
    writer.close()
    assert summary.format_metrics({"a": 1.0}) == "a: 1"
