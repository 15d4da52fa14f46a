"""The twins of the repo's diagnostic and profiling tools
(gaussreg_tpu_torch/tools/: calibrate_neighbors, probe_overflow,
diagnose_eval, diagnose_hard_failures, probe_generalization, profile_fine,
profile_eval, profile_trainstep) at make_tiny_cfg() on the CPU.

- `calibrate` equals the JAX tool's procedure (tools/calibrate_neighbors.py:
  65-89, re-expressed here over gaussreg_tpu.data.pipeline.build_pyramid)
  bit for bit: histograms and limits. The tiny pyramid's neighbour lists
  equal the JAX package's entry for entry (test_torch_port_search.py).
- `probe_pair` equals the JAX tool's `probe_pair` row for row: names,
  recall, misses, totals, truncated and sampled queries.
- `diagnose` against the JAX tool's stage numbers (tools/diagnose_eval.py:
  80-133, re-expressed here over the JAX model's outputs) on one pair, the
  same weights (the port's seeded init carried across by
  engine/checkpoint.flax_from_params). Tolerances, with their reasons:
  the proposals' count is equal; the bf16 KPConv noise may flip superpoint
  pairs that lie within 1 % of the top-P cut score (the near-ties of
  tests/test_torch_port_model.py), so PIR may move by one proposal per
  near-tie, the dustbin mass by the flipped patches' share plus 1e-2 (the
  Sinkhorn scores' tolerance there), and the dense correspondences' count
  and inlier ratio by the flipped patches' correspondences (at most
  max_patch_correspondences each); the LGR transform agrees within 1e-3
  (test_torch_port_model.py), so its RRE within 0.1 deg and its
  translation, scales and RSE within 2e-3. RANSAC draws from a
  torch.Generator, not from JAX's key, so its line is checked finite.
- each twin's `main` runs with --cpu --tiny (or its smallest flags),
  prints its lines and returns 0.
"""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the test run spreads files over several worker processes that share the
# host's cores; torch's default of one thread per core oversubscribes them
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A module of the repo's root tools/ (not a package), by path."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """A tiny-config checkpoint of seeded random weights."""
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.engine.checkpoint import save_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model

    model = create_model(make_tiny_cfg(), "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model, save_checkpoint(str(tmp_path_factory.mktemp("w")), "tiny", model)


def test_calibrate_equals_the_jax_procedure():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu.data.pipeline import build_pyramid, pad_cloud
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny
    from gaussreg_tpu_torch.tools import calibrate_neighbors as cn

    clouds = list(cn.synthetic_clouds(t_tiny(), 1))  # pair 0's two clouds
    limits, hists = cn.calibrate(t_tiny(), clouds, 0.8, "cpu")

    # tools/calibrate_neighbors.py:39-89 on the same clouds
    cfg = make_tiny_cfg()
    num_stages = cfg.backbone.num_stages
    hist_n = int(np.ceil(4 / 3 * np.pi * (cfg.backbone.base_radius + 1) ** 3))
    measure_limits = tuple([min(hist_n, 128)] * num_stages)
    j_hists = np.zeros((num_stages, measure_limits[0] + 1), np.int64)
    for cloud in clouds:
        pts, _, mask = pad_cloud(cloud, cloud[:, :1], cfg.capacity.levels[0])
        pyr = build_pyramid(jnp.asarray(pts)[None], jnp.asarray(mask)[None],
                            cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                            cfg.capacity.levels, measure_limits, num_stages)
        for lvl in range(num_stages):
            nbr = np.asarray(pyr.neighbors[lvl][0])
            msk = np.asarray(pyr.masks[lvl][0])
            counts = (nbr < nbr.shape[0]).sum(axis=1)[msk]
            j_hists[lvl] += np.bincount(counts, minlength=measure_limits[0] + 1)[
                : measure_limits[0] + 1]
    j_limits = []
    for lvl in range(num_stages):
        cum = np.cumsum(j_hists[lvl])
        j_limits.append(int(np.searchsorted(cum, 0.8 * cum[-1]) + 1))

    assert cn.measure_limits(t_tiny()) == measure_limits == (128,) * 5
    np.testing.assert_array_equal(hists, j_hists)
    assert limits == j_limits
    assert hists[0].sum() == sum(len(c) for c in clouds)  # every level-0 point counted


def test_probe_pair_equals_jax():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny
    from gaussreg_tpu_torch.tools import probe_overflow

    j_overflow, j_rows = _jax_tool("probe_overflow").probe_pair(make_tiny_cfg(), 3, sample=64,
                                                                quiet=True)
    overflow, rows = probe_overflow.probe_pair(t_tiny(), 3, sample=64, quiet=True, device="cpu")
    assert overflow == j_overflow
    assert len(rows) == len(j_rows) == 18
    for row, j_row in zip(rows, j_rows):
        assert row == j_row


def _jax_stages(cfg, out, gt):
    """tools/diagnose_eval.py:80-133's numbers from the JAX model's outputs."""
    from gaussreg_tpu.models.metrics import isotropic_transform_error
    from gaussreg_tpu.ops.transforms import apply_transform

    res = {}
    gt_map = out["gt_node_overlaps"] > cfg.eval.acceptance_overlap
    ri, si, v = out["ref_node_corr_indices"], out["src_node_corr_indices"], out["node_corr_valid"]
    res["proposals"] = int(v.sum())
    res["PIR"] = float((gt_map[ri, si] & v).sum() / max(v.sum(), 1))
    rc, sc, cv = out["ref_corr_points"], out["src_corr_points"], out["corr_valid"]
    resid = np.linalg.norm(rc - np.asarray(apply_transform(jnp.asarray(sc), jnp.asarray(gt))),
                           axis=-1)
    res["corrs"] = int(cv.sum())
    res["IR"] = float(((resid < cfg.eval.acceptance_radius) & cv).sum()) / max(int(cv.sum()), 1)
    res["dustbin"] = float(np.exp(out["matching_scores"])[:, :-1, -1][
        out["ref_node_corr_knn_masks"]].mean())
    est = out["lgr_transform"]
    rre, _, rse = (float(x) for x in isotropic_transform_error(jnp.asarray(gt), jnp.asarray(est)))
    res.update(LGR_RRE=rre, LGR_RSE=rse,
               LGR_RTEabs=float(np.linalg.norm(gt[:3, 3] - est[:3, 3])),
               LGR_scale_gt=float(np.cbrt(abs(np.linalg.det(gt[:3, :3])))),
               LGR_scale_est=float(np.cbrt(abs(np.linalg.det(est[:3, :3])))))
    return res


def _flips(cfg, j, t):
    """The JAX proposals the port did not make; each pair in which the two
    sets differ must be a near-tie: its dual-normalized JAX score within
    1 % of the top-P cut (test_torch_port_model.py)."""
    rf, sf = j["ref_feats_c"], j["src_feats_c"]
    valid = j["ref_node_masks"][:, None] & j["src_node_masks"][None, :]
    s = np.where(valid, np.exp(-np.maximum(2.0 - 2.0 * rf @ sf.T, 0.0)), 0.0)
    s = ((s / np.maximum(s.sum(1, keepdims=True), 1e-12))
         * (s / np.maximum(s.sum(0, keepdims=True), 1e-12)))
    s = np.where(valid, s, -1.0)
    cut = np.sort(s.ravel())[::-1][cfg.coarse_matching.num_correspondences - 1]
    pairs = lambda o: set(zip(o["ref_node_corr_indices"][o["node_corr_valid"]].tolist(),
                              o["src_node_corr_indices"][o["node_corr_valid"]].tolist()))
    jp, tp = pairs(j), pairs(t)
    for pair in jp ^ tp:
        assert abs(s[pair] - cut) <= 1e-2 * cut, (pair, s[pair], cut)
    return len(jp - tp)


def test_diagnose_matches_jax(tiny_weights):
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu.data.pipeline import make_pair_batch as jax_make
    from gaussreg_tpu.data.synthetic import random_pair
    from gaussreg_tpu.models.registration import create_model as jax_create
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.engine.checkpoint import flax_from_params
    from gaussreg_tpu_torch.tools.diagnose_eval import diagnose, report

    model, _ = tiny_weights
    cfg = make_tiny_cfg()
    pair = random_pair(cfg, 10_000_000)  # the JAX tool's default seed
    jbatch = jax_make(cfg, *pair)
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(model.state_dict()))
    jout = jax.jit(lambda p, b: jax_create(cfg).apply(
        {"params": p}, b, train=False, with_transform=True, with_gt_overlaps=True,
        rngs={"ransac": jax.random.PRNGKey(3)}))(params, jbatch)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    j = _jax_stages(cfg, jout, np.asarray(jbatch.transform))

    batch = make_pair_batch(t_tiny(), *pair, device="cpu")
    outs = []  # the port forward's outputs, for the flips
    hook = model.register_forward_hook(lambda _m, _a, out: outs.append(out))
    try:
        t = diagnose(model, t_tiny(), batch, torch.Generator().manual_seed(3))
    finally:
        hook.remove()

    flips = _flips(cfg, jout, {k: v.numpy() for k, v in outs[0].items()})
    assert flips <= 4, flips  # as test_torch_port_model.py allows
    cap = t_tiny().capacity
    assert t["proposals"] == j["proposals"] and t["corr_capacity"] == cap.max_correspondences
    assert abs(t["PIR"] - j["PIR"]) <= flips / j["proposals"] + 1e-9
    moved = flips * cap.max_patch_correspondences
    assert abs(t["corrs"] - j["corrs"]) <= moved
    assert abs(t["IR"] - j["IR"]) <= moved / max(j["corrs"], 1) + 1e-6
    assert abs(t["dustbin"] - j["dustbin"]) <= flips / j["proposals"] + 1e-2
    assert abs(t["LGR_RRE"] - j["LGR_RRE"]) <= 0.1
    for key in ("LGR_RSE", "LGR_RTEabs", "LGR_scale_gt", "LGR_scale_est"):
        assert abs(t[key] - j[key]) <= 2e-3, (key, t[key], j[key])
    for key in ("RANSAC_RRE", "RANSAC_RTEabs", "RANSAC_RSE", "inliers"):
        assert np.isfinite(t[key]), (key, t[key])
    lines = report(t, t_tiny())
    assert [line.split(" ")[0] for line in lines] == [
        "[coarse]", "[fine]", "[sinkhorn]", "[LGR", "[RANSAC]", "[ransac]"]


# each twin's main at its smallest flags: (module, argv, words every run prints)
MAINS = {
    "calibrate_neighbors": (["--samples", "1"], ["calibrated neighbor_limits: [",
                                                 "(update CapacityConfig.neighbor_limits"]),
    "probe_overflow": (["--seeds", "0", "--sample", "32"],
                       ["--- seed 0: search_overflow=", "level 4: num_voxels=",
                        "L0/ref/self", "L3/src/sub", "worst recall across seeds/levels/clouds:"]),
    "diagnose_eval": (["--ckpt", "{w}"], ["[coarse] proposals=", "[fine]   corrs=",
                                          "[sinkhorn] mean P(ref point -> dustbin)",
                                          "[LGR   ] RRE=", "[RANSAC] RRE=", "[ransac] inliers="]),
    "diagnose_hard_failures": (["20000004", "--ckpt", "{w}"],
                               ['{"seed": 20000004, "window_rows0": 2, "RRE": ',
                                '{"seed": 20000004, "window_rows0": 4, "RRE": ', '"RMSE": ',
                                '"vox_overflow": ']),
    "probe_generalization": (["--weights", "{w}", "--pairs", "1", "--pool_size", "4"],
                             ["train-pool seed=", "held-out seed=20000000: PIR=", " RMSE=",
                              " RR="]),
    "profile_fine": (["--profile"], ["coarse residual: RRE", "sat_cull=True: first",
                                     "sat_cull=False: first", "ms/step", "overflow=",
                                     "final_loss=", "refined RRE", "2 steps and their probes"]),
    "profile_eval": (["--trace", "--stages"], ["eval fwd, no transform (backbone+tfm+OT)",
                                               "eval fwd, full (+LGR+RANSAC)", "ms/rep",
                                               "eval fwd, full: wall",
                                               "backbone", "transformer", "LGR", "RANSAC"]),
    "profile_trainstep": (["--only", "model fwd (loss)", "--trace"],
                          ["model fwd (loss)", "full train step (median of 5):",
                           "one train step: wall", "backbone", "loss", "backward",
                           "optimizer"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_cpu(name, tiny_weights, capsys):
    module = importlib.import_module(f"gaussreg_tpu_torch.tools.{name}")
    argv, words = MAINS[name]
    argv = [a.format(w=tiny_weights[1]) for a in argv] + ["--tiny", "--cpu"]
    assert module.main(argv) == 0
    text = capsys.readouterr().out
    for w in words:
        assert w in text, (name, w, text[-2000:])


def test_calibrate_reads_a_scannet_train_split(tmp_path, capsys):
    """The --data_root branch: both clouds of each train item, as the JAX
    dataset gives them (tests/test_torch_port_scannet.py holds the items
    equal), through `calibrate`."""
    import pickle

    from gaussreg_tpu.data.scannet import ScanNetGSRegDataset
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.gs.ply import GaussianModel, save_gaussians
    from gaussreg_tpu_torch.tools import calibrate_neighbors as cn

    rng = np.random.default_rng(0)
    meta = []
    for scene in ("scene0707_00", "scene0708_00"):
        for tag in ("A", "B"):
            n = 600
            g = GaussianModel(
                (rng.uniform(size=(n, 3)) * 3.0).astype(np.float32),
                rng.normal(scale=0.5, size=(n, 3, 1)).astype(np.float32),
                rng.normal(scale=0.05, size=(n, 3, 15)).astype(np.float32),
                rng.uniform(0.0, 4.0, size=(n, 1)).astype(np.float32),
                (rng.normal(scale=0.3, size=(n, 3)) - 4.0).astype(np.float32),
                rng.normal(size=(n, 4)).astype(np.float32))
            os.makedirs(tmp_path / "train" / scene / tag)
            save_gaussians(str(tmp_path / "train" / scene / tag / "point_cloud.ply"), g)
        meta.append({"scene_name": scene, "frag_id0": 0, "frag_id1": 1, "overlap": 0.9,
                     "pcd0": f"train/{scene}/A/point_cloud.ply",
                     "pcd1": f"train/{scene}/B/point_cloud.ply",
                     "rotation": np.eye(3, dtype=np.float32),
                     "translation": np.zeros(3, np.float32)})
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump(meta, f)

    cfg = make_tiny_cfg()
    assert cn.main(["--data_root", str(tmp_path), "--samples", "2", "--tiny", "--cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()[0]
    ds = ScanNetGSRegDataset(str(tmp_path), "train", point_limit=cfg.train.point_limit)
    clouds = [ds[i][k] for i in range(2) for k in ("ref_points", "src_points")]
    limits, hists = cn.calibrate(cfg, clouds, 0.8, "cpu")
    assert printed == f"calibrated neighbor_limits: {limits}"
    assert hists[0].sum() == sum(len(c) for c in clouds) > 0


def test_stage_attribution_of_a_device_trace():
    """`profiling.attribute` on a hand-made chrome trace: a kernel launched
    inside a stage's host range opens that stage's device window; a kernel
    without a correlated launch (as a ctypes wrapper's) counts for the
    window it starts in; a kernel outside every window is "other"."""
    from gaussreg_tpu_torch.tools.profiling import attribute

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "backbone", 0.0, 100.0),
        ev("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 90.0, 2.0, corr=2),
        ev("user_annotation", "transformer", 100.0, 50.0),
        ev("cuda_runtime", "cudaLaunchKernel", 110.0, 2.0, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 160.0, 2.0, corr=4),
        ev("kernel", "gemm", 200.0, 30.0, corr=1),
        ev("kernel", "kpconv_fused_kernel", 231.0, 40.0),  # no correlation
        ev("kernel", "reduce", 272.0, 8.0, corr=2),
        ev("kernel", "gemm", 300.0, 20.0, corr=3),
        ev("kernel", "copy", 330.0, 5.0, corr=4),  # launched after every range
    ]
    busy, stages, by_name, on_device = attribute(events)
    assert on_device and busy == pytest.approx(0.103)
    assert stages == pytest.approx({"backbone": 0.078, "transformer": 0.020})
    assert by_name["gemm"] == pytest.approx((0.050, 2))
    assert by_name["kpconv_fused_kernel"] == pytest.approx((0.040, 1))
