"""The port's ScanNet-GSReg loader (gaussreg_tpu_torch/data/scannet.py) and
its evaluation CLIs (tools/eval_scannet.py, tools/eval_synthetic.py)
against the JAX package's on the CPU.

The fake dataset tree is built as tests/test_scannet_integration.py builds
it: the reference's layout, two scenes per split, B = A under a known
similarity, identity frame transforms in test_transformations.npz.

Tolerances:
- dataset items: equal arrays, or within 1e-6 where a value passes
  through furthest point sampling and the SH colour evaluation (the port's
  own float32 code; measured equal);
- the eval CLI's un-normalization, with both CLIs handed the same
  normalized estimate: within 1e-4 (float32 centres and scales of clouds
  a few metres wide).
"""

import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["scene0707_00", "scene0708_00"]


def _random_gaussians(rng, n=900, extent=(3.0, 2.4, 3.0)):
    from gaussreg_tpu_torch.gs.ply import GaussianModel

    xyz = (rng.uniform(size=(n, 3)) * np.asarray(extent)).astype(np.float32)
    f_dc = rng.normal(scale=0.5, size=(n, 3, 1)).astype(np.float32)
    f_rest = rng.normal(scale=0.05, size=(n, 3, 15)).astype(np.float32)
    opacity = rng.uniform(0.0, 4.0, size=(n, 1)).astype(np.float32)
    scales = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32) - 4.0
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    return GaussianModel(xyz, f_dc, f_rest, opacity, scales, rots)


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from scipy.spatial.transform import Rotation

    from gaussreg_tpu_torch.gs.ply import GaussianModel, save_gaussians

    root = tmp_path_factory.mktemp("scannet_gsreg")
    rng = np.random.default_rng(0)
    train_meta, test_meta = [], []
    ref_tl, src_tl, gt_tl = {}, {}, {}
    for subset in ("train", "test"):
        for si, scene in enumerate(SCENES):
            base = _random_gaussians(rng)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = 1.3 * Rotation.random(random_state=si).as_matrix().astype(np.float32)
            m[:3, 3] = [0.4, -0.2, 0.1]
            inv = np.linalg.inv(m)
            gb = GaussianModel((base.xyz @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32),
                               base.f_dc, base.f_rest, base.opacity, base.scales, base.rots)
            for tag, g in (("A", base), ("B", gb)):
                p = os.path.join(str(root), subset, scene, tag, "output", "point_cloud",
                                 "iteration_10000")
                os.makedirs(p, exist_ok=True)
                save_gaussians(os.path.join(p, "point_cloud.ply"), g)
            rel = f"{subset}/{scene}"
            meta = {
                "scene_name": scene, "frag_id0": 0, "frag_id1": 1, "overlap": 0.9,
                "pcd0": f"{rel}/A/output/point_cloud/iteration_10000/point_cloud.ply",
                "pcd1": f"{rel}/B/output/point_cloud/iteration_10000/point_cloud.ply",
                "rotation": m[:3, :3].copy(), "translation": m[:3, 3].copy(),
            }
            (train_meta if subset == "train" else test_meta).append(meta)
            if subset == "test":
                ref_tl[scene] = np.eye(4, dtype=np.float32)
                src_tl[scene] = np.eye(4, dtype=np.float32)
                gt_tl[scene] = m
    for name, meta in (("train", train_meta), ("test", test_meta)):
        with open(root / f"{name}.pkl", "wb") as f:
            pickle.dump(meta, f)
    np.savez(root / "test_transformations.npz", transformations={
        "ref_transformations_list": ref_tl,
        "src_transformations_list": src_tl,
        "gt_transformations_list": gt_tl,
    })
    return str(root)


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-6), k


@pytest.mark.parametrize("subset,augment", [("train", False), ("train", True), ("test", False)])
def test_dataset_items_equal_jax(fake_root, subset, augment):
    """Every item of both datasets, in turn, from the same seed: the train
    split's per-item view rotations and augmentation draws follow the
    same generator; the test split reads the npz frames."""
    from gaussreg_tpu.data.scannet import ScanNetGSRegDataset as JaxDataset
    from gaussreg_tpu_torch.data.scannet import ScanNetGSRegDataset

    kw = dict(point_limit=600, use_augmentation=augment, seed=3)
    jax_ds, port_ds = JaxDataset(fake_root, subset, **kw), ScanNetGSRegDataset(fake_root, subset,
                                                                              **kw)
    assert len(port_ds) == len(jax_ds) == len(SCENES)
    for i in range(len(port_ds)):
        _assert_items_equal(port_ds[i], jax_ds[i])
    assert port_ds.rng.bit_generator.state == jax_ds.rng.bit_generator.state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_pair_equal_jax(seed):
    from gaussreg_tpu.data import scannet as jax_scannet
    from gaussreg_tpu_torch.data import scannet as port_scannet

    src = np.random.default_rng(100 + seed)
    ref_pts, src_pts = src.normal(size=(50, 3)), src.normal(size=(60, 3))
    rot, tr = src.normal(size=(3, 3)), src.normal(size=3)
    outs = [m.augment_pair(np.random.default_rng(seed), ref_pts, src_pts, rot, tr)
            + (m._random_rotation_np(np.random.default_rng(seed), 0.5),)
            for m in (jax_scannet, port_scannet)]
    for a, b in zip(*outs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _estimates(out):
    est = np.load(os.path.join(out, "estimated_transform.npz"),
                  allow_pickle=True)["estimated_transform_list"].item()
    assert set(est) == set(SCENES)
    for t in est.values():
        assert t.shape == (4, 4) and np.isfinite(t).all()
    return est


def test_eval_scannet_tiny_cpu(fake_root, tmp_path, capsys):
    from gaussreg_tpu_torch.tools import eval_scannet

    out = str(tmp_path / "eval_out")
    rc = eval_scannet.main(["--scannet_path", fake_root, "--output_path", out,
                            "--num_sample", "600", "--limit_scenes", "2", "--tiny", "--cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    for scene_line in (f"[1/2] {SCENES[0]}: RRE", f"[2/2] {SCENES[1]}: RRE"):
        assert scene_line in text
    for key in ("rre_avg:", "rte_avg:", "rse_avg:", "rre < 5:", "rre < 10:", "rte < 0.1:",
                "rte < 0.2:", "rse < 0.1:", "rse < 0.2:"):
        assert key in text
    _estimates(out)


def test_eval_scannet_fine_reads_each_model_once(fake_root, tmp_path, capsys):
    """--fine refines from the models that the extraction read: one read of
    each .ply a scene."""
    from gaussreg_tpu_torch.ops import _cuda
    from gaussreg_tpu_torch.tools import eval_scannet

    out = str(tmp_path / "eval_out")
    before = _cuda.launch_counts()["gs.ply_reads"]
    rc = eval_scannet.main(["--scannet_path", fake_root, "--output_path", out,
                            "--num_sample", "600", "--limit_scenes", "2", "--tiny", "--cpu",
                            "--fine", "--fine_steps", "2", "--fine_views", "1",
                            "--max_fine_gaussians", "1000"])
    assert rc == 0 and f"[2/2] {SCENES[1]}: RRE" in capsys.readouterr().out
    assert _cuda.launch_counts()["gs.ply_reads"] - before == 4
    _estimates(out)


def test_eval_scannet_released_weights_path(fake_root, tmp_path, capsys):
    """--tiny_capacities --torch_snapshot: a full-format reference snapshot
    is converted, the per-layer geometry detected, and the recalls
    printed."""
    from gaussreg_tpu_torch.engine.torch_import import fake_reference_state_dict
    from gaussreg_tpu_torch.tools import eval_scannet

    snap = str(tmp_path / "snapshot.pth.tar")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in fake_reference_state_dict().items()},
                "epoch": 40, "iteration": 12345}, snap)
    out = str(tmp_path / "eval_out")
    rc = eval_scannet.main(["--scannet_path", fake_root, "--output_path", out,
                            "--num_sample", "600", "--tiny_capacities", "--torch_snapshot", snap,
                            "--cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "torch import:" in text and "per_layer_geometry=True" in text
    assert "rre_avg:" in text and "rse < 0.2:" in text
    _estimates(out)


def test_eval_scannet_unnormalization_matches_jax(fake_root, tmp_path, monkeypatch, capsys):
    """Both CLIs handed the same normalized estimate (their
    coarse_register_clouds replaced by one that returns it): the written
    transforms in the original frames agree within 1e-4."""
    import gaussreg_tpu.api as jax_api
    import gaussreg_tpu_torch.api as port_api
    from gaussreg_tpu_torch.tools import eval_scannet

    rot = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))[0]
    fixed = np.eye(4, dtype=np.float32)
    fixed[:3, :3] = 1.1 * rot * np.sign(np.linalg.det(rot))
    fixed[:3, 3] = [0.3, -0.1, 0.2]
    monkeypatch.setattr(jax_api, "coarse_register_clouds",
                        lambda *a, **k: {"estimated_transform": fixed})
    monkeypatch.setattr(port_api, "coarse_register_clouds",
                        lambda *a, **k: {"estimated_transform": torch.from_numpy(fixed)})
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["eval_scannet.py", "--scannet_path", fake_root,
                                      "--output_path", jax_out, "--num_sample", "600", "--tiny"])
    runpy.run_path(os.path.join(REPO, "tools", "eval_scannet.py"), run_name="__main__")
    assert eval_scannet.main(["--scannet_path", fake_root, "--output_path", port_out,
                              "--num_sample", "600", "--tiny", "--cpu"]) == 0
    capsys.readouterr()
    jax_est, port_est = _estimates(jax_out), _estimates(port_out)
    for scene in SCENES:
        np.testing.assert_allclose(port_est[scene], jax_est[scene], rtol=0, atol=1e-4)


# tools/eval_synthetic.py:91-105 and the eval step's metrics
SUMMARY_KEYS = {
    "num_pairs", "tier", "mean_RRE_deg", "mean_RTE", "mean_RSE", "mean_RMSE",
    "recall_RMSE<0.2", "recall_RRE<5deg", "recall_RRE<10deg", "recall_RTE<0.1",
    "recall_RTE<0.2", "recall_RSE<0.1", "recall_RSE<0.2",
}
ROW_KEYS = {"RRE", "RTE", "RTE_abs", "RSE", "RMSE", "RR", "PIR", "IR", "vox_overflow",
            "corr_overflow", "seed", "wall_s"}


def test_eval_synthetic_tiny_cpu(tmp_path, capsys):
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.engine.checkpoint import save_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.tools import eval_synthetic

    model = create_model(make_tiny_cfg(), "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    weights = save_checkpoint(str(tmp_path), "tiny", model)
    rc = eval_synthetic.main(["--weights", weights, "--pairs", "2", "--tiny", "--cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "pair   0 seed 20000000: RRE" in text and "pair   1 seed 20000001: RRE" in text
    with open(tmp_path / "eval_transcript.json") as f:
        transcript = json.load(f)
    assert set(transcript) == {"summary", "pairs"}
    assert set(transcript["summary"]) == SUMMARY_KEYS
    assert transcript["summary"]["num_pairs"] == 2 and transcript["summary"]["tier"] == "easy"
    assert [set(r) for r in transcript["pairs"]] == [ROW_KEYS, ROW_KEYS]
    assert f"transcript -> {tmp_path / 'eval_transcript.json'}" in text
