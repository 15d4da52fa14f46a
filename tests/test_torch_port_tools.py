"""The port's reference-checkpoint import (gaussreg_tpu_torch/engine/
torch_import.py) against the JAX package's, and its `demo` and `fuse` CLIs
(gaussreg_tpu_torch/tools/demo.py, fuse.py) end to end on the CPU.

The JAX side's parameter tree comes from jax.eval_shape of model.init at
make_cfg() on a 600-point pair (the shapes and dtypes of
tests/test_torch_import.py's fixture, without its ~2 minutes of eager
init): with every leaf in the state dict, convert_state_dict reads only
shapes and dtypes from it.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
from gaussreg_tpu_torch.engine import torch_import as ti
from gaussreg_tpu_torch.engine.checkpoint import flax_from_params, params_from_flax
from gaussreg_tpu_torch.models.registration import create_model


@pytest.fixture(scope="module")
def port_model():
    return create_model(make_cfg(), "cpu")


def _jax_param_shapes():
    import jax

    from gaussreg_tpu.config import make_cfg as jax_cfg
    from gaussreg_tpu.data.pipeline import make_pair_batch
    from gaussreg_tpu.data.synthetic import random_pair
    from gaussreg_tpu.models.registration import create_model as jax_model

    cfg = jax_cfg()
    model = jax_model(cfg)
    rp, rf, sp, sf, m = random_pair(cfg, 0, num_points=600)
    batch = make_pair_batch(cfg, rp, rf, sp, sf, m)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(
        lambda b: model.init({"params": key, "sample": key, "ransac": key}, b, train=False,
                             with_transform=False),
        batch,
    )


def test_convert_state_dict_matches_jax(port_model):
    from gaussreg_tpu.engine.torch_import import convert_state_dict as jax_convert

    sd = ti.fake_reference_state_dict()
    sd_ddp = {f"module.{k}": v for k, v in sd.items()}  # the DDP prefix is stripped
    jax_tree, jax_report = jax_convert(sd, _jax_param_shapes())
    tree, report = ti.convert_state_dict(sd_ddp, ti.model_params_tree(port_model))
    assert report == jax_report
    assert report["missing"] == [] and report["unexpected"] == []
    assert report["converted"] == len(port_model.state_dict())
    assert report["per_layer_kernel_geometry"]
    want = params_from_flax(jax_tree["params"])
    got = params_from_flax(tree["params"])
    assert set(got) == set(want) == set(port_model.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # spot checks: a Linear transposed twice back to torch's layout, KPConv copied
    assert torch.equal(got["transformer.in_proj.weight"],
                       torch.from_numpy(sd["transformer.in_proj.weight"]))
    assert torch.equal(got["backbone.encoder3_2.conv.weights"],
                       torch.from_numpy(sd["backbone.encoder3_2.KPConv.weights"]))


def test_convert_shape_mismatch_raises(port_model):
    sd = ti.fake_reference_state_dict()
    sd["transformer.in_proj.weight"] = sd["transformer.in_proj.weight"][:, :17]
    with pytest.raises(ValueError, match="in_proj"):
        ti.convert_state_dict(sd, ti.model_params_tree(port_model))


def test_flax_tree_round_trip(port_model):
    sd = port_model.state_dict()
    back = params_from_flax(flax_from_params(sd))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_pin_reference_neighbor_limits():
    from gaussreg_tpu_torch.config import REFERENCE_NEIGHBOR_LIMITS

    full = make_cfg()
    assert ti.pin_reference_neighbor_limits(full).capacity.neighbor_limits == \
        REFERENCE_NEIGHBOR_LIMITS
    tiny = make_tiny_cfg()
    assert ti.pin_reference_neighbor_limits(tiny) == tiny
    custom = dataclasses.replace(
        full, capacity=dataclasses.replace(full.capacity, neighbor_limits=(50, 30, 30, 30, 30)))
    assert ti.pin_reference_neighbor_limits(custom) == custom


def _save_snapshot(path, seed=0):
    sd = ti.fake_reference_state_dict(seed)
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    return sd


def test_load_for_inference_rebuilds_for_per_layer_geometry(tmp_path, port_model):
    path = str(tmp_path / "snapshot.pth.tar")
    sd = _save_snapshot(path)
    cfg, model, report = ti.load_for_inference(path, make_cfg(), port_model)
    assert report["converted"] == len(sd) and report["per_layer_kernel_geometry"]
    assert not cfg.backbone.shared_kpconv_geometry and model is not port_model
    assert not model.backbone.shared_geometry
    assert next(model.parameters()).device.type == "cpu"
    assert torch.equal(model.state_dict()["backbone.encoder1_1.conv.kernel_points"],
                       torch.from_numpy(sd["backbone.encoder1_1.KPConv.kernel_points"]))


def _scene_plys(tmp_path, n=800):
    """Two small .ply models of one random scene, the second shifted."""
    from gaussreg_tpu_torch.gs.ply import GaussianModel, save_gaussians

    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 3.0, size=(n, 3)).astype(np.float32)
    paths = []
    for name, shift in (("ref.ply", 0.0), ("src.ply", 0.2)):
        g = GaussianModel(
            xyz=xyz + np.float32(shift),
            f_dc=rng.normal(scale=0.3, size=(n, 3, 1)).astype(np.float32),
            f_rest=rng.normal(scale=0.02, size=(n, 3, 15)).astype(np.float32),
            opacity=np.full((n, 1), 2.5, np.float32),
            scales=rng.normal(-3.0, 0.2, size=(n, 3)).astype(np.float32),
            rots=rng.normal(size=(n, 4)).astype(np.float32),
        )
        p = str(tmp_path / name)
        save_gaussians(p, g)
        paths.append(p)
    return paths


def test_demo_and_fuse_clis_on_the_cpu(tmp_path):
    """demo with a reference snapshot (one full-width forward on the CPU),
    then fuse with explicit paths and with the --root_path layout."""
    from gaussreg_tpu_torch.gs.ply import load_gaussians
    from gaussreg_tpu_torch.tools import demo, fuse

    ref_ply, src_ply = _scene_plys(tmp_path)
    snapshot = str(tmp_path / "snapshot.pth.tar")
    _save_snapshot(snapshot)
    out = tmp_path / "out"
    assert demo.main(["--ref", ref_ply, "--src", src_ply, "--torch_snapshot", snapshot,
                      "--output_dir", str(out), "--device", "cpu"]) == 0
    names = ("point_cloud_src_org.ply", "point_cloud_ref.ply", "point_cloud_src.ply",
             "estimated_transform.npz")
    assert all((out / n).exists() for n in names)
    t = np.load(out / "estimated_transform.npz")["estimated_transform"]
    assert t.shape == (4, 4) and np.isfinite(t).all()

    # fuse with the known transform (src -> ref is a shift by -0.2)
    gt = np.eye(4)
    gt[:3, 3] = -0.2
    npz = str(tmp_path / "gt.npz")
    np.savez(npz, estimated_transform=gt)
    fused = str(tmp_path / "fused.ply")
    assert fuse.main(["--input1", ref_ply, "--input2", src_ply, "--transform_path", npz,
                      "--output", fused, "--device", "cpu"]) == 0
    g = load_gaussians(fused)
    assert 800 <= g.num_gaussians <= 1600 and np.isfinite(g.xyz).all()

    # the --root_path layout
    root = tmp_path / "scene"
    for side, src in (("A", ref_ply), ("B", src_ply)):
        d = root / side / "output" / "point_cloud" / "iteration_30000"
        d.mkdir(parents=True)
        os.link(src, d / "point_cloud.ply")
    (root / "A" / "output" / "cameras.json").write_text("[]")
    assert fuse.main(["--root_path", str(root), "--transform_path", npz, "--device", "cpu"]) == 0
    fused_root = root / "fuse" / "output" / "point_cloud" / "iteration_30000" / "point_cloud.ply"
    assert load_gaussians(str(fused_root)).num_gaussians == g.num_gaussians
    assert (root / "fuse" / "output" / "cameras.json").exists()


def test_clis_default_to_cuda(tmp_path):
    """Without a card, the CLIs' default device raises instead of falling
    back to the CPU."""
    from gaussreg_tpu_torch.tools import demo, fuse

    from gaussreg_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--ref", "a.ply", "--src", "b.ply", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fuse.main(["--input1", "a.ply", "--input2", "b.ply", "--output", "c.ply"])
    # the diagnostic and profiling twins: CUDA unless --cpu
    for name, argv in (
        ("calibrate_neighbors", []),
        ("probe_overflow", []),
        ("diagnose_eval", ["--ckpt", "w.msgpack"]),
        ("diagnose_hard_failures", ["--ckpt", "w.msgpack"]),
        ("probe_generalization", ["--weights", "w.msgpack"]),
        ("profile_fine", []),
        ("profile_eval", []),
        ("profile_trainstep", []),
    ):
        module = importlib.import_module(f"gaussreg_tpu_torch.tools.{name}")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.main(argv)
