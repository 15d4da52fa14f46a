"""Host side and packaging of the port: the checkpoint reader, the
parameter mapping, the host front end (.ply, extraction, synthetic pairs),
the device default, the API plumbing, and that the port imports nothing of
JAX. Host numpy code is compared with the JAX package's exactly."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "synthetic_coarse.msgpack")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_msgpack_reader_matches_flax_on_committed_checkpoint():
    from flax import serialization
    from gaussreg_tpu_torch.engine.checkpoint import read_flax_msgpack

    with open(CKPT, "rb") as f:
        ref = _flat(serialization.msgpack_restore(f.read()))
    ours = _flat(read_flax_msgpack(CKPT))
    assert ours.keys() == ref.keys()
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(ours[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_committed_checkpoint_loads_into_full_width_model():
    """Every parameter of the make_cfg() port model is filled (strict load),
    with Dense kernels transposed and KPConv weights in the JAX layout."""
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint, read_flax_msgpack
    from gaussreg_tpu_torch.models.registration import GaussRegModel

    sd = load_checkpoint(CKPT)
    model = GaussRegModel(make_cfg())
    model.load_state_dict(sd, strict=True)
    tree = read_flax_msgpack(CKPT)["params"]["params"]
    dense = tree["transformer"]["in_proj"]["kernel"]
    np.testing.assert_array_equal(model.transformer.in_proj.weight.detach().numpy(), dense.T)
    kp = tree["backbone"]["CheckpointResidualBlock_12"]["KPConv_0"]["weights"]
    np.testing.assert_array_equal(model.backbone.encoder5_3.conv.weights.detach().numpy(), kp)


def test_config_defaults_equal_jax():
    import dataclasses

    from gaussreg_tpu import config as jc
    from gaussreg_tpu_torch import config as tc

    for make in ("make_cfg", "make_tiny_cfg"):
        assert dataclasses.asdict(getattr(tc, make)()) == dataclasses.asdict(getattr(jc, make)())


def test_geometry_helpers_match_jax():
    import jax.numpy as jnp

    from gaussreg_tpu.ops import misc as jm
    from gaussreg_tpu.ops import transforms as jt
    from gaussreg_tpu_torch.ops import misc as tm
    from gaussreg_tpu_torch.ops import transforms as tt

    rng = np.random.default_rng(6)
    a, b = (rng.normal(size=(7, 3)).astype(np.float32) for _ in range(2))
    t = lambda x: torch.from_numpy(x)
    np.testing.assert_allclose(tm.vector_angle(t(a), t(b)).numpy(),
                               np.asarray(jm.vector_angle(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    idx = rng.integers(0, 7, size=(2, 4))
    np.testing.assert_array_equal(tm.index_select(t(a), t(idx), 0).numpy(),
                                  np.asarray(jm.index_select(jnp.asarray(a), jnp.asarray(idx), 0)))
    m = rng.normal(size=(5, 4, 4)).astype(np.float32)
    m[:, 3] = [0, 0, 0, 1]
    pts = rng.normal(size=(5, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.apply_transform(t(pts), t(m)).numpy(),
                               np.asarray(jt.apply_transform(jnp.asarray(pts), jnp.asarray(m))),
                               rtol=0, atol=1e-5)
    for x, y in zip(tt.rotation_translation_scale_from_transform(t(m)),
                    jt.rotation_translation_scale_from_transform(jnp.asarray(m))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)


def test_random_pair_matches_jax():
    from gaussreg_tpu.config import make_tiny_cfg
    from gaussreg_tpu.data.synthetic import random_pair as jax_pair
    from gaussreg_tpu_torch.config import make_tiny_cfg as t_tiny
    from gaussreg_tpu_torch.data.synthetic import random_pair

    for a, b in zip(jax_pair(make_tiny_cfg(), 5, tier="hard"), random_pair(t_tiny(), 5, tier="hard")):
        np.testing.assert_array_equal(b, a)


def _scene_plys(tmp_path, n=1200):
    from gaussreg_tpu_torch.gs.ply import GaussianModel, save_gaussians

    rng = np.random.default_rng(0)
    paths = []
    for name, shift in (("ref.ply", 0.0), ("src.ply", 0.3)):
        xyz = rng.uniform(0, 3.0, size=(n, 3)).astype(np.float32) + shift
        g = GaussianModel(
            xyz=xyz,
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


def test_ply_extraction_matches_jax(tmp_path):
    from gaussreg_tpu.gs.extract import load_point_cloud_from_gs_ply as jax_load
    from gaussreg_tpu_torch.gs.extract import load_point_cloud_from_gs_ply

    ref_ply, _ = _scene_plys(tmp_path)
    for limit in (None, 500):
        a = jax_load(ref_ply, limit, seed=3)
        b = load_point_cloud_from_gs_ply(ref_ply, limit, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


def test_register_gs_pair_cpu_plumbing(tmp_path):
    from gaussreg_tpu_torch.api import register_gs_pair, write_demo_outputs
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.models.registration import create_model

    cfg = make_tiny_cfg()
    model = create_model(cfg, "cpu")
    ref_ply, src_ply = _scene_plys(tmp_path)
    res = register_gs_pair(ref_ply, src_ply, model, cfg, device="cpu")
    assert res["transform"].shape == (4, 4) and np.isfinite(res["transform"]).all()
    paths = write_demo_outputs(str(tmp_path / "out"), res)
    assert all(os.path.exists(p) for p in paths)
    # the fine branch too resolves its device first: without a card and
    # without device="cpu" it raises instead of refining on the CPU
    # (tests/test_torch_port_fine.py runs it with device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            register_gs_pair(ref_ply, src_ply, model, cfg, fine=True)


def test_entry_points_default_to_cuda():
    """Without CUDA, the default device raises instead of falling back."""
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.models.registration import create_model

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(make_tiny_cfg())
    assert resolve_device("cpu").type == "cpu"


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gaussreg_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    banned = ("jax", "flax", "gaussreg_tpu")
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path} imports {name}"
    code = (
        "import sys; import gaussreg_tpu_torch.api, gaussreg_tpu_torch.engine.checkpoint, "
        "gaussreg_tpu_torch.data.synthetic; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'gaussreg_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={**os.environ, "PYTHONPATH": ROOT})
