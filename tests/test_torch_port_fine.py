"""The port's fine registration (gs/fine_registration.py, gs/cameras.py and
the fine branch of api.register_gs_pair) against the JAX package on the CPU.

One scene, made with numpy from a seed, goes through both sides; the port
runs on `device="cpu"`, where the rasterizer's wrappers take their plain
PyTorch versions, and the JAX side runs its Pallas kernels in interpret
mode (`use_pallas=True` off the TPU). Each test states its tolerance and
the reason.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussreg_tpu.gs import cameras as jcameras
from gaussreg_tpu.gs import fine_registration as jfine
from gaussreg_tpu.gs.ply import GaussianModel as JGaussianModel
from gaussreg_tpu_torch.gs import cameras as tcameras
from gaussreg_tpu_torch.gs import fine_registration as tfine
from gaussreg_tpu_torch.gs.ply import GaussianModel, save_gaussians

FIELDS = ("means", "scales", "quats", "opacities", "sh_coeffs", "valid")


def _scene_arrays(n=60, seed=0):
    """The 60-gaussian scene of tests/test_fine_registration.py."""
    rng = np.random.default_rng(seed)
    return dict(
        means=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        scales=np.exp(rng.normal(-1.8, 0.3, size=(n, 3))).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.6, 0.95, size=n).astype(np.float32),
        sh_coeffs=np.concatenate(
            [rng.uniform(-0.8, 0.8, size=(n, 3, 1)), rng.normal(scale=0.03, size=(n, 3, 15))],
            axis=2,
        ).astype(np.float32),
    )


def _both(arrays):
    n = arrays["means"].shape[0]
    j = jfine.GaussiansDevice(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, valid=jnp.ones(n, bool)
    )
    t = tfine.gaussians_from_numpy(**arrays, device="cpu")
    return j, t


def _gt():
    from scipy.spatial.transform import Rotation

    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = 1.05 * Rotation.from_rotvec([0.0, 0.06, 0.03]).as_matrix().astype(np.float32)
    gt[:3, 3] = [0.05, -0.03, 0.02]
    return gt


def _host_model(n=50, seed=2):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        f_dc=rng.normal(scale=0.3, size=(n, 3, 1)).astype(np.float32),
        f_rest=rng.normal(scale=0.02, size=(n, 3, 15)).astype(np.float32),
        opacity=rng.normal(1.0, 2.0, size=(n, 1)).astype(np.float32),
        scales=rng.normal(-3.0, 0.2, size=(n, 3)).astype(np.float32),
        rots=rng.normal(size=(n, 4)).astype(np.float32),
    )


@pytest.mark.parametrize("cap", [None, 30, 80])
def test_to_device_gaussians_matches(cap):
    """Activation, the opacity-ordered cut (cap 30 of 50) and the padding
    (cap 80): every field within 1e-6 (exp and the sigmoid in f32 against
    numpy's f64 rounded once). One stated difference: padding rows carry the
    identity quaternion in the port and zeros in the JAX package, whose zero
    quaternion turns into NaN in the pose gradient."""
    fields = _host_model()
    gj = jfine.to_device_gaussians(JGaussianModel(**fields), cap)
    gt = tfine.to_device_gaussians(GaussianModel(**fields), cap, device="cpu")
    n_real = min(50, cap or 50)
    for name in FIELDS:
        a, b = np.asarray(getattr(gj, name)), getattr(gt, name).numpy()
        assert a.shape == b.shape, name
        if name == "quats":
            assert (b[n_real:] == np.array([1, 0, 0, 0], np.float32)).all()
            a, b = a[:n_real], b[:n_real]
        np.testing.assert_allclose(b, a, atol=1e-6, err_msg=name)


def test_padded_gaussians_keep_the_pose_gradient_finite():
    """A model padded up to its cap (as api.register_gs_pair pads to
    max_fine_gaussians) still refines: losses and transform finite."""
    fields = _host_model()
    g = tfine.to_device_gaussians(GaussianModel(**fields), 64, device="cpu")
    cams = tfine.default_cameras(fields["xyz"], num_views=1, width=64, height=32)
    out = tfine.fine_register(g, g, np.eye(4, dtype=np.float32), cams, num_steps=2)
    assert torch.isfinite(out.losses).all() and torch.isfinite(out.transform).all()


def test_transform_gaussians_device_matches():
    """The similarity transform of device gaussians (means, scales, composed
    quaternions, rotated SH) within 1e-5: the same formulas in f32."""
    src_j, src_t = _both(_scene_arrays())
    gt = _gt()
    mj = jfine.transform_gaussians_device(src_j, jnp.asarray(gt))
    mt = tfine.transform_gaussians_device(src_t, torch.from_numpy(gt))
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), atol=1e-5, err_msg=name
        )


def test_default_cameras_and_cameras_json(tmp_path):
    """Orbit cameras are built on the host with numpy: equal to 1e-6. A
    cameras.json written by the port is read by the JAX package as the same
    cameras, and the port reads it back with the 3DGS layout's search, the
    max_cameras subsampling and the max_size rescale (1e-5: the rotation is
    transposed twice and the position recomputed, in f32)."""
    pts = _scene_arrays()["means"]
    cj = jfine.default_cameras(pts, num_views=3, width=96, height=64)
    ct = tfine.default_cameras(pts, num_views=3, width=96, height=64)
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b.w2c.numpy(), np.asarray(a.w2c), atol=1e-6)
        assert tuple(b[1:]) == pytest.approx(tuple(a[1:]))
        np.testing.assert_allclose(b.cam_center.numpy(), np.asarray(a.cam_center), atol=1e-5)

    model_dir = tmp_path / "output"
    ply_dir = model_dir / "point_cloud" / "iteration_10000"
    ply_dir.mkdir(parents=True)
    ply_path = ply_dir / "point_cloud.ply"
    ply_path.write_bytes(b"")
    path = str(model_dir / "cameras.json")
    tcameras.save_cameras_json(path, ct)
    assert tcameras.find_cameras_json(str(ply_path)) == path
    assert tcameras.find_cameras_json(str(tmp_path / "elsewhere.ply")) is None
    for loaded in (jcameras.load_cameras_json(path), tcameras.load_cameras_json(path)):
        assert len(loaded) == 3
        for a, b in zip(ct, loaded):
            np.testing.assert_allclose(np.asarray(b.w2c), a.w2c.numpy(), atol=1e-5)
            assert tuple(b[1:]) == pytest.approx(tuple(a[1:]))
    sub_j = jcameras.load_cameras_json(path, max_cameras=2, max_size=48)
    sub_t = tcameras.load_cameras_json(path, max_cameras=2, max_size=48)
    assert len(sub_t) == 2 and max(sub_t[0].width, sub_t[0].height) <= 48
    for a, b in zip(sub_j, sub_t):
        np.testing.assert_allclose(b.w2c.numpy(), np.asarray(a.w2c), atol=1e-6)
        assert tuple(b[1:]) == pytest.approx(tuple(a[1:]))
    with open(path, "w") as f:
        f.write("[]")
    with pytest.raises(ValueError):
        tcameras.load_cameras_json(path)


def test_fine_register_matches():
    """fine_register for 5 steps with a re-probe after the third (segments of
    3 and 2), from the identity, on the 60-gaussian scene with two 96x64
    views. Both sides run their tile path: probes, capacities, sat_depth
    carried from step to step, Adam. Losses and the refined transform within
    1e-3: each step's gradient agrees to ~2e-3 of its size (the limit of the
    rasterizer's gradient tests), Adam normalises it, so a step of lr = 5e-3
    can differ by a small share of itself; overflow equal (0)."""
    src_j, src_t = _both(_scene_arrays())
    gt = _gt()
    ref_j = jfine.transform_gaussians_device(src_j, jnp.asarray(gt))
    ref_t = tfine.transform_gaussians_device(src_t, torch.from_numpy(gt))
    pts = _scene_arrays()["means"]
    kw = dict(num_views=2, width=96, height=64)
    steps = dict(num_steps=5, lr=5e-3, reprobe_every=3)
    out_j = jfine.fine_register(
        ref_j, src_j, jnp.eye(4), jfine.default_cameras(pts, **kw), use_pallas=True, **steps
    )
    out_t = tfine.fine_register(
        ref_t, src_t, torch.eye(4), tfine.default_cameras(pts, **kw), **steps
    )
    assert out_t.losses.shape == (5,) and out_t.transform.shape == (4, 4)
    np.testing.assert_allclose(out_t.losses.numpy(), np.asarray(out_j.losses), atol=1e-3)
    np.testing.assert_allclose(out_t.transform.numpy(), np.asarray(out_j.transform), atol=1e-3)
    assert int(out_t.overflow) == int(out_j.overflow) == 0
    assert float(out_t.losses[-1]) < float(out_t.losses[0])
    # the pose moved (the agreement above is not that of two idle loops)
    assert np.abs(out_t.transform.numpy() - np.eye(4)).max() > 5e-3


def test_fine_register_options():
    """The dense reference renderer and the tile path refine alike (losses
    within 1e-3: the renderers agree to 5e-4 per pixel), with and without
    the saturation cull and the adaptive max_tiles_per_gaussian."""
    src = _both(_scene_arrays())[1]
    ref = tfine.transform_gaussians_device(src, torch.from_numpy(_gt()))
    cams = tfine.default_cameras(_scene_arrays()["means"], num_views=1, width=64, height=32)
    runs = [
        tfine.fine_register(ref, src, torch.eye(4), cams, num_steps=3, lr=5e-3, **kw)
        for kw in (
            dict(),
            dict(dense_reference=True),
            dict(sat_cull=False, adaptive_mt=False),
        )
    ]
    for other in runs[1:]:
        np.testing.assert_allclose(other.losses.numpy(), runs[0].losses.numpy(), atol=1e-3)
        np.testing.assert_allclose(other.transform.numpy(), runs[0].transform.numpy(), atol=1e-3)
    empty = tfine.fine_register(ref, src, torch.eye(4), cams, num_steps=0)
    assert empty.losses.shape == (0,) and torch.equal(empty.transform, torch.eye(4))


def test_register_gs_pair_fine_on_cpu(tmp_path):
    """api.register_gs_pair(fine=True) end to end on the CPU at a tiny size:
    two .ply files, a tiny coarse model with random weights, two 64x48 views
    from a cameras.json found next to the reference model, three steps. The
    coarse transform of random weights is arbitrary; the check is that the
    fine branch runs from it and returns finite results of the right shapes."""
    from gaussreg_tpu_torch.api import register_gs_pair
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.models.registration import create_model

    rng = np.random.default_rng(0)
    n = 1200
    paths = []
    for name, shift in (("ref.ply", 0.0), ("src.ply", 0.05)):
        g = GaussianModel(
            xyz=rng.uniform(0, 3.0, size=(n, 3)).astype(np.float32) + shift,
            f_dc=rng.normal(scale=0.3, size=(n, 3, 1)).astype(np.float32),
            f_rest=rng.normal(scale=0.02, size=(n, 3, 15)).astype(np.float32),
            opacity=np.full((n, 1), 2.5, np.float32),
            scales=rng.normal(-3.0, 0.2, size=(n, 3)).astype(np.float32),
            rots=rng.normal(size=(n, 4)).astype(np.float32),
        )
        paths.append(str(tmp_path / name))
        save_gaussians(paths[-1], g)
    cams = tfine.default_cameras(np.full((2, 3), 1.5) + [[-1.5], [1.5]], num_views=2,
                                 width=64, height=48)
    tcameras.save_cameras_json(str(tmp_path / "cameras.json"), cams)

    cfg = make_tiny_cfg()
    model = create_model(cfg, "cpu")
    res = register_gs_pair(paths[0], paths[1], model, cfg, fine=True, fine_steps=3,
                           max_fine_gaussians=1500, device="cpu")
    assert res["fine_cameras"] == str(tmp_path / "cameras.json")
    assert res["transform"].shape == (4, 4) and np.isfinite(res["transform"]).all()
    assert res["fine_losses"].shape == (3,) and np.isfinite(res["fine_losses"]).all()
    assert np.isfinite(res["coarse_transform"]).all()
    assert not np.array_equal(res["transform"], res["coarse_transform"])
