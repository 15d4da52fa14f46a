"""The port's rotation algebra (ops/transforms.py), SH evaluation and
rotation (gs/sh.py) and model fusion (gs/fusion.py) against the JAX package
on the CPU. Inputs are made with numpy from a seed and go through both
sides; each test states its tolerance and the reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from gaussreg_tpu.gs import fusion as jfusion
from gaussreg_tpu.gs import sh as jsh
from gaussreg_tpu.gs.ply import GaussianModel as JGaussianModel
from gaussreg_tpu.ops import transforms as jtr
from gaussreg_tpu_torch.gs import fusion as tfusion
from gaussreg_tpu_torch.gs import sh as tsh
from gaussreg_tpu_torch.gs.ply import GaussianModel, load_gaussians, save_gaussians
from gaussreg_tpu_torch.ops import transforms as ttr

MODEL_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scales", "rots")


def _rotations(n=32, seed=0):
    """Random rotations plus the corners of matrix_to_quaternion: the
    identity and half-turns about x, y and z (one per candidate branch)."""
    r = Rotation.random(n, random_state=seed).as_matrix()
    corners = Rotation.from_rotvec(
        [[0, 0, 0], [np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi]]
    ).as_matrix()
    return np.concatenate([r, corners]).astype(np.float32)


def test_rotation_algebra_matches():
    """skew_symmetric, exp_so3, quaternion_to_matrix, matrix_to_quaternion
    and quaternion_multiply within 1e-5 (the same formulas in f32; sin, cos
    and sqrt may differ in the last bit)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    v[0] = 0.0  # the Taylor branch of exp_so3
    v[1] *= 1e-5
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    mats = _rotations()
    for name, args in (
        ("skew_symmetric", (v,)),
        ("exp_so3", (v,)),
        ("quaternion_to_matrix", (q,)),
        ("matrix_to_quaternion", (mats,)),
        ("quaternion_multiply", (q, q2)),
    ):
        want = np.asarray(getattr(jtr, name)(*[jnp.asarray(a) for a in args]))
        got = getattr(ttr, name)(*[torch.from_numpy(a) for a in args]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
    # a quaternion survives the round trip up to sign
    back = ttr.matrix_to_quaternion(ttr.quaternion_to_matrix(torch.from_numpy(q))).numpy()
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(back * np.sign(np.sum(back * qn, 1, keepdims=True)), qn, atol=1e-5)


def test_rotation_algebra_gradients_are_finite_and_match():
    """Gradients through exp_so3 at and near 0 and through
    matrix_to_quaternion at every branch's corner: finite (the branch not
    taken must not put NaN through the where), and within 1e-4 of jax.grad
    (1e-5 relative on sums of a few dozen f32 terms)."""
    w3 = np.linspace(0.5, 1.5, 9, dtype=np.float32).reshape(3, 3)
    w4 = np.linspace(-1.0, 2.0, 4, dtype=np.float32)
    for omega in ([0.0, 0.0, 0.0], [1e-5, -2e-5, 0.0], [0.3, -0.2, 0.5]):
        x = torch.tensor(omega, requires_grad=True)
        (ttr.exp_so3(x) * torch.from_numpy(w3)).sum().backward()
        want = jax.grad(lambda o: jnp.sum(jtr.exp_so3(o) * w3))(jnp.asarray(omega, jnp.float32))
        assert torch.isfinite(x.grad).all()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-4)
    for m in _rotations(4):
        x = torch.from_numpy(m.copy()).requires_grad_(True)
        (ttr.matrix_to_quaternion(x) * torch.from_numpy(w4)).sum().backward()
        want = jax.grad(lambda a: jnp.sum(jtr.matrix_to_quaternion(a) * w4))(jnp.asarray(m))
        assert torch.isfinite(x.grad).all()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-4)


def test_sh_rotation_matches():
    """band_rotation_operators and rotate_sh_rest within 1e-5: the same
    fixed direction sets and pseudo-inverses (computed by numpy on both
    sides), then one small f32 product. Rotated coefficients evaluate at a
    rotated direction to what the originals give at the original one (1e-4:
    the least-squares operators are exact only up to f32)."""
    rng = np.random.default_rng(1)
    r = _rotations(1, seed=5)[0]
    ops_j = jsh.band_rotation_operators(jnp.asarray(r))
    ops_t = tsh.band_rotation_operators(torch.from_numpy(r))
    assert sorted(ops_t) == sorted(ops_j) == [1, 2, 3]
    for band in (1, 2, 3):
        assert ops_t[band].shape == (2 * band + 1, 2 * band + 1)
        np.testing.assert_allclose(ops_t[band].numpy(), np.asarray(ops_j[band]), atol=1e-5)
    f_rest = rng.normal(size=(40, 3, 15)).astype(np.float32)
    want = np.asarray(jsh.rotate_sh_rest(jnp.asarray(f_rest), jnp.asarray(r)))
    got = tsh.rotate_sh_rest(torch.from_numpy(f_rest), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dc = rng.normal(size=(40, 3, 1)).astype(np.float32)
    before = tsh.eval_sh(3, torch.from_numpy(np.concatenate([dc, f_rest], 2)), torch.from_numpy(dirs))
    after = tsh.eval_sh(3, torch.cat([torch.from_numpy(dc), got], 2), torch.from_numpy(dirs @ r.T))
    np.testing.assert_allclose(after.numpy(), before.numpy(), atol=1e-4)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_on_tensors_matches_with_gradient(deg):
    """eval_sh on tensors within 1e-5 of the JAX one, and its gradients for
    the coefficients and the directions within 1e-5 of jax.grad's (a
    polynomial of degree <= 3 in f32)."""
    rng = np.random.default_rng(deg)
    k = (deg + 1) ** 2
    sh = rng.normal(size=(25, 3, k)).astype(np.float32)
    dirs = rng.normal(size=(25, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    w = rng.normal(size=(25, 3)).astype(np.float32)
    ts, td = torch.from_numpy(sh).requires_grad_(True), torch.from_numpy(dirs).requires_grad_(True)
    out = tsh.eval_sh(deg, ts, td)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))),
        atol=1e-5,
    )
    (out * torch.from_numpy(w)).sum().backward()
    gs, gd = jax.grad(lambda s, d: jnp.sum(jsh.eval_sh(deg, s, d) * w), argnums=(0, 1))(
        jnp.asarray(sh), jnp.asarray(dirs)
    )
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), atol=1e-5)
    if deg > 0:
        np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), atol=1e-5)
    else:
        assert td.grad is None  # degree 0 does not read the directions


def _model(n, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=(rng.uniform(-1, 1, size=(n, 3)) + shift).astype(np.float32),
        f_dc=rng.normal(scale=0.3, size=(n, 3, 1)).astype(np.float32),
        f_rest=rng.normal(scale=0.05, size=(n, 3, 15)).astype(np.float32),
        opacity=rng.normal(1.0, 1.0, size=(n, 1)).astype(np.float32),
        scales=rng.normal(-3.0, 0.3, size=(n, 3)).astype(np.float32),
        rots=rng.normal(size=(n, 4)).astype(np.float32),
    )


def _similarity(seed=3, scale=1.3):
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = scale * _rotations(1, seed=seed)[0]
    t[:3, 3] = [0.4, -0.2, 0.1]
    return t


def _assert_models_close(got, want, atol):
    for name in MODEL_FIELDS:
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.shape == b.shape, name
        if name == "rots":  # q and -q are one rotation; both sides pick alike
            b = b * np.sign(np.sum(a * b, axis=1, keepdims=True))
        np.testing.assert_allclose(b, a, atol=atol, err_msg=name)


def test_transform_gaussians_matches():
    """Similarity transform of a host model: every field within 1e-5 (the
    same f32 formulas); f_dc and opacity pass through unchanged."""
    fields = _model(300, 0)
    t = _similarity()
    want = jfusion.transform_gaussians(JGaussianModel(**fields), t)
    got = tfusion.transform_gaussians(GaussianModel(**fields), t, device="cpu")
    _assert_models_close(got, want, 1e-5)
    assert got.f_dc is fields["f_dc"] and got.opacity is fields["opacity"]
    np.testing.assert_allclose(got.scales, fields["scales"] + np.log(1.3), atol=1e-5)


@pytest.mark.parametrize("shift", [0.6, 0.1])
def test_fuse_gaussians_matches(shift):
    """fuse_gaussians on two models whose centroids lie 0.6 and 0.1 apart
    (the second overlaps the first almost wholly): the same keep masks, so
    the same gaussians in the same order, and fields within 1e-5."""
    f1, f2 = _model(300, 1), _model(280, 2, shift=shift)
    t = _similarity()
    want = jfusion.fuse_gaussians(JGaussianModel(**f1), JGaussianModel(**f2), t)
    got = tfusion.fuse_gaussians(GaussianModel(**f1), GaussianModel(**f2), t, device="cpu")
    assert 0 < got.num_gaussians < 580
    _assert_models_close(got, want, 1e-5)


def test_keep_masks_are_asymmetric_on_exact_ties():
    """Identical clouds: every distance pair is an exact tie; model 1 keeps
    all its points and model 2 none, on both sides."""
    xyz = _model(50, 4)["xyz"]
    k1, k2 = tfusion._keep_masks_device(torch.from_numpy(xyz), torch.from_numpy(xyz))
    j1, j2 = jfusion._keep_masks_device(jnp.asarray(xyz), jnp.asarray(xyz))
    assert k1.all() and not k2.any()
    assert np.asarray(j1).all() and not np.asarray(j2).any()


def test_gaussian_fuse_files(tmp_path):
    """The file-level entry point: two .ply models and an
    estimated_transform .npz in, one fused .ply out, equal (1e-5) to the
    JAX package's file for the same inputs."""
    from gaussreg_tpu_torch.api import gaussian_fuse

    p1, p2 = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    save_gaussians(p1, GaussianModel(**_model(200, 5)))
    save_gaussians(p2, GaussianModel(**_model(180, 6, shift=0.5)))
    npz = str(tmp_path / "t.npz")
    np.savez(npz, estimated_transform=_similarity())
    out_t, out_j = str(tmp_path / "fused_t.ply"), str(tmp_path / "fused_j.ply")
    gaussian_fuse(p1, p2, npz, out_t, device="cpu")
    jfusion.gaussian_fuse(p1, p2, npz, out_j)
    got, want = load_gaussians(out_t), load_gaussians(out_j)
    assert 0 < got.num_gaussians < 380
    _assert_models_close(got, want, 1e-5)
