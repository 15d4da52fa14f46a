"""render_sharded over 2 gloo ranks on the CPU against the port's render
and the JAX package's render_sharded on a 2-device slice of the virtual
CPU devices.

The ranks run in their own processes (gaussreg_tpu_torch.tools.
render_sharded_check, one spawn with a 120 s limit); no process group is
started in the test process. Tolerances are the JAX package's own for its
render_sharded (tests/test_rasterizer.py: rgb and T 5e-4, depth 2e-3,
gradients 2e-3 of each gradient's max). Against the port's render the
pixels must also be equal bit for bit: the port's slices keep the whole
image's frame (tiles, exponents' pixel coordinates, pair blocks); the
gradients sum each gaussian's rows per slice and then across the ranks,
which rounds otherwise.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)  # several xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("means", "scales", "quats", "opacities", "sh")
TILE = 16
WIDTH, HEIGHT = 40, 50  # 50 % (2 * 16) != 0: the last rank holds 18 rows


def _scene(n=100, seed=5):
    """tests/test_rasterizer.py's scene."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(loc=-2.5, scale=0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    sh[:, :, 1:] = rng.normal(scale=0.05, size=(n, 3, 15))
    return means, scales, quats, opac, sh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' records, the scene and its camera kwargs."""
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
    from gaussreg_tpu_torch.tools.render_sharded_check import write_scene

    out = tmp_path_factory.mktemp("sharded")
    scene = _scene()
    kw = dict(eye=[0, 0, -4.0], target=[0, 0, 0], up=[0, 1, 0], fov_deg=60, width=WIDTH,
              height=HEIGHT)
    write_scene(str(out / "scene.npz"), *scene, look_at_camera(**kw))
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "gaussreg_tpu_torch.tools.render_sharded_check",
         "--scene", str(out / "scene.npz"), "--world", "2", "--output_dir", str(out),
         "--cpu", "--tile", str(TILE), "--threads", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return recs, scene, kw


def _loss_torch(out):
    w = torch.linspace(0.5, 1.5, out.rgb.numel()).reshape(out.rgb.shape)
    return torch.sum(out.rgb * w) + 0.3 * torch.sum(out.transmittance)


def test_ranks_hold_their_rows_and_one_gradient(ranks):
    recs, _, _ = ranks
    np.testing.assert_array_equal(recs[0]["rows"], [0, 32])
    np.testing.assert_array_equal(recs[1]["rows"], [32, HEIGHT])
    for key in ("rgb", "depth", "transmittance", *[f"grad:{n}" for n in NAMES + ("w2c",)]):
        np.testing.assert_array_equal(recs[0][key], recs[1][key], err_msg=key)
    for key in ("num_pairs", "overflow", "overflow_cap", "sat_blocks", "num_live"):
        assert int(recs[0][key]) == int(recs[1][key]), key
    assert recs[0]["rgb"].shape == (HEIGHT, WIDTH, 3)


def test_render_sharded_matches_render(ranks):
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
    from gaussreg_tpu_torch.gs.rasterizer.render import render

    recs, scene, kw = ranks
    cam = look_at_camera(**kw)
    params = [torch.from_numpy(a).requires_grad_(True) for a in scene]
    w2c = cam.w2c.clone().requires_grad_(True)
    out = render(*params, cam._replace(w2c=w2c), tile_h=TILE, tile_w=TILE)
    _loss_torch(out).backward()
    rec = recs[0]
    np.testing.assert_allclose(rec["rgb"], out.rgb.detach().numpy(), atol=5e-4)
    np.testing.assert_allclose(rec["depth"], out.depth.detach().numpy(), atol=2e-3)
    np.testing.assert_allclose(rec["transmittance"], out.transmittance.detach().numpy(),
                               atol=5e-4)
    # the slices keep the whole image's tiles, pixel frame and pair blocks:
    # their pixels are render()'s bit for bit
    for key in ("rgb", "depth", "transmittance"):
        np.testing.assert_array_equal(rec[key], getattr(out, key).detach().numpy(), err_msg=key)
    assert int(rec["num_pairs"]) == int(out.num_pairs)
    assert int(rec["overflow"]) == 0 and int(rec["overflow_cap"]) == 0
    for name, p in zip(NAMES + ("w2c",), params + [w2c]):
        g = p.grad.numpy()
        scale = np.abs(g).max() + 1e-6
        np.testing.assert_allclose(rec[f"grad:{name}"] / scale, g / scale, atol=2e-3,
                                   err_msg=name)


def test_render_sharded_matches_jax_render_sharded(ranks):
    from jax.sharding import Mesh
    from gaussreg_tpu.gs.rasterizer.camera import look_at_camera as jlook_at
    from gaussreg_tpu.gs.rasterizer.render import render_sharded as jrender_sharded

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) JAX devices")
    recs, scene, kw = ranks
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    cam = jlook_at(**kw)
    args = tuple(jnp.asarray(a) for a in scene)

    def loss(*a):
        out = jrender_sharded(*a, cam, mesh, tile_h=TILE, tile_w=TILE)
        w = jnp.linspace(0.5, 1.5, out.rgb.size).reshape(out.rgb.shape)
        return jnp.sum(out.rgb * w) + 0.3 * jnp.sum(out.transmittance), out

    # jitted: JAX dispatches render_sharded's interpreted kernels op by op
    # otherwise (~45 s a call on the CPU against ~3 s)
    value_and_grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))
    (_, out), grads = value_and_grad(*args)
    rec = recs[0]
    np.testing.assert_allclose(rec["rgb"], np.asarray(out.rgb), atol=5e-4)
    np.testing.assert_allclose(rec["depth"], np.asarray(out.depth), atol=2e-3)
    np.testing.assert_allclose(rec["transmittance"], np.asarray(out.transmittance), atol=5e-4)
    # the counters: sums and maxima over the slices, as the JAX function's
    for key in ("num_pairs", "overflow", "overflow_cap", "sat_blocks", "num_live"):
        assert int(rec[key]) == int(getattr(out, key)), key
    for name, g in zip(NAMES, grads):
        g = np.asarray(g)
        scale = np.abs(g).max() + 1e-6
        np.testing.assert_allclose(rec[f"grad:{name}"] / scale, g / scale, atol=2e-3,
                                   err_msg=name)
