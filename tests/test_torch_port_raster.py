"""The port's rasterizer (projection, binning, tile compositing forward and
backward, accumulation, render) against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both sides. The JAX
side runs its Pallas kernels in interpret mode (`render(use_pallas=True)`
off the TPU, `segment_accumulate(interpret=True)`); the port runs on
`device="cpu"` tensors, where the wrappers of its CUDA kernels take their
plain PyTorch versions. Each test states its tolerance and the reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# the test run spreads files over several worker processes that share the
# host's cores; torch's default of one thread per core oversubscribes them
torch.set_num_threads(2)

from gaussreg_tpu.gs.rasterizer import binning as jbinning
from gaussreg_tpu.gs.rasterizer import kernels as jkernels
from gaussreg_tpu.gs.rasterizer.accumulate import segment_accumulate as jsegment_accumulate
from gaussreg_tpu.gs.rasterizer.camera import look_at_camera as jlook_at
from gaussreg_tpu.gs.rasterizer.project import project_gaussians as jproject
from gaussreg_tpu.gs.rasterizer.render import render as jrender
from gaussreg_tpu_torch.gs.rasterizer import binning as tbinning
from gaussreg_tpu_torch.gs.rasterizer import kernels as tkernels
from gaussreg_tpu_torch.gs.rasterizer.accumulate import (
    accumulate_pairs,
    segment_accumulate_plain,
)
from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera as tlook_at
from gaussreg_tpu_torch.gs.rasterizer.project import compute_cov3d, project_gaussians
from gaussreg_tpu_torch.gs.rasterizer.render import render

NAMES = ["means", "scales", "quats", "opacities", "sh"]


def _scene(n=200, seed=0):
    """The scene of tests/test_rasterizer.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(loc=-2.5, scale=0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    sh[:, :, 1:] = rng.normal(scale=0.05, size=(n, 3, 15))
    return means, scales, quats, opac, sh


def _saturating_scene():
    """4000 gaussians with a dense opaque front slab over a 128x64 image
    (tests/test_rasterizer.py: test_saturation_culled_render_matches):
    tiles run several 128-pair chunks deep and exit early."""
    means, scales, quats, opac, sh = _scene(4000, seed=7)
    rng = np.random.default_rng(7)
    z = np.where(
        rng.uniform(size=4000) < 0.75,
        rng.uniform(-1.0, 0.5, size=4000),
        rng.uniform(2.0, 8.0, size=4000),
    )
    means[:, 2] = z.astype(np.float32)
    return means, scales, quats, np.minimum(opac * 4.0, 0.99).astype(np.float32), sh


def _cameras(width=256, height=64):
    kw = dict(eye=[0, 0, -4.0], target=[0, 0, 0], up=[0, 1, 0], fov_deg=60,
              width=width, height=height)
    return jlook_at(**kw), tlook_at(**kw)


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad) for a in arrays]


def test_project_gaussians_all_fields():
    """All nine fields of ProjectedGaussians. Floats within 1e-4 relative
    (+1e-4 absolute): the port forms the camera-space covariance as a matrix
    product where the JAX package unrolls it, so f32 sums come in another
    order. radii and extents are ceil()s of such floats: equal, or one apart
    where the argument lies within rounding of an integer (none on this
    seed). valid must be equal."""
    args = _scene(300, seed=3)
    jcam, tcam = _cameras()
    pj = jproject(*_j(args), jcam)
    pt = project_gaussians(*_t(args), tcam)
    assert pt._fields == pj._fields and len(pt._fields) == 9
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
    for name in ("means2d", "depths", "conics", "colors", "opacities", "minor"):
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        if name == "minor":  # the axis' sign is free where n1 == n2; compare up to sign
            sign = np.sign(np.sum(a[:, :2] * b[:, :2], axis=1, keepdims=True))
            b = np.concatenate([b[:, :2] * sign, b[:, 2:]], axis=1)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("radii", "extents"):
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert np.abs(a - b).max() <= 1.0 and (a != b).mean() <= 0.01, name


def test_compute_cov3d():
    """R S S^T R^T within 1e-5 (same formula, f32)."""
    from gaussreg_tpu.gs.rasterizer.project import compute_cov3d as jcov

    _, scales, quats, _, _ = _scene(20, seed=1)
    np.testing.assert_allclose(
        compute_cov3d(torch.from_numpy(scales), torch.from_numpy(quats)).numpy(),
        np.asarray(jcov(jnp.asarray(scales), jnp.asarray(quats))), rtol=1e-5, atol=1e-6,
    )


def _check_same_binning(bj, bt, depths, g, num_tiles, depth_bits):
    """Counters and starts equal; per tile the same multiset of ids, depth
    non-decreasing (at the key's quantization: its low bits are cut), and the
    same order wherever the sort keys differ (pairs with one key may come in
    any order: the JAX sort is unstable)."""
    for name in ("num_pairs", "overflow", "overflow_cap", "num_live", "live_overflow"):
        assert int(getattr(bt, name)) == int(getattr(bj, name)), name
    sj, st = np.asarray(bj.starts), bt.starts.numpy()
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(bt.tile_counts.numpy(), np.asarray(bj.tile_counts))
    gj, gt = np.asarray(bj.sorted_gid), bt.sorted_gid.numpy()
    assert gj.shape == gt.shape and gt.dtype == np.int32
    n = min(int(bj.num_pairs), gj.shape[0])
    assert (gt[n:] == g).all() and (gj[n:] == g).all()
    dbits = np.maximum(depths, 1e-9).astype(np.float32).view(np.uint32) >> (32 - depth_bits)
    for t in range(num_tiles):
        a, b = gj[sj[t]:min(sj[t + 1], n)], gt[st[t]:min(st[t + 1], n)]
        assert (np.diff(dbits[b].astype(np.int64)) >= 0).all()
        np.testing.assert_array_equal(dbits[a], dbits[b])  # same key sequence
        # within each run of one key the ids agree as sets
        order_a = np.lexsort((a, dbits[a]))
        order_b = np.lexsort((b, dbits[b]))
        np.testing.assert_array_equal(a[order_a], b[order_b])


@pytest.mark.parametrize("mode", ["plain", "sat_depth", "live_cap", "pair_cap"])
def test_bin_gaussians_matches(mode):
    """Both sides bin the same projected arrays (the JAX projection's), so
    every decision is made on equal numbers: tolerance 0."""
    args = _saturating_scene()
    jcam, _ = _cameras(128, 64)
    proj = jproject(*_j(args), jcam)
    g, width, height, mt = 4000, 128, 64, 16
    kw = {}
    if mode != "plain":
        probe = jrender(*_j(args), jcam, use_pallas=True)
        sat = np.asarray(probe.sat_depth)
        assert np.isfinite(sat).any()
        kw["sat_depth"] = sat
        if mode == "live_cap":
            kw["live_cap"] = 1536
        if mode == "pair_cap":
            kw["live_cap"], kw["pair_capacity_blocks"] = 1024, 8  # both overflow
    fields = ("means2d", "radii", "depths", "extents", "minor")
    pj = {k: np.asarray(getattr(proj, k)) for k in fields}

    def call(mod, conv):
        k2 = {k: (conv(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        return mod.bin_gaussians(
            conv(pj["means2d"]), conv(pj["radii"]), conv(pj["depths"]), width, height,
            max_tiles_per_gaussian=mt, extents=conv(pj["extents"]), minor=conv(pj["minor"]), **k2,
        )

    bj = call(jbinning, jnp.asarray)
    bt = call(tbinning, lambda a: torch.from_numpy(np.array(a)))
    num_tiles = (width // 32) * (height // 32)
    depth_bits = 32 - max(num_tiles + 1, 2).bit_length()
    if mode == "pair_cap":
        assert int(bt.overflow_cap) > 0 and int(bt.live_overflow) > 0
    _check_same_binning(bj, bt, pj["depths"], g, num_tiles, depth_bits)


def _assert_close_but_flips(got, want, atol, what):
    """Within `atol`, except on at most 1% of the pixels, which may differ by
    up to 1/255 + atol. The two projections agree to 1e-4 relative, not to
    the bit (test_project_gaussians_all_fields), so on a few pixels of a
    4000-gaussian scene one pair's `raw` falls on the other side of the
    1/255 cut and its contribution, at most 1/255 of a colour, appears on one
    side only. Kernels fed one projection are held to `atol` everywhere
    (test_forward_plain_matches_pallas)."""
    diff = np.abs(got - want).reshape(got.shape[0], got.shape[1], -1).max(-1)
    assert diff.max() <= 1.0 / 255.0 + atol, what
    assert (diff > atol).mean() <= 0.01, what


def _rasterizer_inputs(args, jcam, width, height, mt):
    """gdata, sorted_gid, starts from the JAX projection and binning."""
    proj = jproject(*_j(args), jcam)
    b = jbinning.bin_gaussians(
        proj.means2d, proj.radii, proj.depths, width, height, max_tiles_per_gaussian=mt,
        extents=proj.extents, minor=proj.minor,
    )
    g = proj.means2d.shape[0]
    coeffs = jkernels.quadratic_coeffs(proj.means2d, proj.conics, proj.opacities)
    z2 = jnp.zeros((g, 2))
    gdata = jnp.concatenate([coeffs, z2, proj.colors, proj.depths[:, None], z2, z2], axis=1)
    sentinel = jnp.zeros((1, 16)).at[0, 0].set(-1e30)
    return jnp.concatenate([gdata, sentinel]), b.sorted_gid, b.starts


@pytest.mark.parametrize("scene", ["sparse", "saturating"])
def test_forward_plain_matches_pallas(scene):
    """K4's plain version against the interpreted Pallas forward on the same
    pair list. rgb and T within 5e-4, depth within 5e-3 (the JAX package's
    own limits against its dense renderer): the Pallas kernel takes the
    exponent as an f32 matrix product and T through exp(sum(log1p(-alpha))),
    the port as a rounded polynomial and a running product. kend equal."""
    if scene == "sparse":
        args, (width, height) = _scene(120), (256, 64)
    else:
        args, (width, height) = _saturating_scene(), (128, 64)
    jcam, _ = _cameras(width, height)
    gdata, gid, starts = _rasterizer_inputs(args, jcam, width, height, 32)
    rgb_j, depth_j, t_j, kend_j = jkernels.rasterize_gaussians(gdata, gid, starts, height, width)
    planes, kend_t = tkernels.rasterize_forward(*_t([gdata, gid, starts]), height, width, 32, 32)
    rgb_t, depth_t, t_t = planes[:3].permute(1, 2, 0), planes[3], planes[4]
    np.testing.assert_array_equal(kend_t.numpy(), np.asarray(kend_j))
    if scene == "saturating":
        nch = -(-np.diff(np.asarray(starts)) // 128)
        assert (np.asarray(kend_j) < nch).any(), "no tile exited early"
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=5e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=5e-4)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), atol=5e-3)


def test_render_matches_pallas_and_dense_reference():
    """render() end to end: the tile path against the JAX Pallas path and
    against the port's dense reference renderer, rgb/T 5e-4, depth 5e-3 (as
    above); all ten RenderOutput fields, counters equal."""
    args = _scene(120)
    jcam, tcam = _cameras(256, 64)
    oj = jrender(*_j(args), jcam, use_pallas=True, max_tiles_per_gaussian=32)
    ot = render(*_t(args), tcam, max_tiles_per_gaussian=32)
    od = render(*_t(args), tcam, dense_reference=True)
    assert ot._fields == oj._fields and len(ot._fields) == 10
    for other in (oj, od):
        np.testing.assert_allclose(ot.rgb.numpy(), np.asarray(other.rgb), atol=5e-4)
        np.testing.assert_allclose(
            ot.transmittance.numpy(), np.asarray(other.transmittance), atol=5e-4
        )
        np.testing.assert_allclose(ot.depth.numpy(), np.asarray(other.depth), atol=5e-3)
    for name in ("num_pairs", "overflow", "overflow_cap", "sat_blocks", "num_live"):
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    np.testing.assert_array_equal(ot.radii.numpy(), np.asarray(oj.radii))
    np.testing.assert_allclose(ot.sat_depth.numpy(), np.asarray(oj.sat_depth), rtol=1e-5)
    assert int(od.sat_blocks) == 0 and torch.isinf(od.sat_depth).all()


def _torch_grads(args, tcam, loss_fn, **kw):
    targs = _t(args, grad=True)
    loss_fn(render(*targs, tcam, **kw)).backward()
    return [a.grad.numpy() for a in targs]


def test_render_gradients_match_pallas():
    """K5 + K6 through render: gradients for means, scales, quats, opacities
    and SH against jax.grad of the Pallas path, within 2e-3 of each
    gradient's max (the limit of tests/test_rasterizer.py: the depth term
    amplifies roundoff)."""
    args = _scene(40)
    jcam, tcam = _cameras(128, 32)

    def jloss(*a):
        out = jrender(*a, jcam, use_pallas=True, max_tiles_per_gaussian=32)
        w = jnp.linspace(0.5, 1.5, out.rgb.size).reshape(out.rgb.shape)
        return jnp.sum(out.rgb * w) + 0.3 * jnp.sum(out.transmittance) + 0.05 * jnp.sum(out.depth)

    def tloss(out):
        w = torch.linspace(0.5, 1.5, out.rgb.numel()).reshape(out.rgb.shape)
        return (out.rgb * w).sum() + 0.3 * out.transmittance.sum() + 0.05 * out.depth.sum()

    g_j = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_j(args))
    g_t = _torch_grads(args, tcam, tloss, max_tiles_per_gaussian=32)
    for name, a, b in zip(NAMES, g_j, g_t):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-3, err_msg=name)


def test_bwd_capacity_tight_and_undersized():
    """A backward cap equal to the reported sat_blocks gives the default
    gradients to 1e-5 (the same rows added in the same order; exact here);
    an undersized cap stays finite and drops only gradient (tiles past the
    cap), as in tests/test_rasterizer.py. The JAX side's tight-cap gradient
    is held to the port's within 2e-3 of its max."""
    args = _scene(80, seed=5)
    jcam, tcam = _cameras(128, 64)
    loss = lambda out: out.rgb.sum() + 0.5 * out.transmittance.sum()
    sat = int(render(*_t(args), tcam).sat_blocks)
    assert sat == int(jrender(*_j(args), jcam, use_pallas=True).sat_blocks) and sat > 0
    g_full = _torch_grads(args, tcam, loss)[0]
    g_tight = _torch_grads(args, tcam, loss, bwd_capacity_blocks=sat)[0]
    np.testing.assert_allclose(g_tight, g_full, atol=1e-5)
    g_small = _torch_grads(args, tcam, loss, bwd_capacity_blocks=max(1, sat // 4))[0]
    assert np.isfinite(g_small).all()
    assert (g_small == 0).sum() > (g_full == 0).sum()  # some tiles lost their gradient

    def jloss(*a):
        out = jrender(*a, jcam, use_pallas=True, bwd_capacity_blocks=max(1, sat // 4))
        return jnp.sum(out.rgb) + 0.5 * jnp.sum(out.transmittance)

    g_j = np.asarray(jax.grad(jloss)(*_j(args)))
    scale = np.abs(g_j).max() + 1e-6
    np.testing.assert_allclose(g_small / scale, g_j / scale, atol=2e-3)


def test_saturation_culled_render():
    """The two-probe protocol on the saturating scene. The port's counters
    under sat_depth / live_gaussian_cap / pair_capacity_blocks equal the JAX
    package's (same cull, tolerance 0), its culled render equals its
    unculled one within 2e-3 (culled pairs each add < T_EPS) and gradients
    within 3e-3 of their max, the limits of tests/test_rasterizer.py. Against
    the JAX package's culled render: 5e-4 but for alpha-cut flips
    (`_assert_close_but_flips`)."""
    args = _saturating_scene()
    jcam, tcam = _cameras(128, 64)
    probe_j = jrender(*_j(args), jcam, use_pallas=True)
    probe = render(*_t(args), tcam)
    np.testing.assert_allclose(probe.sat_depth.numpy(), np.asarray(probe_j.sat_depth), rtol=1e-5)
    assert int(probe.sat_blocks) == int(probe_j.sat_blocks) > 0
    p2 = render(*_t(args), tcam, sat_depth=probe.sat_depth)
    n_live = int(p2.num_live)
    assert 0 < n_live < int(probe.num_live)
    kw = dict(live_gaussian_cap=n_live + 8, pair_capacity_blocks=(int(p2.num_pairs) + 127) // 128 + 2)
    out_j = jrender(*_j(args), jcam, use_pallas=True, sat_depth=probe_j.sat_depth, **kw)
    out = render(*_t(args), tcam, sat_depth=probe.sat_depth, **kw)
    for name in ("num_pairs", "overflow", "overflow_cap", "sat_blocks", "num_live"):
        assert int(getattr(out, name)) == int(getattr(out_j, name)), name
    assert int(out.overflow_cap) == 0 and int(out.num_pairs) < int(probe.num_pairs)
    np.testing.assert_allclose(out.rgb.numpy(), probe.rgb.numpy(), atol=2e-3)
    np.testing.assert_allclose(out.transmittance.numpy(), probe.transmittance.numpy(), atol=2e-3)
    _assert_close_but_flips(out.rgb.numpy(), np.asarray(out_j.rgb), 5e-4, "culled rgb")

    def loss(o):
        w = torch.linspace(0.5, 1.5, o.rgb.numel()).reshape(o.rgb.shape)
        return (o.rgb * w).sum() + 0.3 * o.transmittance.sum()

    g_full = _torch_grads(args, tcam, loss)
    g_cull = _torch_grads(args, tcam, loss, sat_depth=probe.sat_depth, **kw)
    for i in (0, 3):
        scale = np.abs(g_full[i]).max() + 1e-6
        np.testing.assert_allclose(g_cull[i] / scale, g_full[i] / scale, atol=3e-3, err_msg=NAMES[i])


@pytest.mark.parametrize("case", ["random", "one_gaussian", "dropped"])
def test_segment_accumulate_plain(case):
    """The function of K6 on (rows, ids), the oracle of the port's
    accumulation (`segment_accumulate_plain`), against the interpreted
    Pallas kernel and np.add.at. Against np.add.at (a sequential
    scatter-add): within 2e-5 of the rows' scale times the longest run
    (index_add_ on the CPU adds in row order; equal in practice). Against the
    Pallas kernel, whose one-hot product adds each 128-row block at once:
    the same bound."""
    rng = np.random.default_rng(4)
    r, num_out = 128 * 12, 301
    rows = rng.normal(size=(r, 16)).astype(np.float32)
    gid = rng.integers(0, num_out, size=r).astype(np.int32)
    if case == "one_gaussian":
        gid[:] = 5
    elif case == "dropped":
        gid[::4] = num_out  # ids past the table: dropped by both kernels
    want = np.zeros((num_out + 1, 16), np.float32)
    np.add.at(want, np.minimum(gid, num_out), rows)
    want = want[:num_out]
    out = segment_accumulate_plain(torch.from_numpy(rows), torch.from_numpy(gid), num_out)
    seq = torch.zeros((num_out, 16))
    for i in range(r):  # a Python loop: index_add_ adds in row order
        if gid[i] < num_out:
            seq[gid[i]] += torch.from_numpy(rows[i])
    assert torch.equal(out, seq)
    pallas = np.asarray(jsegment_accumulate(jnp.asarray(rows), jnp.asarray(gid), num_out, interpret=True))
    longest = np.bincount(gid).max()
    tol = 2e-5 * np.abs(rows).max() * longest
    np.testing.assert_allclose(out.numpy(), want, atol=tol)
    np.testing.assert_allclose(out.numpy(), pallas, atol=tol)


def test_rasterizer_wrappers_reject_bad_input():
    gdata = torch.zeros((3, 16))
    gdata[2, 0] = -1e30
    # two culled gaussians on two tiles: 128 sentinel pairs, no tile pair
    b = tbinning.bin_gaussians(torch.zeros((2, 2)), torch.zeros(2), torch.ones(2), 64, 32)
    assert b.sorted_gid.tolist() == [2] * 128 and b.starts.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):  # the image is not a multiple of the tile
        tkernels.rasterize_gaussians(gdata, b, 30, 64)
    with pytest.raises(ValueError):  # the pair list is not a multiple of 128
        tkernels.rasterize_gaussians(gdata, b._replace(sorted_gid=b.sorted_gid[:100]), 32, 64)
    with pytest.raises(ValueError):  # 8-float rows
        accumulate_pairs(torch.zeros((4, 8)), torch.zeros((1, 4), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), b.starts, b.starts, 128, 3)
    with pytest.raises(ValueError):
        tbinning.bin_gaussians(torch.zeros((2, 2)), torch.ones(2), torch.ones(2), 64, 32, live_cap=1)
    # an empty image: T = 1, colour 0, no chunk composited, zero gradient
    x = gdata.clone().requires_grad_(True)
    rgb, depth, t, kend = tkernels.rasterize_gaussians(x, b, 32, 64)
    assert kend.tolist() == [0, 0] and float(t.min()) == 1.0 and float(rgb.abs().max()) == 0.0
    (rgb.sum() + t.sum()).backward()
    assert torch.equal(x.grad, torch.zeros_like(gdata))
