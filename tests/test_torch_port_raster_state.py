"""The rasterizer's chunk-start state (the forward saves, per pixel, T and
the composited colour and depth before each walked chunk) and the
chunk-parallel backward that walks each chunk from it, on the CPU through
the plain versions, against the sequential walk they replace.

Scenes: the saturating slab of test_torch_port_raster.py (tiles exit
early); a "silhouette" tile half covered by a dense slab and half empty,
which walks all of its nine chunks because its empty half never saturates;
and a "staggered" tile whose top rows saturate several chunks before its
bottom rows. The last two are built as pair lists by hand and are shared
with the card tests (tests/test_torch_port_cuda.py), so this module
imports no JAX at the top.
"""

import numpy as np
import pytest
import torch

# the test run spreads files over several worker processes that share the
# host's cores; torch's default of one thread per core oversubscribes them
torch.set_num_threads(2)

from gaussreg_tpu_torch.gs.rasterizer import kernels
from gaussreg_tpu_torch.gs.rasterizer.binning import bin_gaussians
from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
from gaussreg_tpu_torch.gs.rasterizer.project import project_gaussians


def _rows(centres, sigma, opacity, rng, device):
    """gdata rows of isotropic gaussians at pixel `centres` (n, 2), depth in
    index order, random colours."""
    n = centres.shape[0]
    means = torch.from_numpy(centres.astype(np.float32))
    inv = np.float32(1.0 / sigma**2)
    conics = torch.tensor([[inv, 0.0, inv]], dtype=torch.float32).expand(n, 3)
    coeffs = kernels.quadratic_coeffs(means, conics, torch.full((n,), opacity))
    rows = torch.zeros((n, kernels.NCHAN))
    rows[:, :6] = coeffs
    rows[:, 8:11] = torch.from_numpy(rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32))
    rows[:, 11] = torch.linspace(1.0, 3.0, n)
    return rows.to(device)


def _pair_list(groups, first, cap_blocks, device):
    """sorted_gid and starts of tiles that own consecutive ranges starting
    at element `first`: groups[t] = number of tile t's pairs, gaussians in
    order; every other slot holds the sentinel."""
    g = sum(groups)
    gid = torch.full((cap_blocks * kernels.CHUNK,), g, dtype=torch.int32)
    gid[first:first + g] = torch.arange(g, dtype=torch.int32)
    starts = torch.tensor(np.concatenate([[0], np.cumsum(groups)]) + first, dtype=torch.int32)
    return gid.to(device), starts.to(device)


def _with_sentinel(rows):
    sentinel = torch.zeros((1, kernels.NCHAN), device=rows.device)
    sentinel[0, 0] = -1e30
    return torch.cat([rows, sentinel]).contiguous()


def silhouette_pairs(device="cpu"):
    """A 32x64 image of two 32x32 tiles. Tile 0's 1100 pairs start at element
    37 (unaligned: nine chunks, the first and last shared with foreign rows)
    and cover only its left half densely, so its right half keeps T = 1 and
    it walks every chunk; tile 1 holds 60 sparse gaussians. Returns (gdata,
    sorted_gid, starts, height, width, tile)."""
    rng = np.random.default_rng(11)
    left = np.stack([rng.uniform(2.0, 8.0, 1100), rng.uniform(0.0, 32.0, 1100)], 1)
    right = np.stack([rng.uniform(34.0, 62.0, 60), rng.uniform(2.0, 30.0, 60)], 1)
    rows = torch.cat([_rows(left, 2.0, 0.5, rng, device), _rows(right, 2.5, 0.4, rng, device)])
    gid, starts = _pair_list([1100, 60], 37, 10, device)
    return _with_sentinel(rows), gid, starts, 32, 64, 32


def staggered_pairs(device="cpu"):
    """One 32x32 tile: 500 opaque gaussians over its top rows (chunks 0-3),
    then 500 over its bottom rows (chunks 3-7), then 300 anywhere. The top
    rows saturate chunks before the bottom rows; the tile exits before its
    last chunks."""
    rng = np.random.default_rng(12)
    top = np.stack([rng.uniform(-2.0, 34.0, 500), rng.uniform(-2.0, 17.0, 500)], 1)
    bottom = np.stack([rng.uniform(-2.0, 34.0, 500), rng.uniform(15.0, 34.0, 500)], 1)
    rest = rng.uniform(0.0, 32.0, size=(300, 2))
    rows = torch.cat([_rows(top, 3.0, 0.9, rng, device), _rows(bottom, 3.0, 0.9, rng, device),
                      _rows(rest, 3.0, 0.9, rng, device)])
    gid, starts = _pair_list([1300], 0, 11, device)
    return _with_sentinel(rows), gid, starts, 32, 32, 32


def saturating_pairs(device="cpu"):
    """The saturating slab of test_torch_port_raster.py (4000 gaussians,
    128x64), through the port's projection and binning."""
    rng = np.random.default_rng(7)
    n = 4000
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(-1.0, 0.5, size=n)
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = np.minimum(4.0 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n))), 0.99).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    t = lambda a: torch.from_numpy(a).to(device)
    cam = look_at_camera([0, 0, -4.0], [0, 0, 0], [0, 1, 0], 60, 128, 64)
    proj = project_gaussians(t(means), t(scales), t(quats), t(opac), t(sh), cam)
    b = bin_gaussians(proj.means2d, proj.radii, proj.depths, 128, 64, max_tiles_per_gaussian=32,
                      extents=proj.extents, minor=proj.minor)
    z2 = torch.zeros((n, 2), device=device)
    gdata = torch.cat([kernels.quadratic_coeffs(proj.means2d, proj.conics, proj.opacities), z2,
                       proj.colors, proj.depths[:, None], z2, z2], dim=1)
    return _with_sentinel(gdata), b.sorted_gid, b.starts, 64, 128, 32


SCENES = {"saturating": saturating_pairs, "silhouette": silhouette_pairs,
          "staggered": staggered_pairs}


def cotangent_planes(planes, seed=0):
    """ct_planes (7, H, W) of a random cotangent, as the backward forms them."""
    rng = np.random.default_rng(seed)
    d = torch.from_numpy(rng.normal(size=(5,) + tuple(planes.shape[1:])).astype(np.float32))
    d = d.to(planes.device)
    return torch.cat([d, planes[4:5], (d[:4] * planes[:4]).sum(0)[None]]).contiguous()


def chunk_counts(starts, cap):
    return [c[3] for c in kernels._tile_chunks(starts, cap)]


def test_scenes_walk_as_described():
    """The silhouette tile walks all of its >= 8 chunks (kend = chunk
    count); the staggered tile's top rows fall under T_EPS chunks before
    its bottom rows and the tile exits early; the saturating scene exits
    early on some tile."""
    gdata, gid, starts, h, w, tile = silhouette_pairs()
    planes, kend = kernels.rasterize_forward_plain(gdata, gid, starts, h, w, tile, tile)
    nch = chunk_counts(starts, gid.shape[0])
    assert nch[0] >= 8 and kend.tolist()[0] == nch[0]
    assert float(planes[4, :, :8].max()) < kernels.T_EPS and float(planes[4, :, 24:32].min()) == 1.0

    gdata, gid, starts, h, w, tile = staggered_pairs()
    nch = chunk_counts(starts, gid.shape[0])[0]
    offs = kernels.compacted_offsets(torch.tensor([nch], dtype=torch.int32), nch)
    ct = cotangent_planes(torch.ones((5, h, w)))
    first_below = {}  # chunk after which each half's max T fell under T_EPS
    for c in kernels.walk_backward_chunks(gdata, gid, starts, offs, ct, h, w, tile, tile):
        for half, rows in (("top", slice(0, 512)), ("bottom", slice(512, 1024))):
            if half not in first_below and float(c["t_row"][rows].max()) < kernels.T_EPS:
                first_below[half] = c["k"]
    _, kend = kernels.rasterize_forward_plain(gdata, gid, starts, h, w, tile, tile)
    assert first_below["top"] + 2 <= first_below["bottom"] == int(kend[0]) < nch

    gdata, gid, starts, h, w, tile = saturating_pairs()
    _, kend = kernels.rasterize_forward_plain(gdata, gid, starts, h, w, tile, tile)
    assert (kend < torch.tensor(chunk_counts(starts, gid.shape[0]), dtype=torch.int32)).any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_saved_state_matches_sequential_walk(scene):
    """The forward's saved T equals, bit for bit, the T the sequential
    backward walk recomputes at each chunk start (the same products in the
    same order); the saved prefix colour and depth agree with the walk's
    within 1e-6 of their max (equal in practice). Saving the state leaves
    planes and kend as they were."""
    gdata, gid, starts, h, w, tile = SCENES[scene]()
    planes, kend, state = kernels.rasterize_forward_plain(gdata, gid, starts, h, w, tile, tile,
                                                          save_state=True)
    planes0, kend0 = kernels.rasterize_forward_plain(gdata, gid, starts, h, w, tile, tile)
    assert torch.equal(planes, planes0) and torch.equal(kend, kend0)
    assert state.shape == (gid.shape[0] // kernels.CHUNK + kend.shape[0], 5, tile * tile)
    full = kernels.state_slots(gid.shape[0] // kernels.CHUNK, kend.shape[0])
    offs = kernels.compacted_offsets(kend, full)
    chunks = kernels._tile_chunks(starts, gid.shape[0])
    scale = state[:, 1:].abs().max().item()
    checked = []
    for c in kernels.walk_backward_chunks(gdata, gid, starts, offs, cotangent_planes(planes),
                                          h, w, tile, tile):
        if c["k"] == 0:
            continue
        checked.append(chunks[c["tile"]][2] + c["tile"] + c["k"] - 1)
        saved = state[checked[-1]]
        assert torch.equal(saved[0], c["t_row"])
        assert (saved[1:] - c["prefix"]).abs().max().item() <= 1e-6 * scale
    assert checked == kernels.written_state_slots(starts, kend, gid.shape[0]).tolist()
    assert len(checked) == int(kend.sum()) - int((kend > 0).sum()) > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_chunk_parallel_backward_matches_sequential(scene):
    """The chunk-parallel plain backward (each chunk from the saved state)
    against the sequential one, with the full buffer and with a cap that
    clips. Both start each chunk from the same T; <d, prefix> comes from
    the saved colour instead of the running sum of e * w, so they differ by
    rounding, which (v - u) / (1 - alpha) amplifies on saturated pixels
    (|v - u| << |v|, 1 - alpha down to 0.01): on the saturating scene the
    two f32 forms differ by 2.8e-5 of a channel's max and each lies 2-7e-5
    from the same walk in float64. So: each form within 1e-4 of each
    channel's max from the float64 walk, the two within 1e-4 of each other,
    and the chunk-parallel form no further from float64 than the sequential
    one plus 1e-5."""
    gdata, gid, starts, h, w, tile = SCENES[scene]()
    planes, kend, state = kernels.rasterize_forward_plain(gdata, gid, starts, h, w, tile, tile,
                                                          save_state=True)
    planes64, kend64 = kernels.rasterize_forward_plain(gdata.double(), gid, starts, h, w, tile,
                                                       tile)
    assert torch.equal(kend64, kend)
    ct = cotangent_planes(planes, seed=1)
    ct64 = torch.cat([ct[:5].double(), planes64[4:5],
                      (ct[:4].double() * planes64[:4]).sum(0)[None]])
    full = kernels.state_slots(gid.shape[0] // kernels.CHUNK, kend.shape[0])
    for bwd_blocks in (full, max(1, int(kend.sum()) // 2)):
        offs = kernels.compacted_offsets(kend, bwd_blocks)
        args = (gid, starts, offs)
        geometry = (bwd_blocks, h, w, tile, tile)
        seq = kernels.rasterize_backward_plain(gdata, *args, ct, *geometry)
        par = kernels.rasterize_backward(gdata, *args, ct, *geometry, state=state)
        truth = kernels.rasterize_backward_plain(gdata.double(), *args, ct64, *geometry)
        scale = truth.abs().amax(dim=0).clamp_min(1e-30)
        err = lambda x: ((x.double() - truth).abs() / scale).amax(dim=0)
        assert truth.abs().max() > 0
        assert err(seq).max() <= 1e-4 and err(par).max() <= 1e-4
        assert ((par - seq).abs() / scale).max().item() <= 1e-4
        assert (err(par) <= err(seq) + 1e-5).all()


def test_silhouette_forward_matches_pallas():
    """The silhouette tile through the interpreted Pallas forward of the JAX
    package: kend equal (nine chunks walked), rgb and T within 5e-4, depth
    within 5e-3 (the limits of test_forward_plain_matches_pallas)."""
    import jax.numpy as jnp
    from gaussreg_tpu.gs.rasterizer import kernels as jkernels

    gdata, gid, starts, h, w, tile = silhouette_pairs()
    rgb_j, depth_j, t_j, kend_j = jkernels.rasterize_gaussians(
        jnp.asarray(gdata.numpy()), jnp.asarray(gid.numpy()), jnp.asarray(starts.numpy()), h, w)
    planes, kend = kernels.rasterize_forward(gdata, gid, starts, h, w, tile, tile)
    np.testing.assert_array_equal(kend.numpy(), np.asarray(kend_j))
    np.testing.assert_allclose(planes[:3].permute(1, 2, 0).numpy(), np.asarray(rgb_j), atol=5e-4)
    np.testing.assert_allclose(planes[4].numpy(), np.asarray(t_j), atol=5e-4)
    np.testing.assert_allclose(planes[3].numpy(), np.asarray(depth_j), atol=5e-3)


def test_differentiated_render_alone_saves_state(monkeypatch):
    """rasterize_gaussians saves the state only where a backward can run:
    grad mode on and gdata requiring grad."""
    from gaussreg_tpu_torch.gs.rasterizer import render as render_mod
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera as cam_at

    seen = []
    orig = kernels.rasterize_forward
    monkeypatch.setattr(kernels, "rasterize_forward",
                        lambda *a, **kw: seen.append(kw.get("save_state")) or orig(*a, **kw))
    rng = np.random.default_rng(2)
    n = 50
    means = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    scales = torch.full((n, 3), 0.1)
    quats = torch.tensor([[1.0, 0, 0, 0]]).expand(n, 4)
    sh = torch.zeros((n, 3, 16))
    cam = cam_at([0, 0, -4.0], [0, 0, 0], [0, 1, 0], 60, 64, 32)
    render_mod.render(means, scales, quats, torch.full((n,), 0.5), sh, cam)
    x = means.clone().requires_grad_(True)
    with torch.no_grad():
        render_mod.render(x, scales, quats, torch.full((n,), 0.5), sh, cam)
    out = render_mod.render(x, scales, quats, torch.full((n,), 0.5), sh, cam)
    out.rgb.sum().backward()
    assert seen == [False, False, True] and x.grad.abs().max() > 0
