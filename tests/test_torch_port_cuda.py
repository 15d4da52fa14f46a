"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips (from the `cuda` fixture, at run time)
where there is no CUDA card. On a machine with one:

    python -m pytest -q -m cuda tests/test_torch_port_cuda.py

K1 and K3 must equal their plain versions index for index and value for
value, K6 bit for bit; K2 must lie within 4e-3 of the plain output's max
magnitude (one bf16 rounding step of a weighted sum, 2^-8 relative).
The rasterizer's hand-built tiles come from test_torch_port_raster_state.py
(which imports no JAX at the top).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("limit", [1, 4, 35, 300])
def test_window_select_kernel_matches_plain(cuda, limit):
    from gaussreg_tpu_torch.ops import fused_select as fs

    rng = np.random.default_rng(limit)
    p, nruns, wspan = 1000, 9, 256
    w = nruns * wspan
    g = lambda *s: torch.from_numpy(rng.integers(0, 8, size=s) / 8.0).float().to(cuda)
    q, wx, wy, wz = g(p, 3), g(p, w), g(p, w), g(p, w)
    widx = torch.from_numpy(rng.integers(0, 10**6, size=(p, w))).int().to(cuda)
    ls = rng.integers(0, wspan + 1, size=(p, nruns))
    le = np.minimum(ls + rng.integers(0, 60, size=(p, nruns)), wspan)
    le[:10] = ls[:10]
    lsle = torch.from_numpy(np.concatenate([ls, le], 1)).int().to(cuda)
    before = fs.KERNEL.launches
    d2_k, idx_k = fs.window_select_idx(q, lsle, wx, wy, wz, widx, limit, nruns, wspan)
    d2_p, idx_p = fs.window_select_plain(q, lsle, wx, wy, wz, widx, limit, nruns, wspan)
    assert fs.KERNEL.launches == before + 1
    assert torch.equal(idx_k, idx_p)
    assert torch.equal(d2_k, d2_p)


@pytest.mark.parametrize("c,d", [(4, 64), (32, 32), (64, 64), (128, 128), (256, 256), (512, 512), (24, 40), (64, 1024)])
def test_kpconv_kernel_matches_plain(cuda, c, d):
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    gen = torch.Generator(device=cuda).manual_seed(c)
    b, m, h, k = 2, 333, 35, 15
    nf = torch.randn(b, m, h, c, device=cuda, generator=gen).to(torch.bfloat16)
    infl = torch.rand(b, m, h, k, device=cuda, generator=gen).to(torch.bfloat16)
    w = torch.randn(k, c, d, device=cuda, generator=gen)
    out = kk.kpconv_fused_apply(nf, infl, w)
    ref = kk.reference_apply(nf, infl, w)
    assert (out - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()


@pytest.mark.parametrize(
    "rows,h,k",
    [(50, 35, 15), (1000, 17, 15), (64 * 5 + 7, 1, 15), (130, 35, 1), (3, 17, 1), (777, 28, 16),
     (300, 44, 16)],
)
def test_kpconv_kernel_shapes(cuda, rows, h, k):
    """Neighbour counts that are not a multiple of 16 (1, 17, 35) and the
    largest at 64 rows per block (44, with sixteen kernel points), one or
    sixteen kernel points, fewer than 64 rows and row counts that are not a
    multiple of 64, at a narrow (C = 4) and a wide (C = D = 256) layer."""
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    for c, d in ((4, 64), (256, 256)):
        gen = torch.Generator(device=cuda).manual_seed(rows + h + k + c)
        nf = torch.randn(1, rows, h, c, device=cuda, generator=gen).to(torch.bfloat16)
        infl = torch.rand(1, rows, h, k, device=cuda, generator=gen).to(torch.bfloat16)
        w = torch.randn(k, c, d, device=cuda, generator=gen)
        before = kk.KERNEL.launches
        out = kk.kpconv_fused_apply(nf, infl, w)
        torch.cuda.synchronize()
        assert kk.KERNEL.launches == before + 1
        ref = kk.reference_apply(nf, infl, w)
        assert (out - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()


@pytest.mark.parametrize("rows,h,k", [(500, 45, 15), (333, 89, 15), (97, 96, 16), (40, 60, 1)])
def test_kpconv_kernel_wide_neighbourhoods(cuda, rows, h, k):
    """Past 48 neighbour slots (the reference checkpoint's limits reach 89 at
    level 0) the kernel takes blocks of 32 rows, still in one launch that
    sums all slots in f32 and rounds once: held to the same 4e-3 as the
    other shapes. Past 96 slots the wrapper raises."""
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    gen = torch.Generator(device=cuda).manual_seed(rows + h + k)
    for c, d in ((4, 64), (256, 256)):
        nf = torch.randn(1, rows, h, c, device=cuda, generator=gen).to(torch.bfloat16)
        infl = torch.rand(1, rows, h, k, device=cuda, generator=gen).to(torch.bfloat16)
        w = torch.randn(k, c, d, device=cuda, generator=gen)
        before = kk.KERNEL.launches
        out = kk.kpconv_fused_apply(nf, infl, w)
        torch.cuda.synchronize()
        assert kk.KERNEL.launches == before + 1
        ref = kk.reference_apply(nf, infl, w)
        assert (out - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()
    nf = torch.zeros(1, 8, kk.MAX_NEIGHBORS + 1, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H <="):
        kk.kpconv_fused_apply(nf, nf[..., :1].expand(-1, -1, -1, k), torch.zeros(k, 4, 8,
                                                                                  device=cuda))


@pytest.mark.parametrize("w,k", [(128, 3), (16, 3), (1000, 35)])
def test_select_min_k_kernel_matches_plain(cuda, w, k):
    from gaussreg_tpu_torch.ops import select_k as sk

    gen = torch.Generator(device=cuda).manual_seed(w)
    x = -torch.exp(torch.randint(-20, 5, (777, w), device=cuda, generator=gen) / 4.0)
    x[:5, :] = 0.0  # rows of ties, -0.0 and +0.0 included
    x[0, ::2] = -0.0
    vk, pk = sk.select_min_k(x, k)
    vp, pp = sk.select_min_k_plain(x, k)
    assert torch.equal(pk, pp)
    assert torch.equal(vk, vp)


def test_wrappers_reject_bad_input(cuda):
    from gaussreg_tpu_torch.ops import select_k as sk

    with pytest.raises(ValueError):
        sk.select_min_k(torch.zeros(4, 8, device=cuda, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        sk.select_min_k(torch.zeros(4, 8, device=cuda), 9)


# ---- the rasterizer kernels (K4, K5, K6) ----
#
# K4: rgb and T within 5e-4, depth within 5e-3 (the limits of the JAX
# package's own kernel-against-reference test), kend equal: both versions
# round the exponent alike, so they differ only by the order of the colour
# sums and by exp's last bit. K5: rows within 2e-3 of each channel's max
# (sums over 1024 pixels in another order). K6: equal bit for bit (the same
# additions in the same order).


def _pairs_scene(cuda, n, seed, width, height, tile=32, opacity_boost=1.0, z_front=False):
    """A projected scene's rasterizer inputs on the card: gdata and the
    binning (sorted_gid, starts, the sort's order and row_gid), through the
    port's own projection and binning."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels
    from gaussreg_tpu_torch.gs.rasterizer.binning import bin_gaussians
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
    from gaussreg_tpu_torch.gs.rasterizer.project import project_gaussians

    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    if z_front:
        means[:, 2] = rng.uniform(-1.0, 0.5, size=n)
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))).astype(np.float32)
    opac = np.minimum(opac * opacity_boost, 0.99).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    t = lambda a: torch.from_numpy(a).to(cuda)
    cam = look_at_camera([0, 0, -4.0], [0, 0, 0], [0, 1, 0], 60, width, height)
    proj = project_gaussians(t(means), t(scales), t(quats), t(opac), t(sh), cam)
    b = bin_gaussians(proj.means2d, proj.radii, proj.depths, width, height,
                      tile_w=tile, tile_h=tile, max_tiles_per_gaussian=32,
                      extents=proj.extents, minor=proj.minor)
    coeffs = kernels.quadratic_coeffs(proj.means2d, proj.conics, proj.opacities)
    z2 = torch.zeros((n, 2), device=cuda)
    gdata = torch.cat([coeffs, z2, proj.colors, proj.depths[:, None], z2, z2], dim=1)
    sentinel = torch.zeros((1, 16), device=cuda)
    sentinel[0, 0] = -1e30
    return torch.cat([gdata, sentinel]).contiguous(), b


def _check_forward(gdata, gid, starts, height, width, tile):
    """K4 against its plain version, the chunk-start state included on the
    chunks both walked (same limits as the planes)."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    before = kernels.FWD_KERNEL.launches
    planes_k, kend_k, state_k = kernels.rasterize_forward(gdata, gid, starts, height, width, tile,
                                                          tile, save_state=True)
    torch.cuda.synchronize()
    assert kernels.FWD_KERNEL.launches == before + 1
    planes_p, kend_p, state_p = kernels.rasterize_forward_plain(gdata, gid, starts, height, width,
                                                                tile, tile, save_state=True)
    assert torch.equal(kend_k, kend_p)
    assert (planes_k[[0, 1, 2, 4]] - planes_p[[0, 1, 2, 4]]).abs().max().item() <= 5e-4
    assert (planes_k[3] - planes_p[3]).abs().max().item() <= 5e-3
    walked = kernels.written_state_slots(starts, kend_k, gid.shape[0])
    if walked.numel():
        diff = (state_k[walked] - state_p[walked]).abs()
        assert diff[:, :4].max() <= 5e-4 and diff[:, 4].max() <= 5e-3
    # without the state the kernel computes the same
    planes_n, kend_n = kernels.rasterize_forward(gdata, gid, starts, height, width, tile, tile)
    assert torch.equal(planes_n, planes_k) and torch.equal(kend_n, kend_k)
    return planes_k, kend_k, state_k


def _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile, bwd_blocks):
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    gen = torch.Generator(device=gdata.device).manual_seed(0)
    d = torch.randn(5, height, width, device=gdata.device, generator=gen)
    v = (d[:4] * planes[:4]).sum(0)
    ct = torch.cat([d, planes[4:5], v[None]]).contiguous()
    offs = kernels.compacted_offsets(kend, bwd_blocks)
    args = (gdata, gid, starts, offs, ct, bwd_blocks, height, width, tile, tile)
    before = kernels.BWD_KERNEL.launches
    rows_k = kernels.rasterize_backward(*args, state=state)
    torch.cuda.synchronize()
    assert kernels.BWD_KERNEL.launches == before + 1
    # against the chunk-parallel plain walk from the kernel's own state, and
    # against the sequential walk, which recomputes each chunk's start
    for rows_p in (kernels.rasterize_backward_plain(*args, state=state),
                   kernels.rasterize_backward_plain(*args)):
        scale = rows_p.abs().amax(dim=0).clamp_min(1e-20)
        assert ((rows_k - rows_p).abs() / scale).max().item() <= 2e-3
    assert torch.equal(rows_k[:, [6, 7, 12, 13, 14, 15]], torch.zeros_like(rows_k[:, :6]))
    assert torch.equal(rows_k, kernels.rasterize_backward(*args, state=state))  # repeats exactly
    return rows_k, offs


@pytest.mark.parametrize(
    "n,width,height,tile,boost,front",
    [
        (300, 128, 64, 32, 1.0, False),  # sparse: tiles inside one 128-block, empty tiles
        (4000, 128, 64, 32, 4.0, True),  # a saturating slab: early exits, kend < chunks
        (600, 64, 64, 16, 1.0, False),  # 16x16 tiles: 256 threads per block
    ],
)
def test_rasterize_kernels_match_plain(cuda, n, width, height, tile, boost, front):
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    gdata, b = _pairs_scene(cuda, n, n, width, height, tile, boost, front)
    gid, starts = b.sorted_gid, b.starts
    planes, kend, state = _check_forward(gdata, gid, starts, height, width, tile)
    if front:
        assert (kend < torch.div(starts[1:] - starts[:-1] + 127, 128, rounding_mode="floor")).any()
    full = gid.shape[0] // kernels.CHUNK + kend.shape[0]
    _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile, full)
    # a cap that clips: the last tiles lose their chunks, nothing past it is written
    clipped = max(1, int(kend.sum()) // 2)
    rows, offs = _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile,
                                 clipped)
    assert int(offs[-1]) == clipped and rows.shape[0] == clipped * kernels.CHUNK


def test_rasterize_empty_and_one_block_tiles(cuda):
    """An image whose gaussians all sit in one tile: every other tile is
    empty (kend 0, T = 1, colour 0) and the busy tile's range starts and
    ends inside one 128-block."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    g = 5
    gdata = torch.zeros((g + 1, 16), device=cuda)
    gdata[:g, 0] = -0.1  # a0
    gdata[:g, 3] = gdata[:g, 5] = -1e-3  # axx, ayy: wide blobs around the origin
    gdata[:g, 8:12] = torch.rand((g, 4), device=cuda)
    gdata[g, 0] = -1e30
    gid = torch.full((128,), g, dtype=torch.int32, device=cuda)
    gid[3:8] = torch.arange(g, dtype=torch.int32, device=cuda)
    starts = torch.tensor([3, 3, 8, 8, 8], dtype=torch.int32, device=cuda)  # tile 1 owns [3, 8)
    planes, kend, state = _check_forward(gdata, gid, starts, 32, 128, 32)
    assert kend.tolist() == [0, 1, 0, 0]
    assert torch.equal(planes[4, :, :32], torch.ones(32, 32, device=cuda))
    assert planes[:4, :, 64:].abs().max().item() == 0.0
    rows, _ = _check_backward(gdata, gid, starts, planes, kend, state, 32, 128, 32, 2)
    assert rows[3:8].abs().max().item() > 0 and rows[8:].abs().max().item() == 0


def test_rasterize_gradients_match_plain_path(cuda):
    """rasterize_gaussians end to end on the card (K4 + K5 + K6) against the
    same autograd.Function on the CPU (the plain versions)."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    gdata, b = _pairs_scene(cuda, 500, 3, 128, 64)
    outs = []
    for dev in ("cuda", "cpu"):
        x = gdata.detach().to(dev).clone().requires_grad_(True)
        rgb, depth, t, _ = kernels.rasterize_gaussians(
            x, type(b)(*(f.to(dev) for f in b)), 64, 128)
        w = torch.linspace(0.5, 1.5, rgb.numel(), device=dev).reshape(rgb.shape)
        ((rgb * w).sum() + 0.3 * t.sum() + 0.05 * depth.sum()).backward()
        outs.append(x.grad.cpu())
    scale = outs[1].abs().amax(dim=0).clamp_min(1e-20)
    assert ((outs[0] - outs[1]).abs() / scale).max().item() <= 2e-3


@pytest.mark.parametrize(
    "n,width,height,tile,boost,front",
    [
        (300, 128, 64, 32, 1.0, False),
        (4000, 128, 64, 32, 4.0, True),
        (600, 64, 64, 16, 1.0, False),
    ],
)
def test_segment_accumulate_kernel_matches_plain(cuda, n, width, height, tile, boost, front):
    """K6 on the three scenes of test_rasterize_kernels_match_plain, with the
    full backward buffer and one that clips: equal bit for bit to its plain
    version (the same additions in the same order), to index_add_ on the
    compacted ids on the CPU (sequential, in row order), and to itself on a
    second launch."""
    from gaussreg_tpu_torch.gs.rasterizer import accumulate as acc
    from gaussreg_tpu_torch.gs.rasterizer import kernels
    from gaussreg_tpu_torch.gs.rasterizer.binning import slot_positions

    gdata, b = _pairs_scene(cuda, n, n, width, height, tile, boost, front)
    table = slot_positions(b.order, b.row_gid.shape[0], 32)
    planes, kend, state = kernels.rasterize_forward(gdata, b.sorted_gid, b.starts, height, width,
                                                    tile, tile, save_state=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    d = torch.randn(5, height, width, device=cuda, generator=gen)
    ct = torch.cat([d, planes[4:5], (d[:4] * planes[:4]).sum(0)[None]]).contiguous()
    cap, g1 = b.sorted_gid.shape[0], gdata.shape[0]
    full = b.sorted_gid.shape[0] // kernels.CHUNK + kend.shape[0]
    for bwd_blocks in (full, max(1, int(kend.sum()) // 2)):
        offs = kernels.compacted_offsets(kend, bwd_blocks)
        rows = kernels.rasterize_backward(gdata, b.sorted_gid, b.starts, offs, ct, bwd_blocks,
                                          height, width, tile, tile, state=state)
        args = (rows, table, b.row_gid, b.starts, offs, cap, g1)
        before = acc.KERNEL.launches
        out_k = acc.accumulate_pairs(*args)
        torch.cuda.synchronize()
        assert acc.KERNEL.launches == before + 1
        assert torch.equal(out_k, acc.accumulate_pairs_plain(*args))
        ids = kernels.compacted_gids(b.sorted_gid, b.starts, offs, bwd_blocks, drop_id=g1)
        oracle = acc.segment_accumulate_plain(rows.cpu(), ids.cpu(), g1)
        oracle[g1 - 1] = 0.0
        assert torch.equal(out_k.cpu(), oracle)
        assert torch.equal(out_k, acc.accumulate_pairs(*args))  # repeats exactly


@pytest.mark.parametrize("scene", ["silhouette", "staggered"])
def test_rasterize_kernels_hand_built_tiles(cuda, scene):
    """The hand-built tiles of test_torch_port_raster_state.py on the card.
    Silhouette: a tile half covered and half empty walks all of its nine
    chunks (kend = chunk count), so the backward's blocks start from eight
    saved states. Staggered: the cluster blocks holding the top rows fall
    under T_EPS chunks before those holding the bottom rows; the exit
    agreement must stop the tile after the plain version's kend, which is
    below the chunk count. K4, its state and K5 against their plain
    versions (limits above); two K5 runs equal bit for bit."""
    from test_torch_port_raster_state import chunk_counts, silhouette_pairs, staggered_pairs

    gdata, gid, starts, height, width, tile = (
        silhouette_pairs if scene == "silhouette" else staggered_pairs)(cuda)
    planes, kend, state = _check_forward(gdata, gid, starts, height, width, tile)
    nch = chunk_counts(starts, gid.shape[0])
    if scene == "silhouette":
        assert nch[0] >= 8 and int(kend[0]) == nch[0]
    else:
        assert 0 < int(kend[0]) < nch[0]
    full = gid.shape[0] // 128 + kend.shape[0]
    _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile, full)


def test_forward_refuses_a_cluster_it_cannot_place(cuda):
    """A cluster of 16 blocks per tile (over the portable 8) is refused by
    the card: the launch raises, is not counted and is not retried without
    a cluster."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels
    from test_torch_port_raster_state import silhouette_pairs

    gdata, gid, starts, height, width, tile = silhouette_pairs(cuda)
    nty, ntx = height // tile, width // tile
    planes = torch.empty((5, height, width), device=cuda)
    kend = torch.empty((nty * ntx,), dtype=torch.int32, device=cuda)
    before = kernels.FWD_KERNEL.launches
    with pytest.raises(RuntimeError):
        kernels.FWD_KERNEL.launch(gdata.data_ptr(), gid.data_ptr(), starts.data_ptr(),
                                  planes.data_ptr(), kend.data_ptr(), 0, gid.shape[0], ntx, nty,
                                  tile, tile, 16)
    torch.cuda.synchronize()
    assert kernels.FWD_KERNEL.launches == before
    with pytest.raises(ValueError):  # the kernel walks from the state: it must be given
        kernels.rasterize_backward(gdata, gid, starts, torch.zeros(3, dtype=torch.int32,
                                   device=cuda), torch.zeros(7, height, width, device=cuda), 4,
                                   height, width, tile, tile)


# ---- the probes' kernels (P1, P2) ----
#
# P1: every gather equals table[idx] bit for bit. P2: kend equal; rgb and T
# within 1e-5 for A, C and D (kernel and plain version compute the same
# alpha, rounding each product and sum of the exponent alike, and sum the
# prefix and the colours in another order) and within 5e-4 for B (one bf16
# step of one lg, should the two log1p differ in the last bit).


@pytest.mark.parametrize("g,k", [(4096, 128), (1000, 77), (16, 1), (7264, 300)])
def test_probe_gathers_are_exact(cuda, g, k):
    from gaussreg_tpu_torch.tools import probe_vmem_gather as p1

    table, idx = p1.make_inputs(g + k, g=g, k=k, device=cuda)
    idx[0] = g - 1
    ref = table[idx.long()]
    for variant, kernel in p1.KERNELS.items():
        before = kernel.launches
        out = p1.gather(variant, table, idx)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(out, ref), variant
        assert torch.equal(p1.PLAIN[variant](table, idx), ref), variant


def test_probe_gather_rejects_a_table_past_shared_memory(cuda):
    from gaussreg_tpu_torch.tools import probe_vmem_gather as p1

    table, idx = p1.make_inputs(0, g=8192, k=8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        p1.gather("shared", table, idx)
    assert torch.equal(p1.gather("global", table, idx), table[idx.long()])


@pytest.mark.parametrize("case", ["blocks", "ragged"])
def test_probe_composite_cores_match_plain(cuda, case):
    from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2
    from test_torch_port_probes import ragged_saturating_blocks

    if case == "blocks":
        blocks, starts, _ = p2.make_blocks(num_tiles=40, blocks_per_tile=3, seed=2)
        tiles = 40
    else:
        blocks, starts, tiles = ragged_saturating_blocks()
    blocks, starts = torch.from_numpy(blocks).to(cuda), torch.from_numpy(starts).to(cuda)
    limits = {"A": 1e-5, "B": 5e-4, "C": 1e-5, "D": 1e-5}
    for core, kernel in p2.KERNELS.items():
        before = kernel.launches
        out = p2.run_fwd(blocks, starts, core, tiles)
        ref = p2.composite_plain(blocks, starts, core, tiles)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(out[:, 5], ref[:, 5]), core
        err = (out[:, :5] - ref[:, :5]).abs().max().item()
        assert err <= limits[core], (core, err)
