"""The port's per-gaussian gradient accumulation (K6) on the CPU: the
binning's pair table against a brute force over the sorted pair list, the
table-driven plain version against `index_add_` on the compacted ids (bit
for bit), and against the JAX package's interpreted Pallas kernel.

Inputs are made with numpy from a seed; the port runs on CPU tensors,
where `accumulate_pairs` takes its plain version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussreg_tpu.gs.rasterizer.accumulate import segment_accumulate as jsegment_accumulate
from gaussreg_tpu_torch.gs.rasterizer import kernels
from gaussreg_tpu_torch.gs.rasterizer.accumulate import (
    accumulate_pairs,
    segment_accumulate_plain,
)
from gaussreg_tpu_torch.gs.rasterizer.binning import bin_gaussians, slot_positions
from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
from gaussreg_tpu_torch.gs.rasterizer.project import project_gaussians
from gaussreg_tpu_torch.gs.rasterizer.render import render

WIDTH, HEIGHT, MT = 128, 64, 16


def _saturating_scene(n=4000, seed=7):
    """A dense opaque front slab and a sparse back (the scene of
    tests/test_torch_port_raster.py): tiles run several chunks deep, exit
    early, and share boundary blocks."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    means[:, 2] = np.where(rng.uniform(size=n) < 0.75, rng.uniform(-1.0, 0.5, size=n),
                           rng.uniform(2.0, 8.0, size=n))
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))).astype(np.float32)
    opac = np.minimum(opac * 4.0, 0.99).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    cam = look_at_camera([0, 0, -4.0], [0, 0, 0], [0, 1, 0], 60, WIDTH, HEIGHT)
    args = [torch.from_numpy(a) for a in (means, scales, quats, opac, sh)]
    return args, cam


def _binning(mode):
    args, cam = _saturating_scene()
    proj = project_gaussians(*args, cam)
    kw = {}
    if mode != "plain":
        probe = render(*args, cam, max_tiles_per_gaussian=MT)
        kw["sat_depth"] = probe.sat_depth
        if mode == "live_cap":
            kw["live_cap"] = 1536
        if mode == "pair_cap":
            kw["live_cap"], kw["pair_capacity_blocks"] = 1024, 8  # both overflow
    b = bin_gaussians(proj.means2d, proj.radii, proj.depths, WIDTH, HEIGHT,
                      max_tiles_per_gaussian=MT, extents=proj.extents, minor=proj.minor, **kw)
    # the pair table, as the backward builds it from the binning's sort
    return proj, b, slot_positions(b.order, b.row_gid.shape[0], MT)


@pytest.mark.parametrize("mode", ["plain", "sat_depth", "live_cap", "pair_cap"])
def test_pair_table_matches_brute_force(mode):
    """Every pair p < min(num_pairs, cap) of gaussian g appears exactly once
    in g's table row, and a row's valid slots hold its pairs in ascending
    order; gaussians without a row have no pair. Modes: no cull, the
    saturation cull without compaction, live-set compaction, and a pair
    capacity that clips (with live overflow). Exact."""
    _, b, table = _binning(mode)
    g = 4000
    gid = b.sorted_gid.numpy()
    limit = min(int(b.num_pairs), gid.shape[0])
    slot_pos, row_gid = table.numpy(), b.row_gid.numpy()
    assert slot_pos.shape == (row_gid.shape[0], MT) and slot_pos.dtype == np.int32
    assert len(set(row_gid.tolist())) == row_gid.shape[0] and (row_gid < g).all()
    if mode in ("plain", "sat_depth"):
        np.testing.assert_array_equal(row_gid, np.arange(g))
    else:
        assert row_gid.shape[0] < g
    if mode == "pair_cap":
        assert int(b.overflow_cap) > 0 and int(b.live_overflow) > 0
    # every slot position is distinct (the inverse of a permutation)
    assert len(np.unique(slot_pos)) == slot_pos.size
    want = {}
    for p in range(limit):
        want.setdefault(int(gid[p]), []).append(p)
    got = {}
    for r, gr in enumerate(row_gid.tolist()):
        pos = slot_pos[r][slot_pos[r] < limit]
        assert (np.diff(pos) > 0).all(), "a row's pairs out of order"
        if pos.size:
            got[gr] = pos.tolist()
    assert got == want


def _grad_rows(proj, b, bwd_blocks):
    """K5's buffer (plain version) for a random cotangent, and offs."""
    g = proj.means2d.shape[0]
    coeffs = kernels.quadratic_coeffs(proj.means2d, proj.conics, proj.opacities)
    z2 = torch.zeros((g, 2))
    gdata = torch.cat([coeffs, z2, proj.colors, proj.depths[:, None], z2, z2], dim=1)
    sentinel = torch.zeros((1, 16))
    sentinel[0, 0] = -1e30
    gdata = torch.cat([gdata, sentinel]).detach()
    planes, kend = kernels.rasterize_forward_plain(gdata, b.sorted_gid, b.starts, HEIGHT, WIDTH,
                                                   32, 32)
    if bwd_blocks is None:
        bwd_blocks = int(kend.sum())
    else:
        bwd_blocks = max(1, int(kend.sum()) // 3)  # a cap that clips
    offs = kernels.compacted_offsets(kend, bwd_blocks)
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.normal(size=(5, HEIGHT, WIDTH)).astype(np.float32))
    ct = torch.cat([d, planes[4:5], (d[:4] * planes[:4]).sum(0)[None]])
    rows = kernels.rasterize_backward_plain(gdata, b.sorted_gid, b.starts, offs, ct, bwd_blocks,
                                            HEIGHT, WIDTH, 32, 32)
    return gdata, rows, offs, bwd_blocks


@pytest.mark.parametrize("mode,bwd", [("plain", "full"), ("live_cap", "full"), ("plain", "clipped")])
def test_accumulate_pairs_equals_index_add(mode, bwd):
    """The table-driven accumulation equals index_add_ (sequential, in row
    order, on the CPU) on the compacted ids bit for bit, with the sentinel
    row zeroed, for the full buffer and for a `bwd_capacity_blocks` that
    clips. The same rows and ids through the interpreted Pallas kernel agree
    within 2e-5 of the rows' scale times the longest run (its one-hot
    product adds a 128-row block at once)."""
    proj, b, table = _binning(mode)
    gdata, rows, offs, bwd_blocks = _grad_rows(proj, b, None if bwd == "full" else 1)
    g1 = gdata.shape[0]
    cap = b.sorted_gid.shape[0]
    out = accumulate_pairs(rows, table, b.row_gid, b.starts, offs, cap, g1)
    ids = kernels.compacted_gids(b.sorted_gid, b.starts, offs, bwd_blocks, drop_id=g1)
    oracle = segment_accumulate_plain(rows, ids, g1)
    oracle[g1 - 1] = 0.0
    assert out.abs().max() > 0
    assert torch.equal(out, oracle)
    if bwd == "clipped":
        _, rows_f, offs_f, _ = _grad_rows(proj, b, None)
        full = accumulate_pairs(rows_f, table, b.row_gid, b.starts, offs_f, cap, g1)
        # the tiles past the cap lost their gradient
        assert (out == 0).all(dim=1).sum() > (full == 0).all(dim=1).sum()
    pallas = np.array(jsegment_accumulate(jnp.asarray(rows.numpy()), jnp.asarray(ids.numpy()),
                                            g1, interpret=True))
    pallas[g1 - 1] = 0.0
    longest = np.bincount(ids.numpy()).max()
    tol = 2e-5 * rows.abs().max().item() * longest
    np.testing.assert_allclose(out.numpy(), pallas, atol=tol)
