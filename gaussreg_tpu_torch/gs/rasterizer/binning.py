"""Tile binning: (gaussian, tile) pairs sorted by (tile, depth), one sort,
no scatter (port of gaussreg_tpu/gs/rasterizer/binning.py).

- Every gaussian contributes up to `mt` (gaussian, tile) entries: its
  screen bbox tiles in row-major order, circle-culled per tile (tiles whose
  rect lies farther than the opacity-aware radius from the center can never
  reach alpha >= 1/255). Overflow is counted, never silently dropped.
- sort key = tile_id << depth_bits | monotone-quantized depth (positive
  float32 bit patterns are order-preserving, so the top bits of the depth's
  bit pattern ARE the quantized depth). The JAX package builds the key in
  uint32; torch has no full uint32 arithmetic, so the same 32-bit value is
  held in an int64 and invalid entries take 0xFFFFFFFF, above every real
  key. One stable sort yields every tile's pairs contiguous and
  depth-ordered (pairs with one key come in gaussian order; the JAX sort is
  unstable, so there the order of such pairs is arbitrary).
- Tile segment element offsets come from `searchsorted`. The rasterizer
  reads this UNALIGNED layout directly: a tile's first and last 128-wide
  block may be shared with the neighbouring tile, and the kernels mask
  foreign rows.
- Nothing here is differentiated: callers pass detached tensors.
- The sort's index `order` and each row's gaussian `row_gid` are kept. The
  backward of a differentiated render inverts `order` into a per-gaussian
  table (`slot_positions`): `slot_pos[r, s]` is the sorted position of row
  r's slot s. Slots run row-major over the bbox, so a row's tiles, and with
  them its sorted positions, rise with the slot index: the accumulation
  (K6, accumulate.py) reads each gaussian's pairs in order from the table,
  with no second sort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

INVALID_KEY = 0xFFFFFFFF
MAX_POOL_LEVELS = 16  # bboxes up to 16x16 tiles are saturation-tested exactly


class TileBinning(NamedTuple):
    """Sorted (tile, depth)-ordered pair list.

    `sorted_gid[p]` is the gaussian id of the p-th pair in (tile, depth)
    order, `G` (sentinel) for invalid/padding slots. Tile t's pairs are
    `sorted_gid[starts[t] : starts[t + 1]]`."""

    sorted_gid: torch.Tensor  # (cap,) int32
    starts: torch.Tensor  # (num_tiles + 1,) int32 element offsets
    tile_counts: torch.Tensor  # (num_tiles,) int32
    num_pairs: torch.Tensor  # () int32, true pair count
    overflow: torch.Tensor  # () int32, pairs dropped by the per-gaussian cap
    overflow_cap: torch.Tensor  # () int32, pairs dropped by pair capacity
    num_live: torch.Tensor  # () int32, gaussians alive after saturation cull
    live_overflow: torch.Tensor  # () int32, live gaussians beyond live_cap
    # (their pairs are dropped; size live_cap from a probe's num_live)
    order: torch.Tensor  # (n_rows * mt,) int64 the sort's index: the flat
    # slot r * mt + s of each sorted position
    row_gid: torch.Tensor  # (n_rows,) int32 gaussian id per row


def _tile_bbox(mx, my, hx, hy, alive, tile_w, tile_h, ntx, nty, ty0=0):
    # the bbox in the binned rows' tiles, whose first tile row is ty0
    # the divisors are device tensors: CUDA divides by a host scalar as a
    # multiplication by its reciprocal, which moves a centre across a tile
    # edge when the tile size is not a power of two
    tile_w = torch.full((), float(tile_w), device=mx.device)
    tile_h = torch.full((), float(tile_h), device=mx.device)
    x0 = torch.clamp(torch.floor((mx - hx) / tile_w).to(torch.int32), 0, ntx - 1)
    x1 = torch.clamp(torch.floor((mx + hx) / tile_w).to(torch.int32), 0, ntx - 1)
    y0 = torch.clamp(torch.floor((my - hy) / tile_h).to(torch.int32) - ty0, 0, nty - 1)
    y1 = torch.clamp(torch.floor((my + hy) / tile_h).to(torch.int32) - ty0, 0, nty - 1)
    zero = torch.zeros_like(x0)
    bw = torch.where(alive, x1 - x0 + 1, zero)
    bh = torch.where(alive, y1 - y0 + 1, zero)
    return x0, y0, bw, bh


def _saturation_lookup(sat_depth, sat_margin, ntx, nty, x0, y0, bw, bh):
    """Per gaussian, the max saturation depth over its bbox tiles, from a
    stack of ANCHORED max-pools: level w holds
    P_w[y, x] = max sat_img[y .. y+w-1, x .. x+w-1], so a bbox anchored at
    (y0, x0) with max dimension d is covered exactly by level d at (y0, x0).
    Returns (look (G,), small (G,) bool: bbox within the pooled sizes)."""
    sat_img = (sat_depth.reshape(nty, ntx) * sat_margin)[None, None]
    pools = [sat_img]
    for w in range(2, MAX_POOL_LEVELS + 1):
        padded = F.pad(sat_img, (0, w - 1, 0, w - 1), value=float("-inf"))
        pools.append(F.max_pool2d(padded, kernel_size=w, stride=1))
    stack = torch.stack([p.reshape(-1) for p in pools], dim=1)  # (tiles, 16)
    size = torch.maximum(bw, bh)
    lvl = torch.clamp(size, 1, MAX_POOL_LEVELS) - 1
    rows = stack[(y0 * ntx + x0).long()]  # (G, 16) one row per gaussian
    look = torch.gather(rows, 1, lvl.long()[:, None])[:, 0]
    return look, size <= MAX_POOL_LEVELS


def slot_positions(order: torch.Tensor, n_rows: int, mt: int,
                   first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_rows, mt) int32 sorted position of every flat slot r * mt + s:
    the inverse of the sort's permutation `order`, a scatter with unique
    indices (deterministic), each position after the list's `first` (1,)
    leading empty entries (starts[:1]: 0 but after `align_blocks`). Invalid
    slots sort past num_pairs."""
    pos = torch.arange(n_rows * mt, dtype=torch.int32, device=order.device)
    if first is not None:
        pos = pos + first
    return torch.empty_like(pos).scatter_(0, order, pos).reshape(n_rows, mt)


def bin_gaussians(
    means2d: torch.Tensor,  # (G, 2) pixel coords
    radii: torch.Tensor,  # (G,) screen radius, 0 = culled
    depths: torch.Tensor,  # (G,)
    width: int,
    height: int,
    tile_w: int = 32,
    tile_h: int = 32,
    max_tiles_per_gaussian: int = 16,
    chunk: int = 128,
    pair_capacity_blocks: Optional[int] = None,
    extents: Optional[torch.Tensor] = None,  # (G, 2) ellipse AABB half-widths
    minor: Optional[torch.Tensor] = None,  # (G, 3) minor-axis slab (ux, uy, hw)
    sat_depth: Optional[torch.Tensor] = None,  # (num_tiles,) per-tile
    # saturation depth from a previous render of (approximately) this scene
    # (+inf = tile never saturated). Gaussians strictly behind every
    # reachable tile's saturation depth contribute < T_EPS and are culled.
    live_cap: Optional[int] = None,  # cap on post-cull gaussians; when set
    # the live set is COMPACTED before pair expansion, shrinking the sort
    # from G*mt to live_cap*mt keys. Requires sat_depth.
    sat_margin: float = 1.05,  # multiplicative slack on sat_depth
    row0: int = 0,  # bin only rows [row0, row0 + height) of an image of
    full_height: Optional[int] = None,  # full_height rows (default row0 +
    # height), in whose pixel frame means2d lies: render_sharded's slices.
    # The tile grid then covers rows [0, row0 + height), the tiles above
    # row0 empty, so that tile ids, culls, sort keys and the kernels' pixel
    # coordinates are the whole image's; row0 is a multiple of tile_h.
) -> TileBinning:
    g = means2d.shape[0]
    dev = means2d.device
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h  # the binned rows' tile rows
    mt = max_tiles_per_gaussian
    if row0 % tile_h:
        raise ValueError(f"bin_gaussians: row0 {row0} is not a multiple of tile_h {tile_h}")
    ty0 = row0 // tile_h
    num_tiles = ntx * (ty0 + nty)
    full_tiles = ntx * ((max(full_height or 0, row0 + height) + tile_h - 1) // tile_h)

    # the whole image's key layout, so that a slice orders its pairs as the
    # whole image does
    tile_bits = max(full_tiles + 1, 2).bit_length()
    depth_bits = 32 - tile_bits
    if tile_bits > 12:
        raise ValueError("image too large for 32-bit sort keys")

    mx = means2d[:, 0]
    my = means2d[:, 1]
    r = radii
    # anisotropic per-axis extents: the AABB of the exact alpha >= 1/255
    # ellipse, NOT min'd with `r` (the display radius carries a 3-sigma cap)
    hx = extents[:, 0] if extents is not None else r
    hy = extents[:, 1] if extents is not None else r
    # a gaussian whose AABB misses the image rect entirely is dead
    alive = (
        (r > 0)
        & (mx + hx >= 0) & (mx - hx < width)
        & (my + hy >= row0) & (my - hy < row0 + height)
    )
    x0, y0, bw, bh = _tile_bbox(mx, my, hx, hy, alive, tile_w, tile_h, ntx, nty, ty0)
    count = bw * bh
    # the mt-cap overflow counter always reflects the full gaussian set
    overflow = torch.sum(torch.clamp_min(count - mt, 0)).to(torch.int32)

    # ---- saturation cull (gaussian granularity) ----
    if sat_depth is not None:
        look, small = _saturation_lookup(
            sat_depth.to(torch.float32), sat_margin, ntx, nty, x0, y0, bw, bh
        )
        live = alive & ((~small) | (depths <= look))
    else:
        live = alive
    num_live = torch.sum(live).to(torch.int32)

    if live_cap is not None:
        if sat_depth is None:
            raise ValueError("live_cap requires sat_depth")
        live_overflow = torch.clamp_min(num_live - live_cap, 0).to(torch.int32)
        # stable: live gaussians first, original order preserved
        perm = torch.sort((~live).to(torch.uint8), stable=True).indices[:live_cap]
        n_rows = perm.shape[0]
        mx, my, hx, hy, depths, alive = (
            mx[perm], my[perm], hx[perm], hy[perm], depths[perm], live[perm]
        )
        if minor is not None:
            minor = minor[perm]
        gids = perm.to(torch.int32)
        x0, y0, bw, bh = _tile_bbox(mx, my, hx, hy, alive, tile_w, tile_h, ntx, nty, ty0)
        count = bw * bh
    else:
        live_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if sat_depth is not None:
            # cull without compaction (probe mode: measures num_live and the
            # culled num_pairs so callers can size live_cap and pair caps)
            zero = torch.zeros_like(bw)
            bw = torch.where(live, bw, zero)
            bh = torch.where(live, bh, zero)
            count = bw * bh
        gids = torch.arange(g, dtype=torch.int32, device=dev)
        n_rows = g

    # (n_rows, mt) slot enumeration: row-major over the bbox
    slot = torch.arange(mt, dtype=torch.int32, device=dev)
    bw1 = torch.clamp_min(bw, 1)[:, None]
    dy = torch.div(slot[None, :], bw1, rounding_mode="floor")
    dx = slot[None, :] - dy * bw1
    in_bbox = slot[None, :] < torch.clamp_max(count, mt)[:, None]
    tx = x0[:, None] + dx
    ty = y0[:, None] + dy
    tid = (ty + ty0) * ntx + tx  # (n_rows, mt)

    # circle-rect cull: distance from the gaussian center to the tile rect
    # exceeding the (opacity-aware) radius means alpha < 1/255 everywhere in
    # the tile
    tlx = (tx * tile_w).to(torch.float32)
    tly = ((ty + ty0) * tile_h).to(torch.float32)
    mxc, myc = mx[:, None], my[:, None]
    cdx = torch.clamp_min(torch.maximum(tlx - mxc, mxc - (tlx + tile_w)), 0.0)
    cdy = torch.clamp_min(torch.maximum(tly - myc, myc - (tly + tile_h)), 0.0)
    r2_cull = (hx * hx + hy * hy) if extents is not None else r * r
    valid = in_bbox & (cdx * cdx + cdy * cdy < r2_cull[:, None])
    if minor is not None:
        # minor-axis slab test: the ellipse lies inside the slab
        # |u . (x - mu)| <= hw; a tile rect whose projection interval onto u
        # misses the slab can never reach alpha >= 1/255
        ux, uy, hw = minor[:, 0:1], minor[:, 1:2], minor[:, 2:3]
        rcx = tlx + 0.5 * tile_w
        rcy = tly + 0.5 * tile_h
        dproj = torch.abs(ux * (rcx - mxc) + uy * (rcy - myc))
        rect_hw = torch.abs(ux) * (0.5 * tile_w) + torch.abs(uy) * (0.5 * tile_h)
        valid = valid & (dproj <= hw + rect_hw)

    # monotone depth quantization: positive float32 bit patterns sort like
    # the floats; keep the top depth_bits bits
    dbits = (
        torch.clamp_min(depths.to(torch.float32), 1e-9).contiguous().view(torch.int32).long()
        >> (32 - depth_bits)
    )
    key = (tid.long() << depth_bits) | dbits[:, None]
    key = torch.where(valid, key, torch.full_like(key, INVALID_KEY)).reshape(-1)
    gid_payload = torch.where(
        valid, gids[:, None], torch.full_like(tid, g)
    ).reshape(-1)

    key_s, order = torch.sort(key, stable=True)
    gid_s = gid_payload[order]

    probes = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev) << depth_bits
    starts = torch.searchsorted(key_s, probes).to(torch.int32)
    num_pairs = starts[num_tiles]
    tile_counts = starts[1:] - starts[:-1]

    if pair_capacity_blocks is None:
        pair_capacity_blocks = (n_rows * mt + chunk - 1) // chunk
    cap = pair_capacity_blocks * chunk

    sorted_gid = gid_s[:cap]
    if cap > n_rows * mt:
        sorted_gid = F.pad(sorted_gid, (0, cap - n_rows * mt), value=g)

    overflow_cap = torch.clamp_min(num_pairs - cap, 0).to(torch.int32)
    return TileBinning(
        sorted_gid=sorted_gid.contiguous(),
        starts=starts,
        tile_counts=tile_counts,
        num_pairs=num_pairs,
        overflow=overflow,
        overflow_cap=overflow_cap,
        num_live=num_live,
        live_overflow=live_overflow,
        order=order,
        row_gid=gids,
    )


def align_blocks(binning: TileBinning, pairs_before: int, num_gaussians: int,
                 chunk: int = 128) -> TileBinning:
    """The same pairs behind `pairs_before % chunk` empty entries (the
    sentinel id), so that every tile's pairs fall on the chunk-sized blocks
    where they fall in a longer list holding `pairs_before` pairs first:
    render_sharded gives each slice the block boundaries of the whole
    image's list, so its tiles walk the same chunks as render()'s."""
    lead = pairs_before % chunk
    if lead == 0:
        return binning
    n = binning.sorted_gid.shape[0]
    sorted_gid = F.pad(binning.sorted_gid, (lead, (-(n + lead)) % chunk), value=num_gaussians)
    # tile 0's segment now starts at `lead`: starts[0] is the lead the
    # backward's pair table adds
    return binning._replace(sorted_gid=sorted_gid.contiguous(), starts=binning.starts + lead)
