"""Tile-based gaussian alpha compositing, forward and analytic backward
(port of gaussreg_tpu/gs/rasterizer/kernels.py, TPU kernels K4 and K5).

`rasterize_gaussians` is a torch.autograd.Function. For CUDA tensors its
forward launches csrc/rasterize_fwd.cu and its backward launches
csrc/rasterize_bwd.cu followed by the per-gaussian accumulation of
accumulate.py (K6); for CPU tensors they run the plain PyTorch versions
(`rasterize_forward_plain`, `rasterize_backward_plain`,
`accumulate_pairs_plain`).

The function (shared by kernel and plain version):

- each gaussian's log-density is a quadratic form in pixel coordinates,
  power = a0 + ax x + ay y + axx x^2 + axy xy + ayy y^2 at pixel centres
  (+0.5), with log(opacity) folded into a0; raw = exp(min(power, 0)),
  alpha = 0 below 1/255 and capped at 0.99. The power is summed in exactly
  this order with every product and sum rounded to f32 (no fused
  multiply-add): in global pixel coordinates the terms cancel heavily, so
  kernel and plain version only agree closely when they round alike;
- the pair layout is UNALIGNED: tile t's pairs occupy sorted elements
  [starts[t], starts[t+1]) clamped to the capacity, and its chunks are the
  128-aligned blocks of the global pair array that cover that range; rows
  of a boundary block that belong to the neighbouring tile are skipped;
- the forward stops a tile after a whole chunk once every pixel's
  transmittance is below T_EPS and reports the number of chunks it
  composited (`kend`). Only those chunks carry gradient;
- a render that will be differentiated (grad mode on and `gdata`
  requiring grad) also saves, per pixel, T and the composited colour and
  depth before every walked chunk k >= 1 (the chunk-start state,
  `state_slots`); probes and targets save none;
- the backward walks tile t's first offs[t+1] - offs[t] chunks
  (offs = min(cumsum(kend), bwd_capacity_blocks)), each from its saved
  start (the kernel: one block per chunk; the plain version without a
  state recomputes the starts chunk after chunk, in forward order),
  with the suffix colour sums as <d, final> - <d, prefix>, and writes one
  private 16-float gradient row per (tile, pair) into the compacted range
  [offs[t], offs[t+1]) of its output. The rows are added per gaussian by
  `accumulate_pairs`, which reads each gaussian's pairs in a fixed order
  from a pair table the backward builds from the binning's sort
  (`binning.slot_positions` of `order`, and `row_gid`), so two runs give
  the same bits.

`bwd_capacity_blocks` caps the compacted buffer. The default
(num_blocks + num_tiles) can never overflow; tiles past a tighter cap lose
their gradient (callers size it from `sat_blocks`, render.py).

Per-gaussian channel layout (16 floats per row of `gdata`):
  0..5: quadratic coeffs [a0 + log(op), ax, ay, axx, axy, ayy]
  6..7: zero
  8..11: r, g, b, depth (depth is composited like a colour, yielding the
         alpha-weighted expected depth)
  12..15: zero
Row G of `gdata` is the sentinel (a0 = -1e30, alpha == 0) that padding
slots of `sorted_gid` point at.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.gs.rasterizer.accumulate import accumulate_pairs
from gaussreg_tpu_torch.gs.rasterizer.binning import TileBinning, slot_positions
from gaussreg_tpu_torch.ops import _cuda

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4  # chunk-level early termination threshold on the tile's max T
CHUNK = 128  # pairs per chunk
NCHAN = 16  # floats per gaussian row

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
FWD_KERNEL = _cuda.register(
    "rasterize_forward",
    _cuda.CudaKernel(
        "rasterize_fwd.cu",
        "gaussreg_rasterize_fwd",
        # gdata, sorted_gid, starts, planes, kend, state, cap, ntx, nty,
        # tile_w, tile_h, cluster
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT],
    ),
)
BWD_KERNEL = _cuda.register(
    "rasterize_backward",
    _cuda.CudaKernel(
        "rasterize_bwd.cu",
        "gaussreg_rasterize_bwd",
        # gdata, sorted_gid, starts, offs, ct_planes, state, grad_rows,
        # bwd_blocks, cap, ntx, nty, tile_w, tile_h
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT],
    ),
)


def _tile_grid(height: int, width: int, tile_h: int, tile_w: int):
    if height % tile_h or width % tile_w:
        raise ValueError(
            f"rasterizer: image {height}x{width} is not a multiple of the "
            f"{tile_h}x{tile_w} tile (render pads it)"
        )
    return height // tile_h, width // tile_w


def _pixel_basis(t: int, ntx: int, tile_h: int, tile_w: int, device, dtype):
    """x, y, x^2, xy, y^2 at the pixel centres of tile t, each (NPIX,) with
    pixel index py * tile_w + px."""
    ty, tx = divmod(t, ntx)
    lane = torch.arange(tile_h * tile_w, device=device)
    x = (lane % tile_w + tx * tile_w).to(dtype) + 0.5
    y = (lane // tile_w + ty * tile_h).to(dtype) + 0.5
    return x, y, x * x, x * y, y * y


def _chunk_alpha(rows: torch.Tensor, basis):
    """(alpha, raw), each (K, NPIX), of K gaussian rows at a tile's pixels.
    One rounded operation per step, in the order the kernels use."""
    x, y, xx, xy, yy = basis
    c = rows[:, :6, None]
    power = c[:, 0] + c[:, 1] * x
    power = power + c[:, 2] * y
    power = power + c[:, 3] * xx
    power = power + c[:, 4] * xy
    power = power + c[:, 5] * yy
    raw = torch.exp(torch.clamp_max(power, 0.0))
    alpha = torch.where(
        raw < ALPHA_MIN, torch.zeros_like(raw), torch.clamp_max(raw, ALPHA_MAX)
    )
    return alpha, raw


def _tile_chunks(starts, cap: int):
    """Per tile (c0, c1, first block, chunk count) of its clamped element
    range, as Python lists (one host read of `starts`)."""
    s = torch.clamp_max(starts, cap).tolist()
    out = []
    for c0, c1 in zip(s[:-1], s[1:]):
        b0 = c0 // CHUNK
        out.append((c0, c1, b0, (c1 - 1) // CHUNK - b0 + 1 if c1 > c0 else 0))
    return out


def _own_rows(c0: int, c1: int, block: int):
    """Element range of the tile's own rows inside one 128-aligned block."""
    return max(c0, block * CHUNK), min(c1, (block + 1) * CHUNK)


def state_slots(num_pair_blocks: int, num_tiles: int) -> int:
    """Slots of the chunk-start state: walked chunk k >= 1 of tile t with
    first block b0 is stored at slot b0 + t + k - 1, unique and below
    num_blocks + num_tiles (tile t + 1 starts at or after tile t's last
    block)."""
    return num_pair_blocks + num_tiles


def written_state_slots(starts, kend, cap: int) -> torch.Tensor:
    """Slots of the chunk-start state a forward with these `kend` writes:
    b0 + t + k - 1 for the walked chunks 1 <= k < kend[t] of each tile t
    (int64, in tile order)."""
    b0 = torch.div(torch.clamp_max(starts[:-1], cap), CHUNK, rounding_mode="floor").long()
    tiles = torch.arange(kend.shape[0], device=kend.device)
    k = torch.arange(1, max(int(kend.max()), 1) if kend.numel() else 1, device=kend.device)
    slot = b0[:, None] + tiles[:, None] + k[None, :] - 1
    return slot[k[None, :] < kend[:, None].long()]


def rasterize_forward_plain(
    gdata, sorted_gid, starts, height: int, width: int, tile_h: int, tile_w: int,
    save_state: bool = False,
):
    """Plain PyTorch version of the forward kernel: a loop over tiles and
    their chunks with (K, NPIX) tensors. Returns (planes (5, H, W) =
    r, g, b, depth, T; kend (num_tiles,) int32), and with `save_state` also
    the chunk-start state (state_slots(...), 5, NPIX): T, r, g, b, depth of
    each pixel before each walked chunk k >= 1 (other slots are zero)."""
    nty, ntx = _tile_grid(height, width, tile_h, tile_w)
    dev, dt = gdata.device, gdata.dtype
    npix = tile_h * tile_w
    planes = torch.zeros((5, height, width), dtype=dt, device=dev)
    planes[4] = 1.0
    state = None
    if save_state:
        slots = state_slots(sorted_gid.shape[0] // CHUNK, nty * ntx)
        state = torch.zeros((slots, 5, npix), dtype=dt, device=dev)
    kend = [0] * (nty * ntx)
    for t, (c0, c1, b0, nch) in enumerate(_tile_chunks(starts, sorted_gid.shape[0])):
        if nch == 0:
            continue
        basis = _pixel_basis(t, ntx, tile_h, tile_w, dev, dt)
        t_row = torch.ones(npix, dtype=dt, device=dev)
        acc = torch.zeros((4, npix), dtype=dt, device=dev)
        k = 0
        while k < nch:
            if state is not None and k > 0:
                state[b0 + t + k - 1, 0] = t_row
                state[b0 + t + k - 1, 1:] = acc
            lo, hi = _own_rows(c0, c1, b0 + k)
            rows = gdata[sorted_gid[lo:hi].long()]
            alpha, _ = _chunk_alpha(rows, basis)
            trans = torch.cumprod(1.0 - alpha, dim=0)  # inclusive
            tj = t_row * torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
            acc = acc + rows[:, 8:12].T @ (alpha * tj)
            t_row = t_row * trans[-1]
            k += 1
            if float(t_row.max()) < T_EPS:
                break
        kend[t] = k
        ty, tx = divmod(t, ntx)
        ys, xs = slice(ty * tile_h, (ty + 1) * tile_h), slice(tx * tile_w, (tx + 1) * tile_w)
        planes[:4, ys, xs] = acc.reshape(4, tile_h, tile_w)
        planes[4, ys, xs] = t_row.reshape(tile_h, tile_w)
    kend = torch.tensor(kend, dtype=torch.int32, device=dev)
    return (planes, kend, state) if save_state else (planes, kend)


def walk_backward_chunks(
    gdata, sorted_gid, starts, offs, ct_planes, height: int, width: int, tile_h: int,
    tile_w: int, state=None,
):
    """The backward's walk, chunk by chunk: yields, for chunk k of tile t
    (the first offs[t+1] - offs[t] chunks of each tile), a dict with the
    tile, k, the output rows' first index `out0`, the per-pair gradients
    `d_coef` (n, 6) and `d_colour` (n, 4), and the chunk's start per pixel:
    `t_row` (T), `prefix` (r, g, b, depth composited so far) and `vp`
    (<d_rgbd, prefix>).

    Without `state` the walk is sequential: each chunk starts from the T and
    <d, prefix> the previous one left (the Pallas kernel's order). With the
    forward's chunk-start `state` every chunk starts from its saved slot
    (chunk 0 from T = 1 and colour 0), as the chunk-parallel kernel does."""
    nty, ntx = _tile_grid(height, width, tile_h, tile_w)
    dev, dt = gdata.device, gdata.dtype
    npix = tile_h * tile_w
    offs_l = offs.tolist()
    for t, (c0, c1, b0, _) in enumerate(_tile_chunks(starts, sorted_gid.shape[0])):
        base, nch = offs_l[t], offs_l[t + 1] - offs_l[t]
        if nch == 0:
            continue
        basis = _pixel_basis(t, ntx, tile_h, tile_w, dev, dt)
        phi = torch.stack([torch.ones_like(basis[0]), *basis], dim=0)  # (6, NPIX)
        ty, tx = divmod(t, ntx)
        ct = ct_planes[
            :, ty * tile_h:(ty + 1) * tile_h, tx * tile_w:(tx + 1) * tile_w
        ].reshape(7, -1)
        d_rgb, v = ct[0:4], ct[6]
        ct_t = ct[4] * ct[5]  # d_T_final * T_final
        t_row = torch.ones(npix, dtype=dt, device=dev)
        prefix = torch.zeros((4, npix), dtype=dt, device=dev)
        vp_row = torch.zeros_like(v)  # <d, prefix so far>
        for k in range(nch):
            if state is not None and k > 0:
                s = state[b0 + t + k - 1]
                t_row, prefix = s[0], s[1:]
                vp_row = d_rgb[0] * prefix[0] + d_rgb[1] * prefix[1]
                vp_row = vp_row + d_rgb[2] * prefix[2]
                vp_row = vp_row + d_rgb[3] * prefix[3]
            lo, hi = _own_rows(c0, c1, b0 + k)
            rows = gdata[sorted_gid[lo:hi].long()]
            alpha, raw = _chunk_alpha(rows, basis)
            one_m = 1.0 - alpha
            trans = torch.cumprod(one_m, dim=0)
            tj = t_row * torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
            w = alpha * tj
            e = rows[:, 8:12] @ d_rgb  # (K, NPIX)
            ew = e * w
            u = vp_row + torch.cumsum(ew, dim=0)  # <d, P_j>, own term included
            d_alpha = e * tj - (v - u) / one_m - ct_t / one_m
            active = (raw >= ALPHA_MIN) & (raw <= ALPHA_MAX)
            # d raw / d power = raw in the active band (alpha == raw there)
            d_power = torch.where(active, d_alpha * raw, torch.zeros_like(raw))
            yield dict(
                tile=t, k=k, out0=(base + k) * CHUNK + (lo - (b0 + k) * CHUNK),
                d_coef=d_power @ phi.T, d_colour=w @ d_rgb.T, t_row=t_row, prefix=prefix,
                vp=vp_row,
            )
            prefix = prefix + rows[:, 8:12].T @ w
            t_row = t_row * trans[-1]
            vp_row = u[-1]


def rasterize_backward_plain(
    gdata, sorted_gid, starts, offs, ct_planes, bwd_blocks: int,
    height: int, width: int, tile_h: int, tile_w: int, state=None,
):
    """Plain PyTorch version of the backward kernel (analytic formulas).

    ct_planes (7, H, W) = d_r, d_g, d_b, d_depth, d_T, T_final, v with
    v = sum over the 4 colour channels of d_ch * final_ch. With the
    forward's chunk-start `state` each chunk starts from its saved T and
    prefix colour (the kernel's chunk-parallel form); without it the walk
    recomputes them chunk after chunk (`walk_backward_chunks`). Returns the
    per-pair gradient rows (bwd_blocks * CHUNK, NCHAN): channels 0..5 hold
    d/d(quadratic coeffs), 8..11 d/d(r, g, b, depth); rows the walk does not
    reach are zero."""
    grad = torch.zeros((bwd_blocks * CHUNK, NCHAN), dtype=gdata.dtype, device=gdata.device)
    for c in walk_backward_chunks(gdata, sorted_gid, starts, offs, ct_planes, height, width,
                                  tile_h, tile_w, state):
        n = c["d_coef"].shape[0]
        grad[c["out0"]:c["out0"] + n, 0:6] = c["d_coef"]
        grad[c["out0"]:c["out0"] + n, 8:12] = c["d_colour"]
    return grad


def _check_pair_inputs(gdata, sorted_gid, starts, num_tiles: int, tile_h: int, tile_w: int):
    _cuda.check_cuda_tensor(gdata, "gdata", torch.float32, 2)
    _cuda.check_cuda_tensor(sorted_gid, "sorted_gid", torch.int32, 1)
    _cuda.check_cuda_tensor(starts, "starts", torch.int32, 1)
    npix = tile_h * tile_w
    if gdata.shape[1] != NCHAN or starts.shape[0] != num_tiles + 1:
        raise ValueError(
            f"rasterizer: gdata {tuple(gdata.shape)} / starts {tuple(starts.shape)} "
            f"do not fit {num_tiles} tiles of {NCHAN}-float rows"
        )
    if npix > 1024 or npix % 32:
        raise ValueError(
            f"rasterizer: a {tile_h}x{tile_w} tile needs one thread per pixel: "
            "at most 1024 pixels, a multiple of 32"
        )


def forward_cluster_size(npix: int) -> int:
    """Blocks of the thread-block cluster that shares one tile's pixels in
    the forward kernel: blocks of 128 pixels (one per thread), at most 8
    (the card's portable cluster size): 8 at 32x32 tiles, 2 at 16x16, 1
    below 256 pixels."""
    for p in (8, 4, 2):
        if npix // p >= 128 and npix % (32 * p) == 0:
            return p
    return 1


def rasterize_forward(
    gdata, sorted_gid, starts, height: int, width: int, tile_h: int, tile_w: int,
    save_state: bool = False,
):
    """K4: composite every tile's sorted pairs. Returns (planes (5, H, W) =
    r, g, b, depth, T; kend (num_tiles,) int32), and with `save_state` also
    the chunk-start state the backward walks from (see
    `rasterize_forward_plain`; on the card only the walked chunks' slots are
    written). On the card a tile's pixels are shared by a cluster of
    `forward_cluster_size` blocks; a launch the card refuses raises."""
    if gdata.device.type == "cpu":
        return rasterize_forward_plain(
            gdata, sorted_gid, starts, height, width, tile_h, tile_w, save_state
        )
    nty, ntx = _tile_grid(height, width, tile_h, tile_w)
    _check_pair_inputs(gdata, sorted_gid, starts, nty * ntx, tile_h, tile_w)
    npix = tile_h * tile_w
    planes = torch.empty((5, height, width), dtype=torch.float32, device=gdata.device)
    kend = torch.empty((nty * ntx,), dtype=torch.int32, device=gdata.device)
    state = None
    if save_state:
        slots = state_slots(sorted_gid.shape[0] // CHUNK, nty * ntx)
        state = torch.empty((slots, 5, npix), dtype=torch.float32, device=gdata.device)
    FWD_KERNEL.launch(
        gdata.data_ptr(), sorted_gid.data_ptr(), starts.data_ptr(), planes.data_ptr(),
        kend.data_ptr(), 0 if state is None else state.data_ptr(), sorted_gid.shape[0], ntx,
        nty, tile_w, tile_h, forward_cluster_size(npix),
    )
    return (planes, kend, state) if save_state else (planes, kend)


def rasterize_backward(
    gdata, sorted_gid, starts, offs, ct_planes, bwd_blocks: int,
    height: int, width: int, tile_h: int, tile_w: int, state=None,
):
    """K5: per-pair gradient rows (bwd_blocks * CHUNK, NCHAN), private per
    tile, over the first offs[t+1] - offs[t] chunks of each tile. On the
    card one block per compacted chunk walks it from the forward's
    chunk-start `state`, which it needs; on the CPU `state=None` takes the
    sequential walk."""
    if gdata.device.type == "cpu":
        return rasterize_backward_plain(
            gdata, sorted_gid, starts, offs, ct_planes, bwd_blocks, height, width,
            tile_h, tile_w, state,
        )
    nty, ntx = _tile_grid(height, width, tile_h, tile_w)
    _check_pair_inputs(gdata, sorted_gid, starts, nty * ntx, tile_h, tile_w)
    _cuda.check_cuda_tensor(offs, "offs", torch.int32, 1)
    _cuda.check_cuda_tensor(ct_planes, "ct_planes", torch.float32, 3)
    if state is None:
        raise ValueError("rasterize_backward: the kernel walks each chunk from the forward's "
                         "chunk-start state (rasterize_forward(..., save_state=True))")
    _cuda.check_cuda_tensor(state, "state", torch.float32, 3)
    slots = state_slots(sorted_gid.shape[0] // CHUNK, nty * ntx)
    if offs.shape[0] != nty * ntx + 1 or ct_planes.shape != (7, height, width):
        raise ValueError(
            f"rasterize_backward: offs {tuple(offs.shape)} / ct_planes "
            f"{tuple(ct_planes.shape)} do not fit a {height}x{width} image"
        )
    if state.shape != (slots, 5, tile_h * tile_w) or bwd_blocks <= 0:
        raise ValueError(
            f"rasterize_backward: state {tuple(state.shape)} is not ({slots}, 5, "
            f"{tile_h * tile_w}) or bwd_blocks {bwd_blocks} is not positive"
        )
    # zeroed: the kernel writes only the rows it walks (10 of 16 channels)
    grad = torch.zeros((bwd_blocks * CHUNK, NCHAN), dtype=torch.float32, device=gdata.device)
    BWD_KERNEL.launch(
        gdata.data_ptr(), sorted_gid.data_ptr(), starts.data_ptr(), offs.data_ptr(),
        ct_planes.data_ptr(), state.data_ptr(), grad.data_ptr(), bwd_blocks,
        sorted_gid.shape[0], ntx, nty, tile_w, tile_h,
    )
    return grad


def compacted_offsets(kend: torch.Tensor, bwd_blocks: int) -> torch.Tensor:
    """(num_tiles + 1,) int32 compacted block offsets of the backward:
    cumsum(kend) clipped to the buffer's capacity."""
    zero = torch.zeros((1,), dtype=torch.int32, device=kend.device)
    return torch.clamp_max(
        torch.cat([zero, torch.cumsum(kend, dim=0, dtype=torch.int32)]), bwd_blocks
    )


def compacted_gids(sorted_gid, starts, offs, bwd_blocks: int, drop_id: int):
    """Gaussian id of every row of the compacted gradient buffer,
    (bwd_blocks * CHUNK,) int32: compacted block -> original block -> ids.
    Rows of blocks past the compacted end get `drop_id`. The oracle of
    `accumulate_pairs` (with `segment_accumulate_plain`); no path calls it."""
    nblk = sorted_gid.shape[0] // CHUNK
    blocks = torch.arange(bwd_blocks, dtype=torch.int32, device=offs.device)
    # tile of each compacted block: number of tile ends at or before it
    tile_of = torch.searchsorted(offs[1:-1].contiguous(), blocks, right=True)
    k_of = blocks - offs[tile_of]
    start_blk = torch.div(starts[:-1], CHUNK, rounding_mode="floor")
    blk_src = torch.clamp(start_blk[tile_of] + k_of, 0, nblk - 1).long()
    gid = sorted_gid.reshape(nblk, CHUNK)[blk_src]
    live = (blocks < offs[-1])[:, None]
    return torch.where(live, gid, torch.full_like(gid, drop_id)).reshape(-1)


class _RasterizeGaussians(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gdata, sorted_gid, starts, order, row_gid, height, width,
                tile_h, tile_w, bwd_capacity_blocks, differentiated):
        gdata = gdata.contiguous()
        # only a render whose backward will run saves the chunk-start state
        out = rasterize_forward(
            gdata, sorted_gid, starts, height, width, tile_h, tile_w, save_state=differentiated
        )
        planes, kend = out[:2]
        state = out[2] if differentiated else None
        ctx.save_for_backward(gdata, sorted_gid, starts, kend, planes, order, row_gid, state)
        ctx.geometry = (height, width, tile_h, tile_w, bwd_capacity_blocks)
        ctx.mark_non_differentiable(kend)
        return planes[:3].permute(1, 2, 0), planes[3], planes[4], kend

    @staticmethod
    def backward(ctx, d_rgb, d_depth, d_t, _d_kend):
        gdata, sorted_gid, starts, kend, planes, order, row_gid, state = ctx.saved_tensors
        height, width, tile_h, tile_w, bwd_blocks = ctx.geometry
        num_tiles = starts.shape[0] - 1
        if bwd_blocks is None:
            bwd_blocks = sorted_gid.shape[0] // CHUNK + num_tiles
        offs = compacted_offsets(kend, bwd_blocks)

        d_planes = torch.cat([d_rgb.permute(2, 0, 1), d_depth[None]], dim=0)  # (4, H, W)
        v = torch.sum(d_planes * planes[:4], dim=0)
        ct_planes = torch.cat([d_planes, d_t[None], planes[4:5], v[None]], dim=0)
        with annotate("render.raster_bwd"):
            grad_rows = rasterize_backward(
                gdata, sorted_gid, starts, offs, ct_planes.contiguous(), bwd_blocks,
                height, width, tile_h, tile_w, state,
            )
        # the pair table, built here: only a differentiated render pays for
        # it. The sentinel row G is in no row of the table: its cotangent
        # stays zero (alpha == 0 there)
        with annotate("render.accumulate"):
            n_rows = row_gid.shape[0]
            slot_pos = slot_positions(order, n_rows, order.shape[0] // max(n_rows, 1),
                                      starts[:1])
            d_gdata = accumulate_pairs(
                grad_rows, slot_pos, row_gid, starts, offs, sorted_gid.shape[0],
                gdata.shape[0]
            )
        return d_gdata, None, None, None, None, None, None, None, None, None, None


def rasterize_gaussians(
    gdata: torch.Tensor,
    binning: TileBinning,
    height: int,
    width: int,
    tile_h: int = 32,
    tile_w: int = 32,
    bwd_capacity_blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite per-gaussian channel rows into an image via the sorted
    (gaussian, tile) pair list from binning. Differentiable in `gdata`.

    Args:
        gdata: (G + 1, NCHAN) per-gaussian channels (module docstring
            layout); row G is the sentinel (a0 = -1e30).
        binning: `bin_gaussians`' output: sorted_gid ((cap,) int32 pair ids
            in (tile, depth) order, cap a multiple of CHUNK), starts
            ((num_tiles + 1,) int32 element offsets of tile segments), and
            the sort's `order` and `row_gid`, from which the backward builds
            its pair table.
        bwd_capacity_blocks: cap on the compacted backward buffer; None =
            num_blocks + num_tiles (never overflows).

    Returns:
        rgb (H, W, 3), depth (H, W), transmittance (H, W),
        kend (num_tiles,) int32: per-tile chunks composited before
        saturation. sum(kend) is the backward's block demand.
    """
    if binning.sorted_gid.shape[0] % CHUNK:
        raise ValueError(
            f"sorted_gid length {binning.sorted_gid.shape[0]} is not a multiple of {CHUNK}"
        )
    return _RasterizeGaussians.apply(
        gdata, binning.sorted_gid, binning.starts, binning.order, binning.row_gid, height,
        width, tile_h, tile_w, bwd_capacity_blocks,
        torch.is_grad_enabled() and gdata.requires_grad,
    )


def quadratic_coeffs(
    means2d: torch.Tensor, conics: torch.Tensor, opacities: torch.Tensor
) -> torch.Tensor:
    """Per-gaussian quadratic exponent coefficients (G, 6): power(px) =
    a0 + ax*x + ay*y + axx*x^2 + axy*x*y + ayy*y^2, with log(opacity) folded
    into a0 so alpha = exp(min(power, 0)) clamped. Differentiable: the
    kernels return d/d_coeffs and autograd maps back to means/conics/op."""
    mx, my = means2d[:, 0], means2d[:, 1]
    ca, cb, cc = conics[:, 0], conics[:, 1], conics[:, 2]
    log_op = torch.log(torch.clamp_min(opacities, 1e-12))
    a0 = -0.5 * (ca * mx * mx + cc * my * my) - cb * mx * my + log_op
    ax = ca * mx + cb * my
    ay = cc * my + cb * mx
    return torch.stack([a0, ax, ay, -0.5 * ca, -cb, -0.5 * cc], dim=1)
