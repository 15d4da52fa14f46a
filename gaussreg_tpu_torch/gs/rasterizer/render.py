"""Public rasterizer API: differentiable 3DGS rendering (port of
gaussreg_tpu/gs/rasterizer/render.py).

render() = project (plain tensor code, autograd) -> sort-based binning (one
sort, detached; binning.py) -> rasterize_gaussians (autograd.Function in
kernels.py: tile compositing forward; backward writing private per-pair
gradient rows + accumulation per gaussian through a pair table inverted
from the binning's sort).

The tile path is the default on every device: CUDA tensors take the CUDA
kernels, CPU tensors their plain versions. `dense_reference=True` selects
the dense O(H W G) renderer of reference.py instead. Counters come back as
0-d tensors; reading one on the host (`int(...)`) synchronizes.

render_sharded() splits one view's image rows over the ranks of a
torch.distributed process group (the JAX package shards them over a mesh
axis): every rank projects the whole (replicated) model and renders its
own rows through the same binning and kernels (K4-K6 launch on every
rank); the backward sums the gaussian-parameter gradients across the ranks
(`_Replicated`). `gather_rows` assembles the full image from the ranks'
rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from gaussreg_tpu_torch.gs.rasterizer import kernels
from gaussreg_tpu_torch.gs.rasterizer.binning import align_blocks, bin_gaussians
from gaussreg_tpu_torch.gs.rasterizer.camera import Camera
from gaussreg_tpu_torch.gs.rasterizer.project import ProjectedGaussians, project_gaussians
from gaussreg_tpu_torch.gs.rasterizer.reference import render_reference


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W) alpha-weighted expected depth
    transmittance: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (G,) screen radii (0 = culled)
    num_pairs: torch.Tensor  # () int32
    overflow: torch.Tensor  # () int32 pairs dropped by the per-gaussian cap
    overflow_cap: torch.Tensor  # () int32 pairs dropped by pair capacity
    sat_blocks: torch.Tensor  # () int32 backward compacted-block demand
    # (size bwd_capacity_blocks >= this)
    sat_depth: torch.Tensor  # (num_padded_tiles,) f32 per-tile saturation
    # depth (+inf where the tile never saturated). Feed back into the next
    # render of ~the same scene to cull pairs behind saturation (they
    # contribute < T_EPS to pixels and zero gradient).
    num_live: torch.Tensor  # () int32 gaussians surviving the saturation
    # cull (== valid count when no sat_depth was given); sizes live_cap


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bin_and_rasterize(
    proj: ProjectedGaussians, hp: int, wp: int, tile_h: int, tile_w: int,
    max_tiles_per_gaussian: int, pair_capacity_blocks: Optional[int],
    bwd_capacity_blocks: Optional[int] = None, sat_depth=None,
    live_cap: Optional[int] = None, sat_margin: float = 1.05, row0: int = 0,
    full_height: Optional[int] = None, pairs_before=None,
):
    """Binning + tile compositing over the (hp, wp) image whose first row is
    pixel row `row0` of proj.means2d's frame, an image of `full_height`
    rows (default: the whole image, row0 = 0). The rasterizer runs over rows
    [0, row0 + hp) with the tiles above row0 empty, so tile ids, culls,
    sort keys and the exponents' pixel coordinates are the whole image's,
    and a slice of rows composites as the whole image does; the outputs are
    the hp rows from row0 on. `pairs_before(num_pairs)`, if given, returns
    the number of pairs the whole image's list holds before this slice's,
    so that the slice's pairs fall on the same 128-pair blocks (the chunks
    the kernels walk and exit after)."""
    g = proj.means2d.shape[0]
    dev = proj.means2d.device
    depths = proj.depths.detach()

    binning = bin_gaussians(
        proj.means2d.detach(), proj.radii.detach(), depths, wp, hp,
        tile_w=tile_w, tile_h=tile_h,
        max_tiles_per_gaussian=max_tiles_per_gaussian, chunk=kernels.CHUNK,
        pair_capacity_blocks=pair_capacity_blocks,
        extents=proj.extents.detach(), minor=proj.minor.detach(),
        sat_depth=sat_depth, live_cap=live_cap, sat_margin=sat_margin,
        row0=row0, full_height=full_height,
    )
    if pairs_before is not None:
        binning = align_blocks(binning, pairs_before(binning.num_pairs), g, kernels.CHUNK)

    coeffs = kernels.quadratic_coeffs(proj.means2d, proj.conics, proj.opacities)  # (G, 6)
    zeros2 = torch.zeros((g, 2), dtype=torch.float32, device=dev)
    gdata = torch.cat(
        [coeffs, zeros2, proj.colors, proj.depths[:, None], zeros2, zeros2], dim=1
    )  # (G, NCHAN)
    # sentinel row: power -> -inf so alpha == 0
    sentinel = torch.zeros((1, kernels.NCHAN), dtype=torch.float32, device=dev)
    sentinel[0, 0] = -1e30
    gdata = torch.cat([gdata, sentinel], dim=0)

    rgb, depth, t, kend = kernels.rasterize_gaussians(
        gdata, binning, row0 + hp, wp, tile_h, tile_w, bwd_capacity_blocks
    )

    # per-tile saturation depth for the NEXT render of ~this scene: the
    # depth of the last pair the forward composited when it exited early
    # (saturated), +inf when the tile consumed all its pairs
    chunk_n = kernels.CHUNK
    cap = binning.sorted_gid.shape[0]
    c0 = torch.clamp_max(binning.starts[:-1], cap)
    c1 = torch.clamp_max(binning.starts[1:], cap)
    start_blk = torch.div(c0, chunk_n, rounding_mode="floor")
    nch = torch.where(
        c1 > c0,
        torch.div(c1 - 1, chunk_n, rounding_mode="floor") - start_blk + 1,
        torch.zeros_like(c0),
    )
    saturated = kend < nch
    e_last = torch.clamp(torch.minimum((start_blk + kend) * chunk_n, c1) - 1, 0, cap - 1)
    gid_last = binning.sorted_gid[e_last.long()]
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=dev)
    d_last = torch.cat([depths, inf])[torch.clamp(gid_last, 0, g).long()]
    sat_depth_out = torch.where(saturated, d_last, inf)

    first_tile = row0 // tile_h * (wp // tile_w)  # the empty tiles above row0
    return (
        rgb[row0:], depth[row0:], t[row0:], binning.num_pairs, binning.overflow,
        binning.overflow_cap + binning.live_overflow,
        torch.sum(kend).to(torch.int32), sat_depth_out[first_tile:], binning.num_live,
    )


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: Camera,
    valid: Optional[torch.Tensor] = None,
    tile_h: int = 32,
    tile_w: int = 32,
    max_tiles_per_gaussian: int = 16,
    sh_degree: int = 3,
    dense_reference: bool = False,
    pair_capacity_blocks: Optional[int] = None,
    bwd_capacity_blocks: Optional[int] = None,
    sat_depth: Optional[torch.Tensor] = None,
    live_gaussian_cap: Optional[int] = None,
    sat_margin: float = 1.05,
) -> RenderOutput:
    """Differentiable render of a 3DGS model from `camera`, on the device of
    `means3d`.

    Args:
        means3d: (G, 3); scales: (G, 3) linear; quats: (G, 4) wxyz;
        opacities: (G,) in [0, 1]; sh_coeffs: (G, 3, K).
        dense_reference: render with the dense reference renderer instead
            of the tile path (tiny scenes, oracle of tests).
        pair_capacity_blocks: total pair capacity in CHUNK-sized blocks
            (default: worst case G*mt; overflow is counted in
            RenderOutput.overflow_cap either way).
        bwd_capacity_blocks: cap on the backward's saturation-compacted
            buffer (kernels.py); None = never-overflow default. For
            repeated renders of saturated scenes, size it from
            RenderOutput.sat_blocks to shrink the gradient pipeline.
        sat_depth: (num_padded_tiles,) per-tile saturation depths from a
            previous RenderOutput of ~this scene (same camera intrinsics +
            tile sizes). Gaussians behind every reachable tile's saturation
            depth contribute < T_EPS and are culled before the pair sort.
        live_gaussian_cap: cap on post-cull gaussians; compacts the live
            set so the pair sort shrinks from G*mt to cap*mt keys. Size it
            from RenderOutput.num_live of a sat_depth probe. Overage is
            counted in overflow_cap, never silently dropped.
        sat_margin: multiplicative slack on sat_depth (tolerates small
            scene/pose deltas between the probe and this render).
    """
    width, height = int(camera.width), int(camera.height)
    proj = project_gaussians(
        means3d, scales, quats, opacities, sh_coeffs, camera, valid=valid,
        sh_degree=sh_degree,
    )
    hp = _round_up(height, tile_h)
    wp = _round_up(width, tile_w)

    if dense_reference:
        rgb, depth, t = render_reference(proj, width, height)
        dev = means3d.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        num_valid = torch.sum(proj.valid).to(torch.int32)
        ntiles = (hp // tile_h) * (wp // tile_w)
        return RenderOutput(
            rgb, depth, t, proj.radii.detach(), num_valid, zero, zero, zero,
            torch.full((ntiles,), float("inf"), dtype=torch.float32, device=dev),
            num_valid,
        )

    (
        rgb, depth, t, num_pairs, overflow, overflow_cap, sat, sat_depth_out, num_live,
    ) = _bin_and_rasterize(
        proj, hp, wp, tile_h, tile_w, max_tiles_per_gaussian,
        pair_capacity_blocks, bwd_capacity_blocks,
        sat_depth=sat_depth, live_cap=live_gaussian_cap, sat_margin=float(sat_margin),
    )
    return RenderOutput(
        rgb[:height, :width],
        depth[:height, :width],
        t[:height, :width],
        proj.radii.detach(),
        num_pairs,
        overflow,
        overflow_cap,
        sat,
        sat_depth_out,
        num_live,
    )


class _Replicated(torch.autograd.Function):
    """Inputs that every rank holds whole: the identity forward; the
    backward sums their gradients across the group's ranks in one flat
    all-reduce, so every rank holds the gradient of the sum of all ranks'
    losses (the transpose of shard_map's replicated inputs)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        out, offset = [], 0
        for g in grads:
            out.append(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return (None, *out)


def sharded_rows(height: int, tile_h: int, group=None):
    """(first, end): the rows [first, end) of the `height`-row image that
    this rank renders in render_sharded: rows [r * local_h, (r + 1) *
    local_h) of the image padded to a multiple of world * tile_h, cut at
    `height` (the last ranks may hold fewer rows, or none)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    local_h = _round_up(height, world * tile_h) // world
    first = min(rank * local_h, height)
    return first, min(first + local_h, height)


def render_sharded(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: Camera,
    group=None,
    valid: Optional[torch.Tensor] = None,
    tile_h: int = 32,
    tile_w: int = 32,
    max_tiles_per_gaussian: int = 16,
    sh_degree: int = 3,
    pair_capacity_blocks: Optional[int] = None,
    bwd_capacity_blocks: Optional[int] = None,
    sat_depth: Optional[torch.Tensor] = None,
    live_gaussian_cap: Optional[int] = None,
    sat_margin: float = 1.05,
) -> RenderOutput:
    """Differentiable render with the image rows split over the ranks of
    the process group `group` (default: the default group). Every rank
    calls it with the same model and camera.

    Each rank projects all gaussians and bins and composites only its rows
    (`sharded_rows`): the tile cull drops the gaussians that miss them. The
    slice keeps the whole image's frame: its tiles, culls and sort keys are
    the whole image's, the kernels run over the rows from 0 to the slice's
    end with the tiles above the slice empty (they exit at once), so each
    exponent is evaluated at the whole image's pixel coordinates, and its
    pair list starts at the block offset the whole image's list would give
    it (one all-gather of the pair counts), so every tile walks and exits
    after the same chunks as in render(). (The JAX package shifts the
    screen positions by the slice's first row instead, which rounds the
    exponents otherwise, and lets the chunks fall elsewhere.) The backward
    all-reduces the gradients of the
    gaussian parameters and of camera.w2c, so every rank holds the full
    gradient of the sum of the ranks' losses.

    Returns this rank's rows: rgb (rows, width, 3), depth and transmittance
    (rows, width); radii of all gaussians; num_pairs, overflow and
    overflow_cap summed over the ranks; sat_blocks and num_live the maximum
    over them (the caps below are per slice and sized from the busiest);
    sat_depth of this rank's tiles, to be fed back to this rank's next
    render of ~this scene. live_gaussian_cap and bwd_capacity_blocks are
    per slice. The per-gaussian tile cap applies per slice, so `overflow`
    may read lower than render()'s for the same scene.
    """
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    height, width = int(camera.height), int(camera.width)
    hp = _round_up(height, world * tile_h)
    wp = _round_up(width, tile_w)
    local_h = hp // world
    w2c = camera.w2c.to(device=means3d.device, dtype=means3d.dtype)
    means3d, scales, quats, opacities, sh_coeffs, w2c = _Replicated.apply(
        group, means3d, scales, quats, opacities, sh_coeffs, w2c)
    proj = project_gaussians(
        means3d, scales, quats, opacities, sh_coeffs, camera._replace(w2c=w2c),
        valid=valid, sh_degree=sh_degree,
    )

    def pairs_before(num_pairs):
        counts = [torch.zeros(1, dtype=torch.int64, device=num_pairs.device)
                  for _ in range(world)]
        dist.all_gather(counts, num_pairs.reshape(1).to(torch.int64), group=group)
        return int(sum(c.item() for c in counts[:rank]))

    (
        rgb, depth, t, num_pairs, overflow, overflow_cap, sat, sat_depth_out, num_live,
    ) = _bin_and_rasterize(
        proj, local_h, wp, tile_h, tile_w, max_tiles_per_gaussian,
        pair_capacity_blocks, bwd_capacity_blocks,
        sat_depth=sat_depth, live_cap=live_gaussian_cap, sat_margin=float(sat_margin),
        row0=rank * local_h, full_height=_round_up(height, tile_h), pairs_before=pairs_before,
    )
    sums = torch.stack([num_pairs, overflow, overflow_cap]).to(torch.int64)
    maxes = torch.stack([sat, num_live]).to(torch.int64)
    dist.all_reduce(sums, group=group)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=group)
    first, end = sharded_rows(height, tile_h, group)
    rows = end - first
    return RenderOutput(
        rgb[:rows, :width],
        depth[:rows, :width],
        t[:rows, :width],
        proj.radii.detach(),
        sums[0].to(torch.int32),
        sums[1].to(torch.int32),
        sums[2].to(torch.int32),
        maxes[0].to(torch.int32),
        sat_depth_out,
        maxes[1].to(torch.int32),
    )


def gather_rows(local: torch.Tensor, height: int, tile_h: int = 32, group=None) -> torch.Tensor:
    """The full (height, ...) image from each rank's rows of a
    render_sharded output (`local`, this rank's rows); every rank of
    `group` calls it and gets the whole image. Not differentiable."""
    world = dist.get_world_size(group)
    local_h = _round_up(height, world * tile_h) // world
    padded = local.new_zeros((local_h,) + tuple(local.shape[1:]))
    padded[:local.shape[0]] = local.detach()
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded.contiguous(), group=group)
    return torch.cat(parts)[:height]
