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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussreg_tpu_torch.gs.rasterizer import kernels
from gaussreg_tpu_torch.gs.rasterizer.binning import bin_gaussians
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
    live_cap: Optional[int] = None, sat_margin: float = 1.05,
):
    """Binning + tile compositing over an (hp, wp) image whose pixel frame
    matches proj.means2d."""
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
    )

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
        gdata, binning, hp, wp, tile_h, tile_w, bwd_capacity_blocks
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

    return (
        rgb, depth, t, binning.num_pairs, binning.overflow,
        binning.overflow_cap + binning.live_overflow,
        torch.sum(kend).to(torch.int32), sat_depth_out, binning.num_live,
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
