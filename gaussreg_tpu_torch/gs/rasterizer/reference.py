"""Dense reference renderer: exact per-pixel alpha compositing over all
gaussians, differentiable by autograd (port of
gaussreg_tpu/gs/rasterizer/reference.py). O(H*W*G): the correctness oracle
of the tile rasterizer and a renderer for tiny scenes.
"""

from __future__ import annotations

import torch

from gaussreg_tpu_torch.gs.rasterizer.project import ProjectedGaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99


def composite_pixels(px: torch.Tensor, order: torch.Tensor, proj: ProjectedGaussians):
    """Alpha-composite every gaussian, in `order` (front to back), over the
    pixel centers px (..., 2), one gaussian at a time. Returns (rgbd
    (..., 4): rgb and depth composited alike, T (...))."""
    means = proj.means2d[order]
    conics = proj.conics[order]
    colors = torch.cat([proj.colors, proj.depths[:, None]], dim=1)[order]
    opac = torch.where(proj.valid[order], proj.opacities[order],
                       torch.zeros_like(proj.opacities[order]))
    rgbd = torch.zeros(px.shape[:-1] + (4,), dtype=torch.float32, device=px.device)
    t = torch.ones(px.shape[:-1], dtype=torch.float32, device=px.device)
    for i in range(means.shape[0]):
        d = px - means[i]
        conic = conics[i]
        power = -0.5 * (conic[0] * d[..., 0] ** 2 + conic[2] * d[..., 1] ** 2) \
            - conic[1] * d[..., 0] * d[..., 1]
        alpha = opac[i] * torch.exp(torch.clamp_max(power, 0.0))
        alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha),
                            torch.clamp_max(alpha, ALPHA_MAX))
        rgbd = rgbd + (t * alpha)[..., None] * colors[i]
        t = t * (1.0 - alpha)
    return rgbd, t


def render_reference(
    proj: ProjectedGaussians, width: int, height: int, gaussian_block: int = 256
):
    """Full-image reference render. Returns (rgb (H, W, 3), depth (H, W),
    T (H, W)). Gaussians are composited front to back in depth order,
    `gaussian_block` at a time (a (block, H, W) alpha volume per step)."""
    dev = proj.means2d.device
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depths, inf), stable=True)
    means = proj.means2d[order]
    conics = proj.conics[order]
    colors = torch.cat([proj.colors, proj.depths[:, None]], dim=1)[order]  # rgb + depth
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))[order]

    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)

    rgbd = torch.zeros((height, width, 4), dtype=torch.float32, device=dev)
    t = torch.ones((height, width), dtype=torch.float32, device=dev)
    for lo in range(0, means.shape[0], gaussian_block):
        sl = slice(lo, lo + gaussian_block)
        dx = px[None] - means[sl, 0, None, None]  # (B, H, W)
        dy = py[None] - means[sl, 1, None, None]
        ca, cb, cc = (conics[sl, i, None, None] for i in range(3))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = opac[sl, None, None] * torch.exp(torch.clamp_max(power, 0.0))
        alpha = torch.where(
            alpha < ALPHA_MIN, torch.zeros_like(alpha), torch.clamp_max(alpha, ALPHA_MAX)
        )
        trans = torch.cumprod(1.0 - alpha, dim=0)  # inclusive
        t_before = t[None] * torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
        rgbd = rgbd + torch.einsum("bhw,bc->hwc", t_before * alpha, colors[sl])
        t = t * trans[-1]
    return rgbd[..., :3], rgbd[..., 3], t
