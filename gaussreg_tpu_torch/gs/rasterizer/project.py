"""EWA projection of 3D gaussians to screen space (port of
gaussreg_tpu/gs/rasterizer/project.py; plain tensor code, differentiable).

The math follows the 3DGS formulation (Kerbl et al. 2023): world covariance
Sigma = R S S^T R^T from quaternion + linear-scale parameters, camera-space
covariance W Sigma W^T, perspective Jacobian J, screen covariance
Sigma' = J W Sigma W^T J^T + 0.3 I, inverse conic for the exponent, and a
3-sigma screen radius. This is the differentiable front end of the tile
rasterizer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussreg_tpu_torch.gs import sh as sh_mod
from gaussreg_tpu_torch.gs.rasterizer.camera import Camera
from gaussreg_tpu_torch.ops.transforms import quaternion_to_matrix


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor  # (G, 2) pixel coords
    depths: torch.Tensor  # (G,)
    conics: torch.Tensor  # (G, 3) inverse-covariance (a, b, c): a dx^2 + 2b dxdy + c dy^2
    colors: torch.Tensor  # (G, 3)
    opacities: torch.Tensor  # (G,)
    radii: torch.Tensor  # (G,) float screen-space 3-sigma radius (0 if culled)
    valid: torch.Tensor  # (G,) bool
    # anisotropic cull data (binning.py): the ellipse's axis-aligned
    # half-extents and its minor-axis slab (ux, uy, half_width). The ellipse
    # {d^2_cov <= nsigma^2} lies inside bbox AND slab, so tiles outside
    # either can never see alpha >= 1/255
    extents: torch.Tensor  # (G, 2) float (hx, hy)
    minor: torch.Tensor  # (G, 3) float (ux, uy, slab half-width)


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(G, 3) linear scales + (G, 4) wxyz quats -> (G, 3, 3) covariance."""
    m = quaternion_to_matrix(quats) * scales[:, None, :]  # R @ diag(s)
    return m @ m.transpose(-1, -2)


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera: Camera,
    valid: Optional[torch.Tensor] = None,
    near: float = 0.2,
    blur: float = 0.3,
    sh_degree: int = 3,
) -> ProjectedGaussians:
    """Project gaussians into screen space.

    Args:
        means3d: (G, 3) world positions.
        scales: (G, 3) linear (post-exp) scales.
        quats: (G, 4) wxyz rotations (unnormalized ok).
        opacities: (G,) post-sigmoid opacities.
        sh_coeffs: (G, 3, K) SH color coefficients (K >= (sh_degree+1)^2).
        camera: Camera (its w2c is moved to the gaussians' device).
    """
    g = means3d.shape[0]
    dev = means3d.device
    if valid is None:
        valid = torch.ones(g, dtype=torch.bool, device=dev)

    w2c = camera.w2c.to(device=dev, dtype=means3d.dtype)
    w = w2c[:3, :3]
    t = w2c[:3, 3]
    p_cam = means3d @ w.T + t  # (G, 3)
    z = p_cam[:, 2]
    in_front = z > near
    zc = torch.clamp_min(z, near)  # clamped for stable math on culled points

    x_ndc = p_cam[:, 0] / zc
    y_ndc = p_cam[:, 1] / zc
    means2d = torch.stack(
        [camera.fx * x_ndc + camera.cx, camera.fy * y_ndc + camera.cy], dim=1
    )

    # camera-space covariance W (R S S^T R^T) W^T = M M^T, M = W R diag(s)
    m = (w @ quaternion_to_matrix(quats)) * scales[:, None, :]
    cov = m @ m.transpose(-1, -2)
    c00, c01, c02 = cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2]
    c11, c12, c22 = cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]

    # perspective Jacobian (2, 3) per gaussian; x/y clamped to a slightly
    # expanded frustum like 3DGS to tame off-screen gradients
    lim_x = 1.3 * camera.cx / camera.fx
    lim_y = 1.3 * camera.cy / camera.fy
    tx = torch.clamp(x_ndc, -lim_x, lim_x) * zc
    ty = torch.clamp(y_ndc, -lim_y, lim_y) * zc
    fx, fy = camera.fx, camera.fy
    j00 = fx / zc
    j02 = -fx * tx / (zc * zc)
    j11 = fy / zc
    j12 = -fy * ty / (zc * zc)
    # cov2d = J cov_cam J^T, J = [[j00, 0, j02], [0, j11, j12]]
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + blur
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + blur

    det = a * c - b * b
    det_safe = torch.clamp_min(det, 1e-12)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=1)

    mid = 0.5 * (a + c)
    eig_gap = torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
    lambda1 = mid + eig_gap
    # opacity-aware radius: alpha = op * exp(-r^2 / (2 lambda1)) drops below
    # the rasterizer's 1/255 cutoff at r = sqrt(2 ln(255 op)) sigma_max;
    # min with the classic 3-sigma bound
    nsig_cull = torch.sqrt(2.0 * torch.log(torch.clamp_min(255.0 * opacities, 1.001)))
    nsigma = torch.clamp_max(nsig_cull, 3.0)
    radii = torch.ceil(nsigma * torch.sqrt(torch.clamp_min(lambda1, 0.0)))
    # cull geometry must bound the EXACT alpha >= 1/255 contour (the only
    # cutoff the compositor applies): no 3-sigma cap. Per-axis extents of
    # that ellipse are nsig_cull * sqrt(diag(cov2d))
    extents = torch.ceil(
        nsig_cull[:, None] * torch.sqrt(torch.clamp_min(torch.stack([a, c], dim=1), 0.0))
    )
    # minor principal axis (eigenvalue lambda2) and its slab half-width;
    # exact (unclamped) gap. Eigenvector formula picked by conditioning;
    # isotropic splats fall back to the x-axis
    lambda2 = torch.clamp_min(
        mid - torch.sqrt(torch.clamp_min(mid * mid - det, 0.0)), 0.0
    )
    v1 = torch.stack([b, lambda2 - a], dim=1)
    v2 = torch.stack([lambda2 - c, b], dim=1)
    n1 = torch.sum(v1 * v1, dim=1)
    n2 = torch.sum(v2 * v2, dim=1)
    v = torch.where((n1 >= n2)[:, None], v1, v2)
    nv = torch.sqrt(torch.clamp_min(torch.maximum(n1, n2), 1e-20))
    x_axis = torch.tensor([[1.0, 0.0]], dtype=v.dtype, device=dev)
    u = torch.where((nv > 1e-8)[:, None], v / nv[:, None], x_axis)
    minor = torch.cat([u, (nsig_cull * torch.sqrt(lambda2) + 1e-3)[:, None]], dim=1)

    # view-dependent color
    cam_center = -w.T @ t
    dirs = means3d - cam_center
    dirs = dirs / (torch.linalg.norm(dirs, dim=1, keepdim=True) + 1e-8)
    colors = torch.clamp_min(sh_mod.eval_sh(sh_degree, sh_coeffs, dirs) + 0.5, 0.0)

    # alpha <= opacity everywhere, so op < 1/255 can never pass the
    # rasterizer's alpha cutoff: cull outright
    ok = valid & in_front & (det > 0.0) & (opacities >= 1.0 / 255.0)
    radii = torch.where(ok, radii, torch.zeros_like(radii))
    extents = torch.where(ok[:, None], extents, torch.zeros_like(extents))
    return ProjectedGaussians(
        means2d=means2d,
        depths=z,
        conics=conics,
        colors=colors,
        opacities=opacities,
        radii=radii,
        valid=ok,
        extents=extents,
        minor=minor,
    )
