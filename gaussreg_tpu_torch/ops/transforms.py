"""SE(3)+scale transform algebra (port of gaussreg_tpu/ops/transforms.py).

A "transform" is a (..., 4, 4) matrix whose top-left 3x3 block may carry an
isotropic scale (s*R). All functions are plain tensor code, batched over
leading dims and differentiable; quaternions are scalar-first (wxyz), as in
3DGS .ply files.
"""

from __future__ import annotations

import torch


def apply_transform(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) or batched (..., 4, 4) transform to (..., N, 3) points
    (points @ R^T + t)."""
    rotation = transform[..., :3, :3]
    translation = transform[..., :3, 3]
    if transform.dim() == 2:
        return points @ rotation.T + translation
    return torch.einsum("...ij,...nj->...ni", rotation, points) + translation[..., None, :]


def transform_from_rotation_translation(
    rotation: torch.Tensor, translation: torch.Tensor
) -> torch.Tensor:
    """Compose (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch_shape = rotation.shape[:-2]
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype, device=rotation.device
    ).expand(batch_shape + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotation_translation_scale_from_transform(transform: torch.Tensor):
    """Decompose a similarity transform into (R, t, s); s = norm of the first
    row of the 3x3 block."""
    a = transform[..., :3, :3]
    scale = torch.sqrt(torch.sum(a[..., 0, :] * a[..., 0, :], dim=-1))
    rotation = a / scale[..., None, None]
    translation = transform[..., :3, 3] / scale[..., None]
    return rotation, translation, scale


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """so(3) exponential map, gradient-safe at omega = 0 (Taylor branch for
    the sinc-style coefficients)."""
    a2 = torch.sum(omega * omega, dim=-1)
    small = a2 < 1e-8
    # the exact branch is evaluated at a safe point where it is not taken, so
    # its gradient cannot put inf * 0 = NaN through the where
    a2_safe = torch.where(small, torch.ones_like(a2), a2)
    a = torch.sqrt(a2_safe)
    c1 = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    c2 = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / a2_safe)
    k = skew_symmetric(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return eye + c1[..., None, None] * k + c2[..., None, None] * (k @ k)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3). Handles unnormalized input."""
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    rows = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return rows.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz quaternion, picking the best-conditioned
    of the four candidate solutions."""
    f = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [f[..., i] for i in range(9)]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    # sqrt only ever sees values >= 1e-10: a candidate whose square is
    # negative or zero (a branch not taken) gets the value 0 and, through the
    # clamp, a zero gradient instead of NaN or inf
    q_abs = torch.where(
        q_abs_sq > 1e-10,
        torch.sqrt(torch.clamp_min(q_abs_sq, 1e-10)),
        torch.zeros_like(q_abs_sq),
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4 components)
    candidates = quat_by_rijk / (2.0 * torch.clamp_min(q_abs, 0.1)[..., None])
    best = torch.argmax(q_abs, dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(candidates, -2, index)[..., 0, :]


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (..., 4) x (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
