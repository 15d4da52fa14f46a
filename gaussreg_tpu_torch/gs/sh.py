"""Real spherical harmonics: evaluation and rotation of 3DGS SH color
coefficients (port of gaussreg_tpu/gs/sh.py).

`eval_sh` is plain arithmetic and takes numpy arrays (the host front end)
or torch tensors (the renderer, with gradient) alike. The per-band rotation
is the least-squares fit of the JAX package, with the same fixed direction
sets and pseudo-inverses, so the operators equal the JAX ones.
"""

from __future__ import annotations

import numpy as np
import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def eval_sh(deg: int, sh, dirs):
    """Evaluate SH up to degree `deg` (0..4) at unit `dirs`.

    Args:
        deg: static int.
        sh: (..., C, (deg+1)**2) coefficients.
        dirs: (..., 3) unit directions (broadcastable against sh's batch dims).

    Returns: (..., C)

    reference: geotransformer/utils/graphics_utils.py:34-89.
    """
    assert 0 <= deg <= 4
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4]
                + C2[1] * yz * sh[..., 5]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + C2[3] * xz * sh[..., 7]
                + C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                    + C3[1] * xy * z * sh[..., 10]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                    + C3[5] * z * (xx - yy) * sh[..., 14]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15]
                )
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * sh[..., 16]
                        + C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                        + C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                        + C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                        + C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                        + C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                        + C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                        + C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                        + C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)) * sh[..., 24]
                    )
    return result


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5


def _band_columns(band: int, x, y, z):
    """The 2*band+1 basis functions of one SH band at directions (x, y, z)."""
    if band == 1:
        return [-C1 * y, C1 * z, -C1 * x]
    xx, yy, zz = x * x, y * y, z * z
    if band == 2:
        return [
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z,
            C2[4] * (xx - yy),
        ]
    if band == 3:
        return [
            C3[0] * y * (3 * xx - yy),
            C3[1] * x * y * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    raise ValueError(band)


# Fixed deterministic unit directions, overdetermined (2x the band dim) so
# the least-squares fit is well conditioned for every band.
def _fixed_dirs(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(k, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


_DIRS = {1: _fixed_dirs(8, 11), 2: _fixed_dirs(12, 22), 3: _fixed_dirs(16, 33)}
# pseudo-inverses of the (num_dirs, band_dim) basis matrices
_PINV = {
    band: np.linalg.pinv(
        np.stack(_band_columns(band, d[:, 0], d[:, 1], d[:, 2]), axis=-1).astype(np.float32)
    )
    for band, d in _DIRS.items()
}


def band_rotation_operators(rotation: torch.Tensor):
    """Per-band SH rotation operators M_b (k_b x k_b) such that rotated
    coefficients are c' = c @ M_b: M = pinv(Y(dirs)) @ Y(R dirs). Exact for
    band-limited SH; differentiable in `rotation`."""
    ops = {}
    for band in (1, 2, 3):
        dirs = torch.as_tensor(_DIRS[band], dtype=rotation.dtype, device=rotation.device)
        d = dirs @ rotation.T
        y_rot = torch.stack(_band_columns(band, d[:, 0], d[:, 1], d[:, 2]), dim=-1)
        pinv = torch.as_tensor(_PINV[band], dtype=rotation.dtype, device=rotation.device)
        ops[band] = pinv @ y_rot
    return ops


def rotate_sh_rest(f_rest: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Rotate the non-DC SH coefficients of 3DGS gaussians.

    f_rest: (N, 3, 15) bands 1..3 coefficients (3DGS layout); rotation:
    (3, 3) rotation applied to the scene. Returns (N, 3, 15)."""
    ops = band_rotation_operators(rotation)
    return torch.cat(
        [f_rest[..., 0:3] @ ops[1], f_rest[..., 3:8] @ ops[2], f_rest[..., 8:15] @ ops[3]],
        dim=-1,
    )
