"""Fused window-search selection: d2 + validity + k-min + original-id
extraction (port of gaussreg_tpu/ops/fused_select.py, TPU kernel K1).

`window_select_idx` launches the CUDA kernel csrc/window_select.cu for CUDA
tensors and runs `window_select_plain` for CPU tensors. Both compute the
same function as the Pallas kernel: per row, the `limit` smallest d2 over
the candidates inside their run's local bounds [ls, le), ascending, ties to
the smaller flat (run-major) position, with the candidates' original
support ids; once the valid candidates are exhausted the remaining slots
hold (finfo(f32).max, win_idx[:, 0]), as the Pallas kernel emits them.
Precondition (as for the Pallas kernel): valid candidates have finite d2.
"""

from __future__ import annotations

import ctypes

import torch

from gaussreg_tpu_torch.ops import _cuda

_BIG_F = torch.finfo(torch.float32).max

KERNEL = _cuda.register(
    "window_select_idx",
    _cuda.CudaKernel(
        "window_select.cu",
        "gaussreg_window_select",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int],
    ),
)


def window_d2(q_xyz, win_x, win_y, win_z) -> torch.Tensor:
    """(P, W) squared distances, evaluated as (dx*dx + dy*dy) + dz*dz."""
    dx = win_x - q_xyz[:, 0:1]
    dy = win_y - q_xyz[:, 1:2]
    dz = win_z - q_xyz[:, 2:3]
    return dx * dx + dy * dy + dz * dz


def window_valid(lsle: torch.Tensor, nruns: int, wspan: int) -> torch.Tensor:
    """(P, W) bool: candidate offset inside its run's local [ls, le)."""
    lane = torch.arange(nruns * wspan, device=lsle.device)
    run = lane // wspan
    off = lane - run * wspan
    return (off >= lsle[:, run]) & (off < lsle[:, nruns + run])


def window_select_plain(q_xyz, lsle, win_x, win_y, win_z, win_idx, limit: int,
                        nruns: int, wspan: int):
    """The plain PyTorch version of the kernel (same signature/outputs)."""
    x = torch.where(
        window_valid(lsle, nruns, wspan), window_d2(q_xyz, win_x, win_y, win_z), _BIG_F
    )
    w = x.shape[1]
    if limit > w:
        x = torch.cat([x, x.new_full((x.shape[0], limit - w), _BIG_F)], dim=1)
    vals, pos = torch.sort(x, dim=1, stable=True)
    vals, pos = vals[:, :limit], pos[:, :limit]
    idx = torch.gather(win_idx, 1, torch.clamp_max(pos, w - 1))
    idx = torch.where(vals == _BIG_F, win_idx[:, :1], idx)
    return vals, idx


def window_select_idx(
    q_xyz: torch.Tensor,  # (P, S) f32, S >= 3: query x, y, z in cols 0..2
    lsle: torch.Tensor,  # (P, 2 * nruns) int32: local window starts | ends
    win_x: torch.Tensor,  # (P, nruns * wspan) f32 gathered candidate coords
    win_y: torch.Tensor,
    win_z: torch.Tensor,
    win_idx: torch.Tensor,  # (P, nruns * wspan) int32 original support ids
    limit: int,
    nruns: int,
    wspan: int,
):
    """Row-wise nearest-`limit` selection over windowed candidates.

    Returns (d2 (P, limit) f32 ascending, idx (P, limit) int32). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    p, w = win_x.shape
    if w != nruns * wspan or lsle.shape != (p, 2 * nruns) or q_xyz.shape[1] < 3:
        raise ValueError(
            f"window_select_idx: inconsistent shapes {tuple(q_xyz.shape)}, "
            f"{tuple(lsle.shape)}, {tuple(win_x.shape)}, nruns={nruns}, wspan={wspan}"
        )
    if win_x.device.type == "cpu":
        return window_select_plain(
            q_xyz, lsle, win_x, win_y, win_z, win_idx, limit, nruns, wspan
        )
    for name, t, dt in (("q_xyz", q_xyz, torch.float32), ("lsle", lsle, torch.int32),
                        ("win_x", win_x, torch.float32), ("win_y", win_y, torch.float32),
                        ("win_z", win_z, torch.float32), ("win_idx", win_idx, torch.int32)):
        _cuda.check_cuda_tensor(t, name, dt, 2)
    d2 = torch.empty((p, limit), dtype=torch.float32, device=win_x.device)
    idx = torch.empty((p, limit), dtype=torch.int32, device=win_x.device)
    KERNEL.launch(
        q_xyz.data_ptr(), q_xyz.shape[1], lsle.data_ptr(), win_x.data_ptr(),
        win_y.data_ptr(), win_z.data_ptr(), win_idx.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), p, nruns, wspan, limit,
    )
    return d2, idx
