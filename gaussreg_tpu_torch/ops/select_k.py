"""Exact row-wise k-smallest selection (port of gaussreg_tpu/ops/select_k.py,
TPU kernel K3).

`select_min_k` launches the CUDA kernel csrc/select_k.cu for CUDA tensors
and runs `select_min_k_plain` for CPU tensors. Semantics of the Pallas
kernel: values ascending, ties to the smaller flat position (the order of
lax.top_k(-x, k)). Precondition: inputs are finite. Unlike the Pallas
kernel, any width W works (no multiple-of-128 requirement).
"""

from __future__ import annotations

import ctypes

import torch

from gaussreg_tpu_torch.ops import _cuda

KERNEL = _cuda.register(
    "select_min_k",
    _cuda.CudaKernel(
        "select_k.cu",
        "gaussreg_select_min_k",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int],
    ),
)


def select_min_k_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version: a stable ascending sort, first k columns."""
    vals, pos = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], pos[:, :k].to(torch.int32)


def select_min_k(x: torch.Tensor, k: int):
    """Row-wise k smallest of `x` (R, W) f32.

    Returns (vals (R, k) ascending, pos (R, k) int32 flat positions)."""
    r, w = x.shape
    if not 0 < k <= w:
        raise ValueError(f"select_min_k: need 0 < k <= W, got k={k}, W={w}")
    if x.device.type == "cpu":
        return select_min_k_plain(x, k)
    _cuda.check_cuda_tensor(x, "x", torch.float32, 2)
    vals = torch.empty((r, k), dtype=torch.float32, device=x.device)
    pos = torch.empty((r, k), dtype=torch.int32, device=x.device)
    KERNEL.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), r, w, k)
    return vals, pos
