"""Exact row-wise k-smallest selection (port of gaussreg_tpu/ops/select_k.py,
TPU kernel K3), and the mutual-top-k thresholds that the matching takes
from it in one fused launch.

`select_min_k` launches the CUDA kernel csrc/select_k.cu for CUDA tensors
and runs `select_min_k_plain` for CPU tensors. Semantics of the Pallas
kernel: values ascending, ties to the smaller flat position (the order of
lax.top_k(-x, k)). Precondition: inputs are finite. Unlike the Pallas
kernel, any width W works (no multiple-of-128 requirement).

`kth_largest_rows_cols` gives, for (P, W, W) scores, the k-th largest value
of every row and of every column of each patch: bit for bit what two
`select_min_k` calls on the negated scores and on their negated transpose
give at position k - 1, negated back. On a CUDA tensor it is one launch of
the second kernel of csrc/select_k.cu (W <= 192, k <= 4); on a CPU tensor
it runs `kth_largest_rows_cols_plain`, those two calls' plain versions.
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

FUSED_KERNEL = _cuda.register(
    "kth_largest_rows_cols",
    _cuda.CudaKernel(
        "select_k.cu",
        "gaussreg_kth_largest_rows_cols",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int],
    ),
)
# csrc/select_k.cu: the W x W tile in shared memory and 2W threads; the k
# best of a line in registers
FUSED_MAX_WIDTH = 192
FUSED_MAX_K = 4


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


def kth_largest_rows_cols_plain(scores: torch.Tensor, k: int):
    """Plain version: the two `select_min_k_plain` calls of the unfused path."""
    p, w, _ = scores.shape
    rows = -select_min_k_plain(-scores.reshape(p * w, w), k)[0][:, k - 1]
    cols = -select_min_k_plain(-scores.transpose(1, 2).reshape(p * w, w), k)[0][:, k - 1]
    return rows.reshape(p, w), cols.reshape(p, w)


def kth_largest_rows_cols(scores: torch.Tensor, k: int):
    """k-th largest value of every row and every column of (P, W, W) f32
    `scores` (finite). Returns (row_thr (P, W), col_thr (P, W)):
    row_thr[p, i] is the k-th largest of scores[p, i, :], col_thr[p, j] of
    scores[p, :, j]; ties count once per element."""
    if scores.dim() != 3 or scores.shape[1] != scores.shape[2]:
        raise ValueError(f"kth_largest_rows_cols: need (P, W, W) scores, got "
                         f"{tuple(scores.shape)}")
    p, w, _ = scores.shape
    if not 0 < k <= w:
        raise ValueError(f"kth_largest_rows_cols: need 0 < k <= W, got k={k}, W={w}")
    if scores.device.type == "cpu":
        return kth_largest_rows_cols_plain(scores, k)
    if w > FUSED_MAX_WIDTH or k > FUSED_MAX_K:
        raise ValueError(f"kth_largest_rows_cols: the kernel needs W <= {FUSED_MAX_WIDTH} and "
                         f"k <= {FUSED_MAX_K}, got W={w}, k={k}")
    scores = scores.contiguous()
    _cuda.check_cuda_tensor(scores, "scores", torch.float32, 3)
    row_thr = torch.empty((p, w), dtype=torch.float32, device=scores.device)
    col_thr = torch.empty((p, w), dtype=torch.float32, device=scores.device)
    if p:
        FUSED_KERNEL.launch(scores.data_ptr(), row_thr.data_ptr(), col_thr.data_ptr(), p, w, k)
    return row_thr, col_thr
