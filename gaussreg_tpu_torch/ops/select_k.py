"""Exact row-wise k-smallest selection (port of gaussreg_tpu/ops/select_k.py,
TPU kernel K3), and the mutual-top-k thresholds that the matching takes
from it in one fused launch.

`select_min_k` launches a CUDA kernel of csrc/select_k.cu for CUDA tensors
and runs `select_min_k_plain` for CPU tensors. Semantics of the Pallas
kernel: values ascending, ties to the smaller flat position (the order of
lax.top_k(-x, k)). Precondition: inputs are finite. Unlike the Pallas
kernel, any width W works (no multiple-of-128 requirement). The kernel is
chosen by `route(w, k, rows)` before the launch, and each route counts its
own launches:

- k <= FILTER_MAX_K (128; every neighbour limit of the paths): the
  threshold filter, a row streamed once with per-lane queues and a warp
  merge, no shared-memory copy of the row and so no width limit.
  `select_min_k` takes one warp per row; `select_min_k_wide` one block of
  FILTER_WIDE_WARPS warps per row (one launch, no scratch), for few long
  rows: k <= FILTER_WIDE_MAX_K and W >= FILTER_WIDE_MIN_WIDTH per
  FILTER_WIDE_ROWS rows (at least FILTER_WIDE_MIN_WIDTH). One warp per
  row leaves the card short of warps when rows are few and long; the
  wide form's merge and extra rounds cost more as k grows, and lose
  wherever the rows alone fill the card.
- k > 128: the selection rounds over a row's keys in shared memory,
  `select_min_k_rounds` up to WIDE_MIN_WIDTH - 1 = 25 600 columns (8-byte
  keys in 200 KiB), `select_min_k_rounds_wide` past that (the k smallest of
  each WIDE_CHUNK-column chunk into a scratch buffer, then of the chunk
  winners), which needs ceil(W / WIDE_CHUNK) * k * 8 <= 200 KiB.

`kth_largest_rows_cols` gives, for (P, W, W) scores, the k-th largest value
of every row and of every column of each patch: bit for bit what two
`select_min_k` calls on the negated scores and on their negated transpose
give at position k - 1, negated back. On a CUDA tensor it is one launch of
the fused kernel of csrc/select_k.cu (W <= 192, k <= 4); on a CPU tensor
it runs `kth_largest_rows_cols_plain`, those two calls' plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from gaussreg_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_FILTER_ARGS = [_P, _P, _P, _I, _I, _I, _I]  # x, vals, pos, rows, w, k, wide
KERNEL = _cuda.register(
    "select_min_k", _cuda.CudaKernel("select_k.cu", "gaussreg_select_min_k_filter", _FILTER_ARGS))
WIDE_KERNEL = _cuda.register(
    "select_min_k_wide",
    _cuda.CudaKernel("select_k.cu", "gaussreg_select_min_k_filter", _FILTER_ARGS))
ROUNDS_KERNEL = _cuda.register(
    "select_min_k_rounds",
    _cuda.CudaKernel("select_k.cu", "gaussreg_select_min_k_rounds", [_P, _P, _P, _I, _I, _I]))
ROUNDS_WIDE_KERNEL = _cuda.register(
    "select_min_k_rounds_wide",
    _cuda.CudaKernel("select_k.cu", "gaussreg_select_min_k_rounds_wide",
                     [_P, _P, _P, _P, _I, _I, _I]))
ROUTES = {"select_min_k": KERNEL, "select_min_k_wide": WIDE_KERNEL,
          "select_min_k_rounds": ROUNDS_KERNEL, "select_min_k_rounds_wide": ROUNDS_WIDE_KERNEL}
FUSED_KERNEL = _cuda.register(
    "kth_largest_rows_cols",
    _cuda.CudaKernel("select_k.cu", "gaussreg_kth_largest_rows_cols", [_P, _P, _P, _I, _I, _I]))

# csrc/select_k.cu: the filter's queues (kFilterMaxK); its wide form's
# block of FILTER_WIDE_WARPS warps per row (kBlockWarps). When the wide
# form pays: tools/select_variants.py's sweep of both forms over R in
# {1 024 ... 30 720} rows, W in {2 304 ... 30 720} columns, k in {3, 35,
# 89} (PERF.md §6): it wins from 8 192 columns at 1 024 rows (k <= 35),
# from 16 384 at 2 048, and by at most 11 % past that; at k = 89 it loses
# up to 20 480 columns even at 1 024 rows
FILTER_MAX_K = 128
FILTER_WIDE_WARPS = 4
FILTER_WIDE_MAX_K = 48  # the filter's 4-key lane queues (kSmallQueueMaxK)
FILTER_WIDE_MIN_WIDTH = 8192
FILTER_WIDE_ROWS = 1024
# the rounds: a row's 8-byte keys in at most 200 KiB of shared memory
# (kMaxSmem); wider rows in chunks of WIDE_CHUNK columns, whose
# nchunks * k winners must fit there too
_MAX_SMEM = 200 * 1024
WIDE_MIN_WIDTH = _MAX_SMEM // 8 + 1
WIDE_CHUNK = 2048

# csrc/select_k.cu: the W x W tile in shared memory and 2W threads; the k
# best of a line in registers
FUSED_MAX_WIDTH = 192
FUSED_MAX_K = 4


def route(w: int, k: int, rows: int) -> str:
    """The kernel (a name of ROUTES) that `select_min_k` launches for `rows`
    rows of width w and this k; raises where no kernel takes them."""
    if not 0 < k <= w:
        raise ValueError(f"select_min_k: need 0 < k <= W, got k={k}, W={w}")
    if k <= FILTER_MAX_K:
        wide = (k <= FILTER_WIDE_MAX_K and
                w * FILTER_WIDE_ROWS >= FILTER_WIDE_MIN_WIDTH * max(rows, FILTER_WIDE_ROWS))
        return "select_min_k_wide" if wide else "select_min_k"
    if w < WIDE_MIN_WIDTH:
        return "select_min_k_rounds"
    if -(-w // WIDE_CHUNK) * k * 8 > _MAX_SMEM:
        raise ValueError(f"select_min_k: the rounds' wide mode needs ceil(W / {WIDE_CHUNK}) * k * "
                         f"8 <= 200 KiB, got W={w}, k={k}")
    return "select_min_k_rounds_wide"


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
    name = route(w, k, r)
    vals = torch.empty((r, k), dtype=torch.float32, device=x.device)
    pos = torch.empty((r, k), dtype=torch.int32, device=x.device)
    if r == 0:
        return vals, pos
    ptrs = (x.data_ptr(), vals.data_ptr(), pos.data_ptr())
    if name == "select_min_k":
        KERNEL.launch(*ptrs, r, w, k, 0)
    elif name == "select_min_k_wide":
        WIDE_KERNEL.launch(*ptrs, r, w, k, 1)
    elif name == "select_min_k_rounds":
        ROUNDS_KERNEL.launch(*ptrs, r, w, k)
    else:
        cand = torch.empty((r, -(-w // WIDE_CHUNK) * k), dtype=torch.int64, device=x.device)
        ROUNDS_WIDE_KERNEL.launch(*ptrs, cand.data_ptr(), r, w, k)
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
