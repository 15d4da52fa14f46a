"""Exact row-wise k-smallest selection (port of gaussreg_tpu/ops/select_k.py,
TPU kernel K3), and the mutual-top-k thresholds that the matching takes
from it in one fused launch.

`select_min_k` launches a CUDA kernel of csrc/select_k.cu for CUDA tensors
and runs `select_min_k_plain` for CPU tensors. Semantics of the Pallas
kernel: values ascending, ties to the smaller flat position (the order of
lax.top_k(-x, k)). Precondition: inputs are finite. Unlike the Pallas
kernel, any width W works (no multiple-of-128 requirement), and any
0 < k <= W. Two designs: the threshold filter (a row streamed once with
per-lane queues and a warp merge, no shared-memory copy of the row and so
no width or k limit) in two forms, and for large k a radix select.
`route(w, k, rows)` picks one of the three before the launch, and each
counts its own launches:

- `select_min_k_radix`: the radix select, one block per row (the row
  staged in shared memory, digit histograms to the k-th key, a bitonic
  sort of the k keys), where it fits in shared memory (`radix_fits`) and
  k >= RADIX_ANY_WIDTH_K, or k >= RADIX_MIN_K on rows of at most
  RADIX_MAX_WIDTH columns: the filter pays about k rounds a row and lost
  to torch.topk there;
- `select_min_k`: the filter, one warp per row, any k (round j's key
  waits in a lane until the warp stores 32 of them);
- `select_min_k_wide`: the filter, one block of FILTER_WIDE_WARPS warps
  per row (one launch, no scratch), for few long rows: k <=
  FILTER_WIDE_MAX_K and W >= FILTER_WIDE_MIN_WIDTH per FILTER_WIDE_ROWS
  rows (at least FILTER_WIDE_MIN_WIDTH). One warp per row leaves the card
  short of warps when rows are few and long; the wide form's merge and
  extra rounds cost more as k grows, and lose wherever the rows alone
  fill the card. Its slices' lists sit in shared memory,
  FILTER_WIDE_WARPS * k * 8 bytes, so the kernel takes it up to
  k = FILTER_WIDE_LIST_MAX_K.

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
RADIX_KERNEL = _cuda.register(
    "select_min_k_radix",
    _cuda.CudaKernel("select_k.cu", "gaussreg_select_min_k_radix", [_P, _P, _P, _I, _I, _I]))
ROUTES = {"select_min_k": KERNEL, "select_min_k_wide": WIDE_KERNEL,
          "select_min_k_radix": RADIX_KERNEL}
FUSED_KERNEL = _cuda.register(
    "kth_largest_rows_cols",
    _cuda.CudaKernel("select_k.cu", "gaussreg_kth_largest_rows_cols", [_P, _P, _P, _I, _I, _I]))

# csrc/select_k.cu: the filter's wide form, a block of FILTER_WIDE_WARPS
# warps per row (kBlockWarps) and their lists in 200 KiB of shared memory
# (kWideMaxK). When the wide form pays: tools/select_variants.py's sweep of
# both forms over R in {1 024 ... 30 720} rows, W in {2 304 ... 30 720}
# columns, k in {3, 35, 89} (PERF.md §6): it wins from 8 192 columns at
# 1 024 rows (k <= 35), from 16 384 at 2 048, and by at most 11 % past
# that; at k = 89 it loses up to 20 480 columns even at 1 024 rows
FILTER_WIDE_WARPS = 4
FILTER_WIDE_LIST_MAX_K = 200 * 1024 // (FILTER_WIDE_WARPS * 8)
FILTER_WIDE_MAX_K = 48  # the filter's 4-key lane queues (kSmallQueueMaxK)
FILTER_WIDE_MIN_WIDTH = 8192
FILTER_WIDE_ROWS = 1024
# csrc/select_k.cu's radix entry: a row's 4-byte ordered bits (padded to
# 16 bytes) and its k keys, padded to a power of two, in 200 KiB of shared
# memory (kMaxSmem). When it pays: tools/select_variants.py's sweep of the
# radix entry against the filter over R in {1 024, 4 096, 30 720} rows,
# W in {2 304 ... 30 720} columns, k in {129, 192, 256, 384, 700, 2 048}
# (PERF.md §6): it wins at every swept point from k = 700 on, and from
# k = 256 on up to 12 288 columns; the filter wins at k <= 192 past 6 144
# columns and at k = 256-384 past 16 384
RADIX_MAX_SMEM = 200 * 1024
RADIX_MIN_K = 256
RADIX_MAX_WIDTH = 12_288  # below RADIX_ANY_WIDTH_K
RADIX_ANY_WIDTH_K = 700

# csrc/select_k.cu: the W x W tile in shared memory and 2W threads; the k
# best of a line in registers
FUSED_MAX_WIDTH = 192
FUSED_MAX_K = 4


def route(w: int, k: int, rows: int) -> str:
    """The kernel (a name of ROUTES) that `select_min_k` launches for `rows`
    rows of width w and this k; raises for k outside (0, W]."""
    if not 0 < k <= w:
        raise ValueError(f"select_min_k: need 0 < k <= W, got k={k}, W={w}")
    if radix_fits(w, k) and (k >= RADIX_ANY_WIDTH_K or (k >= RADIX_MIN_K and w <= RADIX_MAX_WIDTH)):
        return "select_min_k_radix"
    wide = (k <= FILTER_WIDE_MAX_K and
            w * FILTER_WIDE_ROWS >= FILTER_WIDE_MIN_WIDTH * max(rows, FILTER_WIDE_ROWS))
    return "select_min_k_wide" if wide else "select_min_k"


def radix_fits(w: int, k: int) -> bool:
    """Whether the radix entry's block holds a row of width w and its k
    keys in shared memory."""
    return (w + 3) // 4 * 16 + (1 << (k - 1).bit_length()) * 8 <= RADIX_MAX_SMEM


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
    if name == "select_min_k_radix":
        RADIX_KERNEL.launch(*ptrs, r, w, k)
    else:
        ROUTES[name].launch(*ptrs, r, w, k, int(name == "select_min_k_wide"))
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
