"""Per-gaussian gradient accumulation as a segment sum (port of
gaussreg_tpu/gs/rasterizer/accumulate.py, TPU kernel K6).

out[g] = sum of rows[i] where gid[i] == g, an exact f32 sum in row order.
`segment_accumulate` sorts the ids stably (outside the kernel, as the JAX
package sorts outside its Pallas call), finds every output row's run with
`searchsorted`, and launches csrc/segment_accumulate.cu for CUDA tensors:
a half-warp per output row walks its run in sorted order and gathers each
source row through the sort's index. The order of addition is fixed by the
stable sort, so two runs give the same bits, and the result equals a
sequential scatter-add. CPU tensors take `segment_accumulate_plain`
(`index_add_` into zeros). Rows whose id lies outside [0, num_out) are
dropped, as the Pallas kernel's one-hot product drops them.
"""

from __future__ import annotations

import ctypes

import torch

from gaussreg_tpu_torch.ops import _cuda

NCHAN = 16

KERNEL = _cuda.register(
    "segment_accumulate",
    _cuda.CudaKernel(
        "segment_accumulate.cu",
        "gaussreg_segment_accumulate",
        # rows, order, bounds, out, num_out
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
    ),
)


def segment_accumulate_plain(rows: torch.Tensor, gid: torch.Tensor, num_out: int):
    """Plain PyTorch version: `index_add_` into zeros; ids outside
    [0, num_out) land on an extra row that is cut off."""
    idx = torch.where((gid >= 0) & (gid < num_out), gid, torch.full_like(gid, num_out))
    out = torch.zeros((num_out + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, idx.long(), rows)[:num_out]


def segment_accumulate(rows: torch.Tensor, gid: torch.Tensor, num_out: int) -> torch.Tensor:
    """out[g] = sum of rows[i] where gid[i] == g.

    rows: (R, 16) f32 gradient rows; gid: (R,) int32 target row per
    gradient row (may be unsorted); num_out: output rows (G + 1 with the
    sentinel row). Returns (num_out, 16) f32."""
    if rows.dim() != 2 or rows.shape[1] != NCHAN or gid.shape != (rows.shape[0],):
        raise ValueError(
            f"segment_accumulate: rows {tuple(rows.shape)} / gid {tuple(gid.shape)}, "
            f"expected (R, {NCHAN}) and (R,)"
        )
    if rows.device.type == "cpu":
        return segment_accumulate_plain(rows, gid, num_out)
    _cuda.check_cuda_tensor(rows, "rows", torch.float32, 2)
    _cuda.check_cuda_tensor(gid, "gid", torch.int32, 1)
    order, bounds = sorted_runs(gid, num_out)
    return accumulate_runs(rows, order, bounds, num_out)


def sorted_runs(gid: torch.Tensor, num_out: int):
    """(order (R,) int32, bounds (num_out + 1,) int32): the stable sort's
    index and every output row's run [bounds[g], bounds[g + 1]) in it."""
    # stable: rows of one gaussian keep their buffer order, so the f32
    # addition order does not depend on the buffer's capacity
    gid_s, order = torch.sort(gid, stable=True)
    probes = torch.arange(num_out + 1, dtype=torch.int32, device=gid.device)
    bounds = torch.searchsorted(gid_s, probes).to(torch.int32)
    return order.to(torch.int32), bounds


def accumulate_runs(rows, order, bounds, num_out: int) -> torch.Tensor:
    """The kernel launch alone, on CUDA tensors: out[g] = sum of
    rows[order[i]] for i in [bounds[g], bounds[g + 1]), added in that order."""
    out = torch.empty((num_out, NCHAN), dtype=torch.float32, device=rows.device)
    if num_out:
        KERNEL.launch(
            rows.data_ptr(), order.data_ptr(), bounds.data_ptr(), out.data_ptr(), num_out
        )
    return out
