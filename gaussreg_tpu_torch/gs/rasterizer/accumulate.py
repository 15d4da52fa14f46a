"""Per-gaussian gradient accumulation (port of
gaussreg_tpu/gs/rasterizer/accumulate.py, TPU kernel K6).

The backward (K5) writes one private 16-float gradient row per (tile,
pair) into a compacted buffer: tile t's walked chunks occupy compacted
blocks [offs[t], offs[t+1]). d_gdata[g] is the sum of gaussian g's rows.

`accumulate_pairs` finds a gaussian's rows through a pair table inverted
from the binning's sort (binning.py: `slot_positions`, `row_gid`) instead
of sorting the buffer's ids: slot s of row r holds the sorted position p
of that pair; its tile t
is the one whose range [starts[t], starts[t+1]) holds p, and the pair's
compacted row is (offs[t] - starts[t] // 128) * 128 + p when its chunk
k = p // 128 - starts[t] // 128 was walked (k < offs[t+1] - offs[t]).
Slots rise with the tile id, so the rows are added in the order of their
compacted rows: the order in which a stable sort of the buffer's ids would
add them, and in which a sequential `index_add_` does. Rows a gaussian owns
only through a neighbouring tile's copy of a shared boundary block are
exact +0.0 and are skipped, which leaves an f32 sum that starts at +0.0
unchanged. So the result equals `segment_accumulate_plain` on the compacted
ids (`kernels.compacted_gids`) bit for bit.

CUDA tensors launch csrc/segment_accumulate.cu; CPU tensors take
`accumulate_pairs_plain`. `segment_accumulate_plain` (the function of the
TPU kernel on (rows, ids)) is the oracle of the tests and of chip_smoke.py.

`segment_accumulate(rows, gid, num_out)` is the TPU kernel's own
signature: on a CUDA tensor the second entry of csrc/segment_accumulate.cu,
a counting sort over the known id range [0, num_out) with each run's row
order restored before its sum (count, scan, place, then a half-warp per
output that sorts its run's row indices and adds the rows in that order;
runs past 32 rows go to a block), so no general sort and no search; one
launch counted per call. On a CPU tensor `segment_accumulate_plain`. The
two are equal bit for bit, and repeated calls too: the atomics' order does
not reach the sum. The render path keeps `accumulate_pairs`.
"""

from __future__ import annotations

import ctypes

import torch

from gaussreg_tpu_torch.ops import _cuda

NCHAN = 16
CHUNK = 128
SCAN_TILE = 2048  # counts per tile of the generic entry's scan (kScanTile)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
KERNEL = _cuda.register(
    "segment_accumulate",
    _cuda.CudaKernel(
        "segment_accumulate.cu",
        "gaussreg_accumulate_pairs",
        # grad_rows, slot_pos, row_gid, starts, offs, out, num_out, n_rows,
        # mt, num_tiles, cap
        [_PTR] * 6 + [_INT] * 5,
    ),
)

GENERIC_KERNEL = _cuda.register(
    "segment_accumulate_generic",
    _cuda.CudaKernel(
        "segment_accumulate.cu",
        "gaussreg_segment_accumulate",
        # rows, gid, out, scratch, scratch_len, num_out, n
        [_PTR] * 4 + [ctypes.c_longlong] + [_INT] * 2,
    ),
)


def segment_accumulate_plain(rows: torch.Tensor, gid: torch.Tensor, num_out: int):
    """out[g] = sum of rows[i] where gid[i] == g, by `index_add_` into
    zeros (sequential, in row order, on the CPU); ids outside [0, num_out)
    land on an extra row that is cut off."""
    idx = torch.where((gid >= 0) & (gid < num_out), gid, torch.full_like(gid, num_out))
    out = torch.zeros((num_out + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, idx.long(), rows)[:num_out]


def pair_rows(slot_pos, starts, offs, cap: int):
    """(row (n_rows, mt) int64, valid (n_rows, mt) bool): the compacted
    gradient row of every slot, and whether the backward wrote it."""
    num_tiles = starts.shape[0] - 1
    p = slot_pos.long()
    st, of = starts.long(), offs.long()
    valid = p < torch.clamp_max(st[-1], cap)
    p = torch.where(valid, p, torch.zeros_like(p))
    t = torch.clamp_max(torch.searchsorted(st[1:].contiguous(), p, right=True), num_tiles - 1)
    blk0 = torch.div(st[t], CHUNK, rounding_mode="floor")
    valid = valid & (torch.div(p, CHUNK, rounding_mode="floor") - blk0 < of[t + 1] - of[t])
    return (of[t] - blk0) * CHUNK + p, valid


def accumulate_pairs_plain(grad_rows, slot_pos, row_gid, starts, offs, cap: int, num_out: int):
    """Plain version: every row's slots in slot order,
    acc = acc + where(valid, grad_rows[row], 0), written to out[row_gid]."""
    row, valid = pair_rows(slot_pos, starts, offs, cap)
    row = torch.where(valid, row, torch.zeros_like(row))
    acc = torch.zeros((slot_pos.shape[0], NCHAN), dtype=grad_rows.dtype, device=grad_rows.device)
    for s in range(slot_pos.shape[1]):
        acc = acc + torch.where(valid[:, s, None], grad_rows[row[:, s]], 0.0)
    out = torch.zeros((num_out, NCHAN), dtype=grad_rows.dtype, device=grad_rows.device)
    out[row_gid.long()] = acc
    return out


def accumulate_pairs(grad_rows, slot_pos, row_gid, starts, offs, cap: int, num_out: int):
    """d_gdata (num_out, 16) f32: out[row_gid[r]] = sum of the compacted
    rows of row r's pairs, in slot order; every other row zero.

    grad_rows: (bwd_blocks * 128, 16) f32 (K5's buffer); slot_pos
    (n_rows, mt) and row_gid (n_rows,) int32, the pair table; starts
    (num_tiles + 1,) int32 tile element offsets; offs (num_tiles + 1,)
    int32 compacted block offsets; cap: the pair list's capacity."""
    n_rows = slot_pos.shape[0] if slot_pos.dim() == 2 else -1
    if (grad_rows.dim() != 2 or grad_rows.shape[1] != NCHAN or n_rows < 0
            or row_gid.shape != (n_rows,) or offs.shape != starts.shape):
        raise ValueError(
            f"accumulate_pairs: grad_rows {tuple(grad_rows.shape)}, slot_pos "
            f"{tuple(slot_pos.shape)}, row_gid {tuple(row_gid.shape)}, starts "
            f"{tuple(starts.shape)}, offs {tuple(offs.shape)}: expected (R, {NCHAN}), "
            "(n_rows, mt), (n_rows,) and two (num_tiles + 1,)"
        )
    if grad_rows.device.type == "cpu":
        return accumulate_pairs_plain(grad_rows, slot_pos, row_gid, starts, offs, cap, num_out)
    _cuda.check_cuda_tensor(grad_rows, "grad_rows", torch.float32, 2)
    _cuda.check_cuda_tensor(slot_pos, "slot_pos", torch.int32, 2)
    for t, name in ((row_gid, "row_gid"), (starts, "starts"), (offs, "offs")):
        _cuda.check_cuda_tensor(t, name, torch.int32, 1)
    # the launch zeroes `out` before it adds (one call, no separate fill)
    out = torch.empty((num_out, NCHAN), dtype=torch.float32, device=grad_rows.device)
    KERNEL.launch(
        grad_rows.data_ptr(), slot_pos.data_ptr(), row_gid.data_ptr(), starts.data_ptr(),
        offs.data_ptr(), out.data_ptr(), num_out, n_rows, slot_pos.shape[1],
        starts.shape[0] - 1, cap,
    )
    return out


def segment_accumulate(rows: torch.Tensor, gid: torch.Tensor, num_out: int):
    """out (num_out, 16) f32: out[g] = the sum of rows[i] with gid[i] == g,
    added in row order; ids outside [0, num_out) are dropped.

    rows: (R, 16) f32; gid: (R,) int32, in any order."""
    if rows.dim() != 2 or rows.shape[1] != NCHAN or gid.shape != rows.shape[:1]:
        raise ValueError(f"segment_accumulate: rows {tuple(rows.shape)}, gid "
                         f"{tuple(gid.shape)}: expected (R, {NCHAN}) and (R,)")
    if num_out <= 0:
        raise ValueError(f"segment_accumulate: num_out must be positive, got {num_out}")
    if rows.device.type == "cpu":
        return segment_accumulate_plain(rows, gid, num_out)
    rows = rows.contiguous()
    _cuda.check_cuda_tensor(rows, "rows", torch.float32, 2)
    _cuda.check_cuda_tensor(gid, "gid", torch.int32, 1)
    if rows.data_ptr() % 16:  # the kernel reads rows in 16-byte pieces
        rows = rows.clone()
    n, m = rows.shape[0], num_out + 1
    # the scan's status words (two int32 per tile) and tile counter, the
    # counts, the starts and the order list; the launch zeroes what it needs
    scratch = torch.empty(2 * -(-m // SCAN_TILE) + 2 + 2 * m + n, dtype=torch.int32,
                          device=rows.device)
    out = torch.empty((num_out, NCHAN), dtype=torch.float32, device=rows.device)
    GENERIC_KERNEL.launch(rows.data_ptr(), gid.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                          scratch.numel(), num_out, n)
    return out
