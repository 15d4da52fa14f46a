"""Fixed-capacity neighbor search (port of gaussreg_tpu/ops/neighbors.py).

Brute force (`radius_search`, `knn_search`): blockwise gram-form
distances |q|^2 - 2 q.s + |s|^2 and the k smallest per query row through
`select_min_k` (the CUDA kernel K3 on CUDA tensors: its threshold
filter for any k <= N, one warp per row, or one block per row for a block
of 1 024 queries against 8 192 support points or more at k <= 48; the plain
stable sort on CPU tensors), whose tie order (ties to the smaller index)
is lax.top_k's.

Grid-run pruned (`grid_radius_search`):

Supports are sorted by a linear cell key (cell == radius, z in the low bits)
so each query's 27-cell neighborhood is nine contiguous z-runs. Per query:
nine range probes (torch.searchsorted on the sorted keys; the JAX package
ranks them by a merge sort), an aligned window of 128-entry plane rows
covering each run, and a selection of the nearest `limit` candidates inside
the runs. Exact nearest-`limit` within the radius when no run overflows its
window; `overflow` counts run entries beyond the windows.

Selection branches: "auto" and "fused" run `window_select_runs` (the CUDA
kernel K1 on CUDA tensors, reading each query's runs in place from the
sorted planes, so no (B*M, nruns * wspan) window plane is made; its plain
version, which gathers them, on CPU tensors); "pallas",
the JAX package's legacy branch, runs `select_min_k` (K3) over each
query's (nruns * wspan) window distances and decodes the flat positions to
run and offset; "topk" is the JAX package's two-stage top-k branch, kept
as a plain path. All three give the same indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussreg_tpu_torch.ops.fused_select import window_select_runs
from gaussreg_tpu_torch.ops.select_k import select_min_k

_BIG = 1e12
_BITS = 10  # cell coords in [0, 1024); linear key x<<20 | y<<10 | z
_CW = 128  # window row width
_EMPTY_KEY = 0x3FFFFFFF  # invalid supports sort last


def _blocked_topk_dist(q_points, s_points, s_mask, k: int, block: int):
    """(sq_dists, indices) of the k nearest valid support points of every
    query row, `block` queries at a time. q (M, 3), s (N, 3) -> (M, k)."""
    s2 = torch.sum(s_points * s_points, dim=-1)
    s2 = torch.where(s_mask, s2, _f32(_BIG, s2))
    d2_parts, idx_parts = [], []
    for lo in range(0, q_points.shape[0], block):
        qb = q_points[lo:lo + block]
        d2 = torch.sum(qb * qb, dim=-1)[:, None] - 2.0 * qb @ s_points.T + s2[None, :]
        vals, idx = select_min_k(d2.contiguous(), k)
        d2_parts.append(vals)
        idx_parts.append(idx)
    if not d2_parts:
        empty = q_points.new_zeros((0, k))
        return empty, empty.to(torch.int32)
    return torch.clamp_min(torch.cat(d2_parts), 0.0), torch.cat(idx_parts)


def radius_search(q_points, s_points, q_mask, s_mask, radius, limit: int, block: int = 1024):
    """Nearest `limit` support points within `radius` of each query (brute
    force). q (M, 3), s (N, 3) -> (M, limit) int32 indices, sentinel N for
    missing neighbors and invalid queries."""
    n = s_points.shape[0]
    d2, idx = _blocked_topk_dist(q_points, s_points, s_mask, limit, block)
    rad = _f32(radius, s_points)
    ok = (d2 <= rad * rad) & q_mask[:, None]
    return torch.where(ok, idx, n).to(torch.int32)


def knn_search(q_points, s_points, q_mask, s_mask, k: int, block: int = 1024):
    """k nearest valid support points per query. Returns (indices (M, k)
    int32 with sentinel N, sq_dists (M, k)); invalid queries get
    all-sentinel rows."""
    n = s_points.shape[0]
    d2, idx = _blocked_topk_dist(q_points, s_points, s_mask, k, block)
    ok = (d2 < _BIG / 2) & q_mask[:, None]
    return torch.where(ok, idx, n).to(torch.int32), d2


def gather_padded(values: torch.Tensor, indices: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Rows of `values` (N, ...) at `indices` (...); the sentinel index N
    returns `fill`."""
    n = values.shape[0]
    out = values[torch.clamp_max(indices, n - 1).long()]
    sentinel = (indices == n).reshape(indices.shape + (1,) * (values.dim() - 1))
    return torch.where(sentinel, torch.as_tensor(fill, dtype=values.dtype,
                                                 device=values.device), out)


class _Runs(NamedTuple):
    order: torch.Tensor  # (B, N) int64 support permutation (sorted by cell)
    planes: tuple  # 3 x (B, R, CW) f32 sorted coordinate planes, far-padded
    order_plane: torch.Tensor  # (B, R, CW) int32 the permutation as a plane, zero-padded
    wrow: torch.Tensor  # (B, M, nruns) first window row of each run
    starts: torch.Tensor  # (B, M, nruns) int32 run start in sorted order
    ends: torch.Tensor  # (B, M, nruns) int32 run end (== start if dead)
    nruns: int
    overflow: torch.Tensor  # () int32


def _f32(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _grid_runs(q_points, s_points, q_mask, s_mask, radius, window_rows, cell_factor):
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    dev = s_points.device
    wspan = window_rows * _CW
    cmax = (1 << _BITS) - 1

    big = torch.finfo(s_points.dtype).max
    pmin = torch.where(s_mask[..., None], s_points, big).amin(dim=1, keepdim=True)
    rad = _f32(radius, s_points)
    cs = rad * cell_factor  # a device tensor: true division below

    def cellify(pts):
        return torch.clamp(torch.floor((pts - pmin) / cs).to(torch.int32), 0, cmax)

    s_cells = cellify(s_points)
    key = (s_cells[..., 0] << (2 * _BITS)) | (s_cells[..., 1] << _BITS) | s_cells[..., 2]
    key = torch.where(s_mask, key, torch.full_like(key, _EMPTY_KEY))
    # within-cell order: the JAX package sorts (key, tiebreak) with tiebreak
    # = uint32 hash of the index cast to SIGNED int32; one 64-bit key with
    # the hash offset by 2^31 (x ^ 0x80000000) gives the same order
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    tiebreak = ((iota * 2654435761) & 0xFFFFFFFF) ^ 0x80000000
    skey64, order = torch.sort((key.to(torch.int64) << 32) | tiebreak, dim=1, stable=True)
    skey = (skey64 >> 32).to(torch.int32).contiguous()
    svalid = torch.gather(s_mask, 1, order)

    nrow = (n + _CW - 1) // _CW
    r_tot = nrow + window_rows
    lpad = r_tot * _CW
    planes = []
    for a in range(3):
        pa = torch.gather(s_points[..., a], 1, order)
        pa = torch.where(svalid, pa, big)
        pa = torch.cat([pa, pa.new_full((b, lpad - n), big)], dim=1)
        planes.append(pa.reshape(b, r_tot, _CW))
    order_plane = torch.cat(
        [order.to(torch.int32), torch.zeros((b, lpad - n), dtype=torch.int32, device=dev)], dim=1
    ).reshape(b, r_tot, _CW)

    if cell_factor == 1.0:
        # radius-sized cells: 3x3 xy-neighborhood -> 9 z-runs per query
        q_cells = cellify(q_points)
        g = torch.arange(-1, 2, dtype=torch.int32, device=dev)
        dx = g.repeat_interleave(3)  # ij meshgrid order, run-major
        dy = g.repeat(3)
        cx = q_cells[..., 0:1] + dx
        cy = q_cells[..., 1:2] + dy
        z0 = torch.clamp_min(q_cells[..., 2:3] - 1, 0)
        z1 = torch.clamp_max(q_cells[..., 2:3] + 1, cmax)
        nruns = 9
    elif cell_factor >= 2.0:
        # cells of >= 2r: the ball spans at most two cells per axis starting
        # at floor((q - r)/cs) -> 2x2 columns, 2-cell z-window
        qraw = torch.floor((q_points - rad - pmin) / cs).to(torch.int32)
        g = torch.arange(0, 2, dtype=torch.int32, device=dev)
        dx = g.repeat_interleave(2)
        dy = g.repeat(2)
        cx = qraw[..., 0:1] + dx
        cy = qraw[..., 1:2] + dy
        z0 = torch.clamp(qraw[..., 2:3], 0, cmax)
        z1 = torch.clamp(qraw[..., 2:3] + 1, 0, cmax)
        nruns = 4
    else:
        # cells smaller than 2r: the 2x2 neighborhood no longer covers the
        # ball (the JAX package silently under-covers for cell_factor in
        # (1, 2)), so the port refuses
        raise ValueError(
            f"grid_radius_search: cell_factor must be 1.0 or >= 2.0, got {cell_factor}"
        )
    # a run whose unclipped (x, y) fell outside the grid is dropped, not
    # clipped: clipping would duplicate an in-range neighbour run
    run_ok = (cx >= 0) & (cx <= cmax) & (cy >= 0) & (cy <= cmax)
    cx = torch.clamp(cx, 0, cmax)
    cy = torch.clamp(cy, 0, cmax)
    lo_key = (cx << (2 * _BITS)) | (cy << _BITS) | z0
    hi_key = (cx << (2 * _BITS)) | (cy << _BITS) | z1

    starts = torch.searchsorted(skey, lo_key.reshape(b, -1), out_int32=True)
    ends = torch.searchsorted(skey, hi_key.reshape(b, -1), right=True, out_int32=True)
    starts = starts.reshape(b, m, nruns)
    ends = ends.reshape(b, m, nruns)
    live = run_ok & q_mask[:, :, None]
    ends = torch.where(live, ends, starts)

    # aligned windows: rows [start//cw, +window_rows) cover positions
    # [wrow*cw, wrow*cw + wspan) which contain [start, start + wspan - cw + 1)
    wrow = torch.div(starts, _CW, rounding_mode="floor")
    wend = wrow * _CW + wspan
    overflow = torch.clamp_min(ends - wend, 0).sum().to(torch.int32)
    return _Runs(order, tuple(planes), order_plane, wrow, starts, ends, nruns, overflow)


def _window_bounds(runs: _Runs, wspan: int):
    """Per query row (B*M rows): its runs' starts | ends local to their
    windows, (B*M, 2*nruns) int32, and the windows' first plane rows,
    (B*M, nruns) int32: the in-place window selection's inputs."""
    b, m, nruns = runs.wrow.shape
    ls = runs.starts - runs.wrow * _CW
    le = torch.clamp(runs.ends - runs.wrow * _CW, 0, wspan)
    lsle = torch.cat([ls, le], dim=2).reshape(b * m, 2 * nruns).to(torch.int32)
    return lsle.contiguous(), runs.wrow.reshape(b * m, nruns).to(torch.int32).contiguous()


def _row_window_gather(src, rows, nrows: int):
    """Gather `nrows` consecutive rows of src (B, R, C) starting at rows
    (B, P) -> (B, P, nrows, C)."""
    b, r, c = src.shape
    p = rows.shape[1]
    flat = src.reshape(b * r, c)
    off = (torch.arange(b, dtype=rows.dtype, device=rows.device) * r)[:, None]
    parts = [flat[(rows + off + j).reshape(-1).long()] for j in range(nrows)]
    return torch.stack(parts, dim=1).reshape(b, p, nrows, c)


def grid_radius_search(
    q_points: torch.Tensor,  # (B, M, 3)
    s_points: torch.Tensor,  # (B, N, 3)
    q_mask: torch.Tensor,  # (B, M)
    s_mask: torch.Tensor,  # (B, N)
    radius,  # a float, or an f32 scalar tensor on the points' device (no upload)
    limit: int,
    window_rows: int = 2,
    select_kernel: str = "auto",  # auto | fused | pallas | topk
    cell_factor: float = 1.0,  # 1.0 (9 runs) or >= 2.0 (4 runs)
):
    """Batched grid-run pruned radius search.

    Returns (indices (B, M, limit) int32 with sentinel == N, overflow ()
    int32 — candidate z-run entries beyond the gathered aligned windows)."""
    if select_kernel not in ("auto", "fused", "pallas", "topk"):
        raise ValueError(f"grid_radius_search: unknown select_kernel {select_kernel!r}")
    b, m = q_points.shape[:2]
    n = s_points.shape[1]
    runs = _grid_runs(q_points, s_points, q_mask, s_mask, radius, window_rows, cell_factor)
    rad = _f32(radius, s_points)
    r2 = rad * rad
    wspan = window_rows * _CW

    if select_kernel in ("auto", "fused"):
        lsle, wrow = _window_bounds(runs, wspan)
        d2_sel, idx = window_select_runs(
            q_points.reshape(b * m, 3).contiguous(), lsle, wrow, *runs.planes, runs.order_plane,
            limit, nruns=runs.nruns, wspan=wspan,
        )
        d2_sel = d2_sel.reshape(b, m, limit)
        idx = idx.reshape(b, m, limit)
        ok = (d2_sel <= r2) & q_mask[:, :, None]
        return torch.where(ok, idx, n).to(torch.int32), runs.overflow

    nruns = runs.nruns
    wrow, starts, ends = runs.wrow, runs.starts, runs.ends
    offs = torch.arange(wspan, dtype=torch.int32, device=q_points.device)
    pos = wrow[..., None] * _CW + offs  # (B, M, nruns, wspan)
    cand_valid = (pos >= starts[..., None]) & (pos < ends[..., None])
    d2 = torch.zeros((b, m, nruns, wspan), dtype=q_points.dtype, device=q_points.device)
    wflat = wrow.reshape(b, m * nruns)
    for a in range(3):
        ca = _row_window_gather(runs.planes[a], wflat, window_rows).reshape(
            b, m, nruns, wspan
        )
        diff = ca - q_points[:, :, None, None, a]
        d2 = d2 + diff * diff
    d2 = torch.where(cand_valid, d2, _BIG)
    if select_kernel == "pallas":
        # K3 over each query's flat (run-major, offset-minor) window
        # distances: its tie order (the smaller flat position) is the
        # two-stage top-k's
        vals, flat = select_min_k(d2.reshape(b * m, nruns * wspan), limit)
        d2_sel = vals.reshape(b, m, limit)
        flat = flat.reshape(b, m, limit).long()
        run = torch.div(flat, wspan, rounding_mode="floor")
        within_run = flat - run * wspan
    else:
        # two-stage exact top-k (stable sorts keep lax.top_k's tie order):
        # the nearest `limit` per run, then the nearest `limit` of the run
        # winners
        kk = min(limit, wspan)
        v1, slot1 = torch.sort(d2, dim=-1, stable=True)
        v1, slot1 = v1[..., :kk], slot1[..., :kk]
        d2_sel, slot2 = torch.sort(v1.reshape(b, m, nruns * kk), dim=-1, stable=True)
        d2_sel, slot2 = d2_sel[..., :limit], slot2[..., :limit]
        run = torch.div(slot2, kk, rounding_mode="floor")
        within_run = torch.gather(slot1.reshape(b, m, nruns * kk), -1, slot2)
    picked = torch.gather(wrow, -1, run).long() * _CW + within_run
    idx = torch.gather(
        runs.order, 1, torch.clamp_max(picked, n - 1).reshape(b, -1)
    ).reshape(b, m, limit)
    ok = (d2_sel <= r2) & q_mask[:, :, None]
    return torch.where(ok, idx, n).to(torch.int32), runs.overflow
