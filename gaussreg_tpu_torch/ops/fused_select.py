"""Fused window-search selection: d2 + validity + k-min + original-id
extraction (port of gaussreg_tpu/ops/fused_select.py, TPU kernel K1).

Two entries compute the same function as the Pallas kernel: per row, the
`limit` smallest d2 over the candidates inside their run's local bounds
[ls, le), ascending, ties to the smaller flat (run-major) position, with
the candidates' original support ids; once the valid candidates are
exhausted the remaining slots hold (finfo(f32).max, the id at position 0),
as the Pallas kernel emits them. Precondition (as for the Pallas kernel):
valid candidates have finite d2.

- `window_select_idx` takes the gathered (P, nruns * wspan) window planes,
  the Pallas kernel's signature (library users, the tests against JAX).
- `window_select_runs` reads each query's runs in place from the sorted
  (B, r_tot, 128) planes of the grid search (ops/neighbors.py), so no
  (P, W) plane is made: the grid search's route.

On CUDA tensors both launch the one kernel of csrc/window_select.cu (and
count into its one launch counter): the gathered planes are its in-place
planes with one batch of P * nruns rows of wspan, run r of row p at row
p * nruns + r. On CPU tensors they run
`window_select_plain` and `window_select_runs_plain` (which gathers the
planes with `gather_windows`, then runs `window_select_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from gaussreg_tpu_torch.ops import _cuda

_BIG_F = torch.finfo(torch.float32).max

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _cuda.register(
    "window_select_idx",
    _cuda.CudaKernel(
        "window_select.cu",
        "gaussreg_window_select",
        # q, q_stride, lsle, wrow, x, y, z, ids, out_d2, out_idx,
        # rows, rows_per_batch, r_tot, cw, nruns, wspan, limit
        [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
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
        if t.shape[0] != p:
            raise ValueError(f"window_select_idx: {name} has {t.shape[0]} rows, not {p}")
    wrow = torch.arange(p * nruns, dtype=torch.int32, device=win_x.device).view(p, nruns)
    return _launch(q_xyz, lsle, wrow, win_x, win_y, win_z, win_idx, limit, p, p * nruns, wspan,
                   nruns, wspan)


def _launch(q_xyz, lsle, wrow, x, y, z, ids, limit, rows_per_batch, r_tot, cw, nruns, wspan):
    p = q_xyz.shape[0]
    d2 = torch.empty((p, limit), dtype=torch.float32, device=q_xyz.device)
    idx = torch.empty((p, limit), dtype=torch.int32, device=q_xyz.device)
    if p:
        KERNEL.launch(
            q_xyz.data_ptr(), q_xyz.shape[1], lsle.data_ptr(), wrow.data_ptr(), x.data_ptr(),
            y.data_ptr(), z.data_ptr(), ids.data_ptr(), d2.data_ptr(), idx.data_ptr(), p,
            rows_per_batch, r_tot, cw, nruns, wspan, limit,
        )
    return d2, idx


def gather_windows(wrow, plane_x, plane_y, plane_z, plane_idx, wspan: int):
    """The gathered entry's (P, nruns * wspan) planes x, y, z and ids, cut
    from the sorted (B, r_tot, cw) planes: run r of row p is the
    wspan // cw plane rows from b * r_tot + wrow[p, r] (b = p // M, P =
    B * M), run-major. This is the JAX package's whole-row gather, which the
    in-place entry does without: the CPU plain version of
    `window_select_runs` and the old route that `chip_smoke.py` times beside
    it gather with it."""
    b, r_tot, cw = plane_x.shape
    p, nruns = wrow.shape
    m = p // b
    window_rows = wspan // cw
    batch = torch.arange(p, device=wrow.device) // m
    base = wrow.long() + (batch * r_tot)[:, None]
    rows = (base[:, :, None] + torch.arange(window_rows, device=wrow.device)).reshape(-1)
    return tuple(plane.reshape(b * r_tot, cw)[rows].reshape(p, nruns * wspan)
                 for plane in (plane_x, plane_y, plane_z, plane_idx))


def window_select_runs_plain(q_xyz, lsle, wrow, plane_x, plane_y, plane_z, plane_idx,
                             limit: int, nruns: int, wspan: int):
    """The plain version of the in-place entry: the windows gathered by
    `gather_windows`, then `window_select_plain`."""
    return window_select_plain(q_xyz, lsle, *gather_windows(wrow, plane_x, plane_y, plane_z,
                                                            plane_idx, wspan),
                               limit, nruns, wspan)


def window_select_runs(
    q_xyz: torch.Tensor,  # (P, S) f32, S >= 3, P = B * M: query x, y, z in cols 0..2
    lsle: torch.Tensor,  # (P, 2 * nruns) int32: run starts | ends local to the window
    wrow: torch.Tensor,  # (P, nruns) int32: each run's first window row in its batch's planes
    plane_x: torch.Tensor,  # (B, r_tot, cw) f32 sorted support coordinates, far-padded
    plane_y: torch.Tensor,
    plane_z: torch.Tensor,
    plane_idx: torch.Tensor,  # (B, r_tot, cw) int32 original support ids, zero-padded
    limit: int,
    nruns: int,
    wspan: int,  # window_rows * cw
):
    """`window_select_idx` on windows read in place: run r of row p is
    the wspan entries from plane row b * r_tot + wrow[p, r] of batch b = p //
    M. Every window must lie inside the planes (0 <= wrow, wrow + wspan //
    cw <= r_tot, as the grid search's padding gives): on the CPU a window
    outside raises ValueError; on the card the kernel traps, so the next
    synchronisation raises and the CUDA context is lost.

    Returns (d2 (P, limit) f32 ascending, idx (P, limit) int32). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    p = q_xyz.shape[0]
    b, r_tot, cw = plane_x.shape if plane_x.dim() == 3 else (0, 0, 0)
    if (q_xyz.shape[1] < 3 or lsle.shape != (p, 2 * nruns) or wrow.shape != (p, nruns)
            or b == 0 or cw == 0 or wspan <= 0 or wspan % cw or p % b
            or any(t.shape != plane_x.shape for t in (plane_y, plane_z, plane_idx))):
        raise ValueError(
            f"window_select_runs: inconsistent shapes {tuple(q_xyz.shape)}, "
            f"{tuple(lsle.shape)}, {tuple(wrow.shape)}, planes {tuple(plane_x.shape)}, "
            f"nruns={nruns}, wspan={wspan}"
        )
    if q_xyz.device.type == "cpu":
        if wrow.numel() and (int(wrow.min()) < 0 or int(wrow.max()) + wspan // cw > r_tot):
            raise ValueError(f"window_select_runs: a window outside the planes' {r_tot} rows")
        return window_select_runs_plain(q_xyz, lsle, wrow, plane_x, plane_y, plane_z,
                                        plane_idx, limit, nruns, wspan)
    for name, t, dt, nd in (("q_xyz", q_xyz, torch.float32, 2), ("lsle", lsle, torch.int32, 2),
                            ("wrow", wrow, torch.int32, 2), ("plane_x", plane_x, torch.float32, 3),
                            ("plane_y", plane_y, torch.float32, 3),
                            ("plane_z", plane_z, torch.float32, 3),
                            ("plane_idx", plane_idx, torch.int32, 3)):
        _cuda.check_cuda_tensor(t, name, dt, nd)
    return _launch(q_xyz, lsle, wrow, plane_x, plane_y, plane_z, plane_idx, limit, p // b, r_tot,
                   cw, nruns, wspan)
