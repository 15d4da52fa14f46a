"""Frozen count functions of the benchmark: the work the cell's inputs need
for the function a kernel computes, from the benchmark's own reference and
configuration, never from the program's intermediates, so they count the
same work whatever implements it. Bytes count each input once and each
output once; operations count what these inputs need (valid points and
neighbours, non-zero kernel influences)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence


def k1_counts(valid: Sequence[Sequence[int]], neighbor_limits: Sequence[int],
              valid_neighbors: int) -> Dict[str, float]:
    """K1, a pair's 13 radius searches of the pyramid (both clouds), each the
    `limit` nearest support points of every query within its radius.
    valid[c][l]: the valid points of cloud c at level l (the reference
    pyramid's masks); valid_neighbors: the valid entries of the reference's
    13 neighbour lists. Bytes: query and support coordinates (12 B a point)
    in, (d2, id) out (8 B a slot of every valid query); operations: a
    squared distance (8 f32 operations) for each valid neighbour."""
    levels = len(neighbor_limits)
    bytes_ = 0.0
    for n in valid:
        searches = [(n[l], n[l], neighbor_limits[l]) for l in range(levels)]  # self
        searches += [(n[l + 1], n[l], neighbor_limits[l]) for l in range(levels - 1)]  # down
        searches += [(n[l], n[l + 1], min(4, neighbor_limits[l + 1]))  # up
                     for l in range(levels - 1)]
        for q, s, limit in searches:
            bytes_ += 12.0 * (q + s) + 8.0 * q * limit
    return {"bytes": bytes_, "f32_flops": 8.0 * valid_neighbors, "bf16_flops": 0.0}


def k2_counts(calls: List[Dict[str, float]]) -> Dict[str, float]:
    """K2, the backbone's KPConv contractions out[m] = sum_h,k infl[m,h,k]
    nf[m,h,:] @ W[k]. Each call: `nnz` non-zero influences, `rows` queries
    with any, K kernel points, C in and D out channels. Operations (bf16
    products, f32 sums): 2 C per non-zero influence, then 2 K C D per row;
    bytes: the (K, C, D) bf16 weights in and the (rows, D) f32 output."""
    flops = sum(2.0 * c["nnz"] * c["C"] + 2.0 * c["rows"] * c["K"] * c["C"] * c["D"]
                for c in calls)
    bytes_ = sum(2.0 * c["K"] * c["C"] * c["D"] + 4.0 * c["rows"] * c["D"] for c in calls)
    return {"bytes": bytes_, "bf16_flops": flops, "f32_flops": 0.0}


@contextlib.contextmanager
def count_flops(totals: Dict[str, float]):
    """The matrix products' operations (torch's FlopCounterMode) of what runs
    inside, added to totals['flops']."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with mode:
        yield
    totals["flops"] = totals.get("flops", 0.0) + float(mode.get_total_flops())
