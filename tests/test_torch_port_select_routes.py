"""K3's route table and P1's cluster capacity, on the CPU.

`select_k.route(w, k, rows)` names the kernel that `select_min_k` launches
for a CUDA tensor, before the launch, for every 0 < k <= W: the radix
select where its block's shared memory holds the row and its keys and
k >= 700, or k >= 256 on rows of at most 12 288 columns; else the
threshold filter, one block per row for few long rows (k <= 48 and
W >= 8 192 columns per 1 024 rows, at least 8 192), one warp per row
otherwise. It refuses only k outside (0, W]. On a CPU tensor every shape
takes the plain stable sort and launches nothing. P1's `shared` variant
stages the table across a cluster of 8 blocks: `check_shared_capacity`
takes the largest table that fits and refuses one row more. The kernels
themselves are held against these plain versions in
tests/test_torch_port_cuda.py on the card.
"""

import pytest
import torch

from gaussreg_tpu_torch.ops import select_k as sk
from gaussreg_tpu_torch.tools import probe_vmem_gather as p1

torch.set_num_threads(2)  # xdist workers share the cores

WIDE_W = sk.FILTER_WIDE_MIN_WIDTH
ROUTE_CASES = [
    (16, 1, 40, "select_min_k"),
    (128, 3, 32_768, "select_min_k"),  # the fused route's generic inputs
    (128, 128, 40, "select_min_k"),
    (2304, 35, 61_440, "select_min_k"),  # the pallas pyramid's largest call
    (WIDE_W - 1, 3, 1, "select_min_k"),
    (WIDE_W, 1, 1, "select_min_k_wide"),
    (WIDE_W, 48, 1024, "select_min_k_wide"),
    (WIDE_W, 49, 1024, "select_min_k"),  # past the 4-key queues
    (WIDE_W, 35, 1025, "select_min_k"),  # more rows need wider rows
    (2 * WIDE_W - 1, 35, 2048, "select_min_k"),
    (2 * WIDE_W, 35, 2048, "select_min_k_wide"),
    (25_601, 35, 1024, "select_min_k_wide"),
    (30_720, 35, 1024, "select_min_k_wide"),  # radius_search's blocks
    (30_720, 35, 3840, "select_min_k_wide"),
    (30_720, 35, 3841, "select_min_k"),
    (30_720, 35, 61_440, "select_min_k"),
    (30_720, 89, 1024, "select_min_k"),
    (30_720, 128, 1, "select_min_k"),
    (129, 129, 40, "select_min_k"),
    (WIDE_W, 129, 1, "select_min_k"),
    (25_600, 129, 1024, "select_min_k"),
    (25_600, 700, 40, "select_min_k_radix"),
    (25_601, 129, 1024, "select_min_k"),
    (30_720, 700, 40, "select_min_k_radix"),
    (30_720, 1706, 1, "select_min_k_radix"),
    # shapes the card refused before the filter took every k (the chunk
    # winners of the rounds' wide mode past 200 KiB of shared memory)
    (30_720, 1707, 1, "select_min_k_radix"),
    (200_000, 262, 1, "select_min_k"),
    (30_720, 2048, 1024, "select_min_k_radix"),  # knn_search's blocks on 30 720 points
    (100_000, 600, 1024, "select_min_k"),  # and on 100 000
    # the radix select's bounds: k, width, its shared memory
    (2304, 255, 61_440, "select_min_k"),
    (2304, 256, 61_440, "select_min_k_radix"),
    (sk.RADIX_MAX_WIDTH, 256, 1, "select_min_k_radix"),
    (sk.RADIX_MAX_WIDTH + 1, 256, 1, "select_min_k"),
    (sk.RADIX_MAX_WIDTH + 1, 699, 1, "select_min_k"),
    (sk.RADIX_MAX_WIDTH + 1, 700, 1, "select_min_k_radix"),
    (49_000, 700, 1, "select_min_k_radix"),  # 196 000 + 8 192 bytes
    (52_000, 700, 1, "select_min_k"),  # 208 000 + 8 192
    (30_720, 8192, 1, "select_min_k_radix"),
    (30_720, 8193, 1, "select_min_k"),  # 16 384 keys
]


@pytest.mark.parametrize("w,k,rows,name", ROUTE_CASES)
def test_select_route_boundaries(w, k, rows, name):
    assert sk.route(w, k, rows) == name
    assert name in sk.ROUTES


@pytest.mark.parametrize("w,k", [(16, 0), (16, 17)])
def test_select_route_refuses(w, k):
    """k outside (0, W]: nothing else is refused."""
    with pytest.raises(ValueError):
        sk.route(w, k, 1)


@pytest.mark.parametrize("w,k", [(300, 129), (25_601, 35), (25_601, 129)])
def test_select_min_k_on_the_cpu_takes_the_plain_version(w, k):
    """A CPU tensor takes the stable sort whatever its route, and no route
    counts a launch."""
    gen = torch.Generator().manual_seed(w + k)
    x = torch.randint(0, 50, (3, w), generator=gen).float()
    x[0] = 0.0
    x[0, ::2] = -0.0
    before = {n: kern.launches for n, kern in sk.ROUTES.items()}
    vals, pos = sk.select_min_k(x, k)
    assert {n: kern.launches for n, kern in sk.ROUTES.items()} == before
    want_vals, want_pos = torch.sort(x, dim=1, stable=True)
    assert torch.equal(pos, want_pos[:, :k].to(torch.int32))
    assert torch.equal(vals.view(torch.int32), want_vals[:, :k].contiguous().view(torch.int32))


def test_probe_gather_cluster_capacity():
    """Eight slices of ceil(G / 8) rows, each beside its mbarrier in one
    block's 227 KB of shared memory."""
    assert p1.SLICE_MAX_ROWS * p1.C * 4 + 16 <= 227 * 1024
    assert p1.MAX_TABLE_ROWS == p1.CLUSTER_BLOCKS * p1.SLICE_MAX_ROWS == 58_104
    assert p1.MAX_SHARED_BYTES == p1.MAX_TABLE_ROWS * 32


@pytest.mark.parametrize("g", [1, 4096, 8192, 2 * 4096 * 7, 58_104])
def test_probe_gather_capacity_takes_tables_that_fit(g):
    p1.check_shared_capacity(g)


@pytest.mark.parametrize("g", [58_105, 58_112, 100_000])
def test_probe_gather_capacity_refuses_larger_tables(g):
    with pytest.raises(ValueError, match="shared memory"):
        p1.check_shared_capacity(g)
