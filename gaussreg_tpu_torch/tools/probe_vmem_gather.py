"""Probe P1 on the card: three ways to gather rows of a table by an index
vector (port of tools/probe_vmem_gather.py, which asked whether a Pallas
TPU kernel can gather rows of a VMEM-resident table with a traced index).

    python -m gaussreg_tpu_torch.tools.probe_vmem_gather [--seed 0]

VMEM is shared memory here. Each variant computes out = table[idx] for a
(G, 8) f32 table and K int32 indices in [0, G), bit for bit, through its
own kernel in csrc/probe_gather.cu (see the notes there):

- global: each thread reads its row from device memory (the probe's
  `kernel`, table in pltpu.ANY);
- shared: a cluster of 8 blocks stages the table in its distributed
  shared memory, an eighth per block with one bulk async copy (the TMA's
  bulk form), then two lanes per row read it from the owning block
  (`kernel2`, jnp.take from VMEM); the table may hold up to
  MAX_TABLE_ROWS rows, the cluster's shared memory;
- onehot: the twin of `kernel3`, the one-hot (K, G) x (G, C) matmul, which
  the TPU probe wrote only because Mosaic could not gather by a traced
  index. On this card the matrix unit has no place in a gather, so the
  kernel is a direct gather laid out for whole 32-byte sectors (two lanes
  per row, one 16-byte load each); its plain version stays the one-hot
  product, which is exact.

The function moves ~8 KB at the probe's shape (a bound of ~2.6 ns), so
every variant is held by launch latency. Each wrapper takes its plain
PyTorch version for CPU tensors and launches its kernel for CUDA tensors. main() prints each variant's max error against
table[idx] and its time on the card: a slope over graph-replayed launches
(utils.timing.slope), beside torch.index_select, the PyTorch call that
computes the same function, and the shared variant's time beside the
direct gather's: the staging's cost.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from gaussreg_tpu_torch.ops import _cuda
from gaussreg_tpu_torch.utils.timing import slope

G, K, C = 4096, 128, 8

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
KERNELS = {
    name: _cuda.register(
        f"probe_gather_{name}",
        _cuda.CudaKernel("probe_gather.cu", f"gaussreg_probe_gather_{name}", _ARGS),
    )
    for name in ("global", "shared", "onehot")
}
# variant shared stages the table across a cluster of CLUSTER_BLOCKS blocks,
# each slice of ceil(G / CLUSTER_BLOCKS) rows in one block's shared memory
# (227 KB on the H100, 16 B of it for the slice's mbarrier)
CLUSTER_BLOCKS = 8
SLICE_MAX_ROWS = (227 * 1024 - 16) // (C * 4)
MAX_TABLE_ROWS = CLUSTER_BLOCKS * SLICE_MAX_ROWS
MAX_SHARED_BYTES = MAX_TABLE_ROWS * C * 4


def check_shared_capacity(g: int) -> None:
    """Raise unless a g-row table fits in the shared variant's cluster."""
    if -(-g // CLUSTER_BLOCKS) > SLICE_MAX_ROWS:
        raise ValueError(f"gather shared: a {g}-row table does not fit in the cluster's shared "
                         f"memory ({MAX_TABLE_ROWS} rows, {MAX_SHARED_BYTES} bytes)")


def gather_global_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_shared_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The jnp.take form: flat element positions idx * C + column."""
    cols = torch.arange(table.shape[1], device=table.device)
    return torch.take(table, idx.long()[:, None] * table.shape[1] + cols)


def gather_onehot_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The one-hot matmul form: exact, since each output sums one 1 x value
    and exact zeros."""
    gids = torch.arange(table.shape[0], device=table.device)
    onehot = (gids[None, :] == idx.long()[:, None]).to(table.dtype)
    return onehot @ table


PLAIN = {"global": gather_global_plain, "shared": gather_shared_plain,
         "onehot": gather_onehot_plain}


def gather(variant: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r] = table[idx[r]] for a (G, 8) f32 table and (K,) int32 indices
    in [0, G), through `variant` ("global", "shared" or "onehot")."""
    if table.dim() != 2 or table.shape[1] != C or idx.dim() != 1:
        raise ValueError(f"gather: need a (G, {C}) table and (K,) indices, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.device.type == "cpu":
        return PLAIN[variant](table, idx)
    _cuda.check_cuda_tensor(table, "table", torch.float32, 2)
    _cuda.check_cuda_tensor(idx, "idx", torch.int32, 1)
    g, k = table.shape[0], idx.shape[0]
    if variant == "shared":
        check_shared_capacity(g)
    out = torch.empty((k, C), dtype=torch.float32, device=table.device)
    KERNELS[variant].launch(table.data_ptr(), idx.data_ptr(), out.data_ptr(), g, k)
    return out


def make_inputs(seed: int, g: int = G, k: int = K, device="cuda"):
    """The probe's inputs from a numpy seed: a (g, 8) standard-normal f32
    table and k uniform int32 indices."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((g, C)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, g, size=k).astype(np.int32))
    return table.to(device), idx.to(device)


def gather_bytes(table: torch.Tensor, idx: torch.Tensor) -> float:
    """Bytes the function must move: the distinct rows the indices select,
    the indices and the output rows."""
    rows = int(torch.unique(idx).numel())
    return float(rows * table.shape[1] * 4 + idx.numel() * 4 + idx.numel() * table.shape[1] * 4)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_vmem_gather: needs a CUDA card")
    inputs = [make_inputs(args.seed + i) for i in range(64)]  # perturbed per repetition
    table, idx = inputs[0]
    ref = table[idx.long()]
    for variant in PLAIN:
        out = gather(variant, table, idx)
        err = (out - ref).abs().max().item()
        print(f"{variant}: max err {err:.3e} ({'bit for bit' if torch.equal(out, ref) else 'DIFFERS'})")
    ms = {}
    for variant in PLAIN:
        ms[variant] = slope(lambda i, v=variant: gather(v, *inputs[i % len(inputs)]), 8, 40) * 1e3
        print(f"variant {variant}: {ms[variant]:.5f} ms per launch")
    dt = slope(lambda i: torch.index_select(inputs[i % len(inputs)][0], 0,
                                            inputs[i % len(inputs)][1]), 8, 40)
    print(f"torch.index_select: {dt * 1e3:.5f} ms per call")
    print(f"staging: shared {ms['shared']:.5f} ms against the direct gather (onehot) "
          f"{ms['onehot']:.5f} ms, {ms['shared'] - ms['onehot']:.5f} ms more")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
