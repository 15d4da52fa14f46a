"""Data parallelism over torch.distributed (port of
gaussreg_tpu/parallel/mesh.py).

The JAX package puts every chip in one `jax.sharding.Mesh`, shards the
batch along its `data` axis and lets XLA insert the gradient all-reduce
under jit. torch has no such mesh. Here each process (a rank) drives one
device and builds only its share of the global batch, and the train step
(engine/trainer.py) reduces gradients and metrics across the ranks
explicitly. So the mesh helpers have no torch meaning; in their place:

- `make_mesh` -> `init_distributed` (the default process group) and
  `rank_device` (the device this rank drives);
- `replicated` parameters -> `broadcast_params_` from rank 0 after init,
  resume or warm start; the ranks then stay equal, because every rank
  applies the same reduced gradient;
- `batch_sharded` / `shard_batch_pytree` -> each rank builds its
  `process_local_batch_slice` of the global batch on its own device;
- XLA's gradient all-reduce -> `all_reduce_mean_` over one flat buffer;
- a `mesh` and `axis_name` argument (the JAX `render_sharded`) -> a
  process group argument (`group`, default the default group);
  shard_map's transpose of replicated inputs -> an explicit all-reduce of
  their gradients (gs/rasterizer/render.py `_Replicated`).

Why an explicit reduction and not DistributedDataParallel: the train step
already collects a name -> gradient dict for its optimizer (optax's chain,
reproduced outside torch.optim); it runs one backward over a list of
pairs, where DDP's hooks expect one forward per backward; and the KPConv
kernel points take no gradient but get weight decay on every rank, which
DDP's buckets of gradient-taking parameters do not hold. One flat SUM and
a division also work on gloo, which has no AVG.

Without a process group every function here is the single-process
identity: world size 1, rank 0, no communication.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.engine.summary import process_index


def world_size() -> int:
    """The number of ranks in the default process group, else 1."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device this rank drives: the CPU for a CPU `device`, else
    cuda:LOCAL_RANK (torchrun's local rank; without it the rank), modulo the
    visible cards, so that several ranks may share one card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
) -> torch.device:
    """Join the default process group; return this rank's device.

    With the JAX CLI's explicit triple (`coordinator` "host:port",
    `num_processes`, `process_id`) the ranks meet at tcp://host:port; with
    `init_method` (a file:// or tcp:// URL) and the same two counts, there;
    with neither, from torchrun's environment (env://), the counterpart of
    jax.distributed.initialize()'s auto-detection. The backend is NCCL for
    a CUDA `device` (default cuda) and gloo for the CPU; `backend="gloo"` on
    CUDA runs several ranks on one card, which NCCL refuses. A group that
    cannot be formed raises."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if init_method is None:
        init_method = "env://" if coordinator is None else f"tcp://{coordinator}"
    kwargs = {}
    if init_method != "env://":
        if num_processes is None or process_id is None:
            raise ValueError(f"{init_method} needs num_processes and process_id")
        kwargs = {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    dev = rank_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def process_local_batch_slice(global_batch_size: int) -> slice:
    """Which slice of the global batch this rank builds (the reference's
    DistributedSampler, utils/torch.py:58-60)."""
    per = global_batch_size // world_size()
    start = process_index() * per
    return slice(start, start + per)


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` across ranks in place; returns it."""
    if world_size() > 1:
        dist.all_reduce(tensor)
    return tensor


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor (all of one dtype) by its mean across ranks, in
    place: one flat buffer, one SUM, then a division by the world size.
    Every rank ends with the same bits."""
    world = world_size()
    tensors = list(tensors)
    if world == 1 or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat /= world
    _unflat_(flat, tensors)


def broadcast_params_(params: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite every rank's tensors (all of one dtype) with rank `src`'s,
    in one flat broadcast."""
    params = list(params)
    if world_size() == 1 or not params:
        return
    flat = _flat(params)
    dist.broadcast(flat, src)
    _unflat_(flat, params)
