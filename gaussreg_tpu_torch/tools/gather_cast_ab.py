"""Where KPConv's bf16 cast sits around its feature gather: an A/B on one
make_cfg() pair on one CUDA card.

    python -m gaussreg_tpu_torch.tools.gather_cast_ab [--rounds 3] [--reps 3]

Each variant swaps models/kpconv.py's `batched_gather` (and its import in
models/registration.py) and `gather_bf16`:

- parent: the gather by advanced indexing, the cast before it (the port
  before it trained);
- cast_after: the gather by index_select, the cast after it on every path;
- shipped: models/kpconv.py as it stands: index_select, the cast before
  the gather without a gradient and after it under grad;
- cast_first: index_select, the cast before the gather under grad too
  (the gather's backward then sums the features' gradients in bf16).

The eval forward (the model under torch.no_grad() on the held-out pair
random_pair(cfg, 20_000_007), the trained checkpoint, its pyramid built
once) runs parent, cast_after and shipped; one train forward and backward
(train=True, with_transform=False, the overall loss, on
random_pair(cfg, 0, num_points=20000) from seeded weights) runs shipped,
cast_after and cast_first. Per variant and round: the wall ms (CUDA events,
the median of --reps calls) and, from one more call under torch.profiler,
the device busy ms (every device event's own time) and the device ms under
aten::index_select, aten::index, aten::index_add_ and aten::copy_ (each the
op's kernels, children included). The variants take turns, the order
reversed every other round; per variant the median round is printed.

Prints a line per variant, the card's name and power limit, and all of it
as one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import torch

from gaussreg_tpu_torch.models import kpconv as kpconv_mod
from gaussreg_tpu_torch.models import registration as reg_mod

OPS = ("aten::index_select", "aten::index", "aten::index_add_", "aten::copy_")
CKPT = os.path.join(os.path.dirname(__file__), "..", "..", "checkpoints", "synthetic_coarse.msgpack")


def gather_advanced(values, indices, fill=0.0):
    """batched_gather as the port had it before it trained: advanced
    indexing, whose backward sorts the indices."""
    b, n = values.shape[:2]
    flat = values.reshape((b * n,) + values.shape[2:])
    clipped = torch.clamp_max(indices, n - 1).long()
    off = (torch.arange(b, device=values.device) * n).reshape((b,) + (1,) * (indices.dim() - 1))
    out = flat[(clipped + off).reshape(-1)].reshape(indices.shape + values.shape[2:])
    sentinel = (indices == n).reshape(indices.shape + (1,) * (values.dim() - 2))
    return torch.where(sentinel, torch.as_tensor(fill, dtype=values.dtype, device=values.device), out)


def cast_first(s_feats, neighbor_indices):
    return kpconv_mod.batched_gather(s_feats.to(torch.bfloat16), neighbor_indices, fill=0.0)


def cast_after(s_feats, neighbor_indices):
    return kpconv_mod.batched_gather(s_feats, neighbor_indices, fill=0.0).to(torch.bfloat16)


SHIPPED = (kpconv_mod.batched_gather, kpconv_mod.gather_bf16)
VARIANTS = {
    "parent": (gather_advanced, cast_first),
    "cast_after": (SHIPPED[0], cast_after),
    "shipped": SHIPPED,
    "cast_first": (SHIPPED[0], cast_first),
}


def use(variant):
    gather, cast = VARIANTS[variant]
    kpconv_mod.batched_gather = reg_mod.batched_gather = gather
    kpconv_mod.gather_bf16 = cast


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def profiled(fn):
    """Device busy ms and the device ms under each of OPS, for one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    own = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    tot = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    busy = sum(own(e) for e in avg if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3
    ops = {op: sum(tot(e) for e in avg if e.key == op
                   and str(getattr(e, "device_type", "")).endswith("CPU")) / 1e3 for op in OPS}
    return busy, ops


def run(name, fn, variants, rounds, reps):
    rows = {v: [] for v in variants}
    for v in variants:  # warm-up: builds the kernels, fills the allocator
        use(v)
        fn()
    torch.cuda.synchronize()
    for r in range(rounds):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            use(v)
            wall = statistics.median(event_ms(fn) for _ in range(reps))
            busy, ops = profiled(fn)
            rows[v].append({"wall_ms": wall, "busy_ms": busy, **{k + "_ms": x for k, x in ops.items()}})
    use("shipped")
    out = {}
    for v, rs in rows.items():
        med = sorted(rs, key=lambda x: x["busy_ms"])[len(rs) // 2]
        out[v] = {**med, "busy_ms_rounds": [x["busy_ms"] for x in rs],
                  "wall_ms_rounds": [x["wall_ms"] for x in rs]}
        print(f"{name} {v:10s}: " + ", ".join(f"{k} {x:.3f}" for k, x in med.items()), flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_cast_ab: needs a CUDA card")
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.models.losses import overall_loss

    dev = torch.device("cuda")
    cfg = make_cfg()
    model = reg_mod.create_model(cfg, dev)
    model.load_state_dict(load_checkpoint(CKPT))
    rp, rf, sp, sf, _ = random_pair(cfg, 20_000_007)
    eval_batch = make_pair_batch(cfg, rp, rf, sp, sf, device=dev)

    def eval_forward():
        with torch.no_grad():
            model(eval_batch, torch.Generator(device=dev).manual_seed(0))

    result = {"eval": run("eval", eval_forward, ["parent", "cast_after", "shipped"],
                          args.rounds, args.reps)}

    train_model = reg_mod.create_model(cfg, dev)
    train_model.reset_parameters(torch.Generator().manual_seed(0))
    train_batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=20000), device=dev)

    def train_step():
        train_model.zero_grad(set_to_none=True)
        out = train_model(train_batch, torch.Generator(device=dev).manual_seed(1), train=True,
                          with_transform=False)
        overall_loss(cfg, out, train_batch.transform)["loss"].backward()

    result["train"] = run("train", train_step, ["shipped", "cast_after", "cast_first"],
                          args.rounds, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    result["card"] = smi
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
