"""Data-parallel check of the train step: N ranks against one process.

    python -m gaussreg_tpu_torch.tools.ddp_check --world 2 --pairs 0 1 \\
        --steps 2 --output_dir out [--cpu] [--backend gloo] [--nan_pair 1]

Trains make_tiny_cfg() on the synthetic pairs random_pair(cfg, seed,
NUM_POINTS) of the global batch `--pairs`, `--steps` steps of
make_train_step, from the same seeded weights on every rank. With
`--world N` > 1 it launches N processes, rank r in its own, which meet
through a file:// init in --output_dir (gloo on the CPU, NCCL on cards,
`--backend gloo` for several ranks on one card); each rank steps its
process_local_batch_slice of the pairs, pair i drawing from
pair_generator(device, cfg.seed + 1, step, i). With `--world 1` the step
runs in this process on all the pairs, without a process group. The
learning rate is scaled by the number of pairs, not by the world size, so
that both runs take the same update.

Each rank writes rank<r>.npz: per step s (1-based) the reduced metrics
("step<s>:metric:<name>"), the gradients handed to the optimizer (the
mean across ranks; "step<s>:grad:<name>") and the parameters after the
step ("step<s>:param:<name>"; step 0 is the start), the step's seconds
and the gradients' all-reduce milliseconds (host clock between device
syncs; "step<s>:seconds", "step<s>:allreduce_ms"), plus "step" and
"skipped".
`--nan_pair i` fills pair i's reference features with NaN. The spawned
ranks have RANK_TIMEOUT seconds; the launcher stops them all when one
fails or time is up.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_POINTS = 500  # per cloud of each pair
RANK_TIMEOUT = 300  # seconds for all ranks together


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--pairs", type=int, nargs="+", default=[0, 1],
                        help="random_pair seeds of the global batch")
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    parser.add_argument("--nan_pair", type=int, default=None)
    parser.add_argument("--threads", type=int, default=None, help="torch.set_num_threads")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return parser


def run_rank(args) -> None:
    """Train this process's share of the pairs and write its record."""
    import torch

    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine import trainer
    from gaussreg_tpu_torch.engine.trainer import (
        all_reduce_mean_,
        apply_gradients,
        create_train_state,
        make_optimizer,
        make_train_step,
        pair_generator,
    )
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.parallel import mesh

    if args.threads:
        torch.set_num_threads(args.threads)
    device = "cpu" if args.cpu else None
    if args.rank is None:
        dev, rank = resolve_device(device), 0
    else:
        init = "file://" + os.path.abspath(os.path.join(args.output_dir, "pg_init"))
        dev = mesh.init_distributed(num_processes=args.world, process_id=args.rank,
                                    device=device, backend=args.backend, init_method=init)
        rank = args.rank
    cfg = make_tiny_cfg()
    model = create_model(cfg, dev)
    tx = make_optimizer(cfg, steps_per_epoch=args.steps, world_size=len(args.pairs))
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device=dev)
    mesh.broadcast_params_(state.params.values())
    local = mesh.process_local_batch_slice(len(args.pairs))
    batches = []
    for i in range(local.start, local.stop):
        rp, rf, sp, sf, m = random_pair(cfg, args.pairs[i], num_points=NUM_POINTS)
        if i == args.nan_pair:
            rf = np.full_like(rf, np.nan)
        batches.append(make_pair_batch(cfg, rp, rf, sp, sf, m, device=dev))
    step = make_train_step(model, cfg, tx)

    def host(tensors):
        return {n: t.detach().cpu().numpy().copy() for n, t in tensors.items()}

    record = {f"step0:param:{n}": a for n, a in host(state.params).items()}
    grads, reduce_ms = [], []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def recording(tx, params, opt_state, g):  # the gradients the optimizer is given
        grads.append(host(g))
        return apply_gradients(tx, params, opt_state, g)

    def timed_reduce(tensors):  # the gradients' all-reduce, host clock around a sync
        sync()
        t0 = time.perf_counter()
        all_reduce_mean_(tensors)
        sync()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    for s in range(args.steps):
        gens = [pair_generator(dev, cfg.seed + 1, s, i) for i in range(local.start, local.stop)]
        trainer.apply_gradients, trainer.all_reduce_mean_ = recording, timed_reduce
        try:
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, batches, gens)
            sync()
            record[f"step{s + 1}:seconds"] = time.perf_counter() - t0
        finally:
            trainer.apply_gradients, trainer.all_reduce_mean_ = apply_gradients, all_reduce_mean_
        record[f"step{s + 1}:allreduce_ms"] = reduce_ms[-1]
        record.update({f"step{s + 1}:grad:{n}": a for n, a in grads[-1].items()})
        record.update({f"step{s + 1}:metric:{k}": float(v) for k, v in metrics.items()})
        record.update({f"step{s + 1}:param:{n}": a for n, a in host(state.params).items()})
    record.update(step=state.step, skipped=state.skipped, world=mesh.world_size())
    np.savez(os.path.join(args.output_dir, f"rank{rank}.npz"), **record)
    if args.rank is not None:
        torch.distributed.destroy_process_group()


def launch_ranks(module: str, world: int, output_dir: str, argv, timeout: float) -> int:
    """Start `world` processes of `python -m <module> argv --rank r`, each
    logging to <output_dir>/rank<r>.log, and wait for them all: until every
    one has exited, one has failed or `timeout` seconds are up; then stop
    those still running. Returns 0 when all exited with 0, else 1 after
    printing the logs' ends."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank runs on this host
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(output_dir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--rank", str(rank)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + timeout
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if None not in rcs or any(rcs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if not any(rc is None or rc for rc in rcs):
        return 0
    for rank, rc in enumerate(rcs):
        with open(os.path.join(output_dir, f"rank{rank}.log")) as f:
            print(f"rank {rank} ({'stopped' if rc is None else f'exit {rc}'}):\n"
                  f"{f.read()[-4000:]}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.world > 1 and args.rank is None:
        return launch_ranks("gaussreg_tpu_torch.tools.ddp_check", args.world, args.output_dir,
                            argv, RANK_TIMEOUT)
    run_rank(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
