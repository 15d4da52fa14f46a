"""Train-pool against held-out registration quality of a checkpoint (port of
tools/probe_generalization.py, with the same flags and lines, plus --tiny
and --cpu).

Runs the full eval step (LGR + RANSAC transform) on (a) scenes from the
training pool (the epoch-keyed seed pool that the trainval CLI draws from)
and (b) unseen seeds, printing per-pair PIR/RRE/RSE/RMSE/RR. Tells "the
network memorizes the pool" from "the eval path is broken" when val RR is
0.

    python -m gaussreg_tpu_torch.tools.probe_generalization --weights W.msgpack
        [--pairs 4] [--pool_size 256] [--tiny] [--cpu]

RANSAC draws come from a torch.Generator seeded seed % 997 (the JAX tool's
PRNGKey(seed % 997)). Runs on CUDA unless --cpu is given: without a card
the default raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterator, List, Sequence

import numpy as np


def seed_groups(cfg, pairs: int, pool_size: int) -> Dict[str, List[int]]:
    """The first `pairs` seeds of the training pool, and as many held-out."""
    pool = np.random.default_rng(cfg.seed).integers(0, 2**31, size=pool_size)
    return {
        "train-pool": [int(s) for s in pool[:pairs]],
        "held-out": [20_000_000 + i for i in range(pairs)],
    }


def evaluate_seeds(model, cfg, seeds: Sequence[int], device) -> Iterator[Dict[str, float]]:
    """The eval step's metrics on random_pair(cfg, seed), seed by seed."""
    import torch

    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.trainer import make_eval_step

    eval_step = make_eval_step(model, cfg)
    for seed in seeds:
        batch = make_pair_batch(cfg, *random_pair(cfg, seed), device=device)
        _, metrics = eval_step(batch, torch.Generator(device=device).manual_seed(seed % 997))
        yield {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", required=True)
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--pool_size", type=int, default=256)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    model = create_model(cfg, dev)
    model.load_state_dict(load_checkpoint(args.weights))
    for name, seeds in seed_groups(cfg, args.pairs, args.pool_size).items():
        for seed, metrics in zip(seeds, evaluate_seeds(model, cfg, seeds, dev)):
            print(
                f"{name} seed={seed}: PIR={metrics.get('PIR', float('nan')):.3f} "
                f"RRE={metrics['RRE']:.2f} "
                f"RSE={metrics['RSE']:.3f} RMSE={metrics['RMSE']:.3f} "
                f"RR={metrics['RR']:.0f}",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
