"""Evaluate a trained checkpoint on held-out synthetic scene pairs and print
the reference's threshold-recall table (port of tools/eval_synthetic.py,
with the same flags, lines and transcript keys, plus --cpu).

The synthetic twin of the reference's dataset evaluation printout
(reference experiments/.../test.py:200-212: mean RRE/RTE/RSE and the
recalls rre<5/10 deg, rte<0.1/0.2, rse<0.1/0.2, plus RR = RMSE<0.2). Writes
a JSON transcript next to the checkpoint.

    python -m gaussreg_tpu_torch.tools.eval_synthetic \\
        --weights checkpoints/synthetic_coarse.msgpack [--pairs 32] \\
        [--seed_base 20000000] [--output eval_transcript.json] [--cpu]

Runs on CUDA unless --cpu is given: without a card the default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", required=True)
    parser.add_argument("--pairs", type=int, default=32)
    parser.add_argument(
        "--seed_base", type=int, default=20_000_000,
        help="held-out seed block (training draws epoch-keyed rng integers; "
        "val uses 10_000_000+i; tests use 20_000_000+i)",
    )
    parser.add_argument("--output", default=None)
    parser.add_argument(
        "--tier", default="easy", choices=("easy", "hard"),
        help="held-out difficulty tier (hard: overlap 0.3-0.65, scale aug "
        "to the reference's 1-4x extremes)",
    )
    parser.add_argument("--tiny", action="store_true",
                        help="tiny capacities (CPU smoke run of the harness itself)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    import torch

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.engine.trainer import make_eval_step
    from gaussreg_tpu_torch.models.registration import create_model

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    model = create_model(cfg, dev)
    model.load_state_dict(load_checkpoint(args.weights))
    eval_step = make_eval_step(model, cfg)

    rows = []
    for i in range(args.pairs):
        seed = args.seed_base + i
        batch = make_pair_batch(cfg, *random_pair(cfg, seed, tier=args.tier), device=dev)
        t0 = time.time()
        _, metrics = eval_step(batch, torch.Generator(device=dev).manual_seed(i))
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["seed"] = seed
        metrics["wall_s"] = time.time() - t0
        rows.append(metrics)
        print(
            f"pair {i:3d} seed {seed}: RRE {metrics['RRE']:7.3f} deg  "
            f"RTE {metrics['RTE']:6.3f}  RSE {metrics['RSE']:6.3f}  "
            f"RMSE {metrics['RMSE']:6.3f}  RR {metrics['RR']:.0f}",
            flush=True,
        )

    def arr(k):
        return np.asarray([r[k] for r in rows])

    summary = {
        "num_pairs": len(rows),
        "tier": args.tier,
        "mean_RRE_deg": float(arr("RRE").mean()),
        "mean_RTE": float(arr("RTE").mean()),
        "mean_RSE": float(arr("RSE").mean()),
        "mean_RMSE": float(arr("RMSE").mean()),
        "recall_RMSE<0.2": float((arr("RMSE") < 0.2).mean()),
        "recall_RRE<5deg": float((arr("RRE") < 5.0).mean()),
        "recall_RRE<10deg": float((arr("RRE") < 10.0).mean()),
        "recall_RTE<0.1": float((arr("RTE") < 0.1).mean()),
        "recall_RTE<0.2": float((arr("RTE") < 0.2).mean()),
        "recall_RSE<0.1": float((arr("RSE") < 0.1).mean()),
        "recall_RSE<0.2": float((arr("RSE") < 0.2).mean()),
    }
    print(json.dumps(summary, indent=2))
    out = args.output or os.path.join(
        os.path.dirname(args.weights) or ".",
        "eval_transcript.json" if args.tier == "easy" else f"eval_transcript_{args.tier}.json",
    )
    with open(out, "w") as f:
        json.dump({"summary": summary, "pairs": rows}, f, indent=1)
    print(f"transcript -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
