"""Training smoke test (port of tools/smoke_train.py): train the coarse
model on a small synthetic set and report registration metrics before
and after, so that gradients, losses, GT supervision and the eval path are
shown to fit together end to end.

    python -m gaussreg_tpu_torch.tools.smoke_train [--steps 200] [--pairs 16]
        [--tiny] [--cpu]

Runs on CUDA unless --cpu is given: without a card, the default raises
instead of falling back to the CPU. Prints IMPROVED and exits 0 when RRE
and RMSE fell or the coarse matching precision rose by more than 0.05.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--pairs", type=int, default=16)
    parser.add_argument("--val_pairs", type=int, default=4)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    import torch

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.data.synthetic import make_synthetic_batch
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.trainer import (
        adam,
        create_train_state,
        make_eval_step,
        make_train_step,
        pair_generator,
    )
    from gaussreg_tpu_torch.models.registration import create_model

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, lr=args.lr))
    model = create_model(cfg, dev)

    print("building batches...", flush=True)
    num_points = 800 if args.tiny else 20000
    batches = make_synthetic_batch(cfg, range(args.pairs), num_points=num_points, device=dev)
    val_batches = make_synthetic_batch(cfg, range(10_000, 10_000 + args.val_pairs),
                                       num_points=num_points, device=dev)

    tx = adam(args.lr)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device=dev)
    train_step = make_train_step(model, cfg, tx)
    eval_step = make_eval_step(model, cfg)

    def evaluate(tag):
        ms = []
        for i, vb in enumerate(val_batches):
            _, metrics = eval_step(vb, torch.Generator(device=dev).manual_seed(100 + i))
            ms.append({k: float(v) for k, v in metrics.items()})
        agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        print(
            f"[{tag}] RRE {agg['RRE']:.2f} deg, RTE {agg['RTE']:.3f}, "
            f"RSE {agg['RSE']:.3f}, RMSE {agg['RMSE']:.3f}, RR {agg['RR']:.2f}",
            flush=True,
        )
        return agg

    before = evaluate("before")
    t0 = time.time()
    for step in range(args.steps):
        state, metrics = train_step(state, [batches[step % len(batches)]],
                                    [pair_generator(dev, 1, step, 0)])
        if step == 0:
            first_pir = float(metrics["PIR"])
        last_pir = float(metrics["PIR"])
        if (step + 1) % 20 == 0:
            print(
                f"step {step + 1}: loss {float(metrics['loss']):.4f} "
                f"(c {float(metrics['c_loss']):.4f} f {float(metrics['f_loss']):.4f}) "
                f"PIR {float(metrics['PIR']):.3f} "
                f"[{(time.time() - t0) / (step + 1):.2f}s/step]",
                flush=True,
            )
    after = evaluate("after")

    print(f"coarse matching precision: {first_pir:.3f} -> {last_pir:.3f}", flush=True)
    improved = (
        after["RRE"] < before["RRE"] and after["RMSE"] < before["RMSE"]
    ) or last_pir > first_pir + 0.05
    print("IMPROVED" if improved else "NOT IMPROVED", flush=True)
    return 0 if improved else 1


if __name__ == "__main__":
    sys.exit(main())
