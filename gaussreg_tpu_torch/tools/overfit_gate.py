"""Gated overfit experiment (port of tools/overfit_gate.py): train on a
small fixed set of pairs and evaluate on those same pairs, reporting the
stage chain PIR -> fine IR -> RRE/RMSE/RR. The claim "the network
registers" must first hold in the overfit limit.

    python -m gaussreg_tpu_torch.tools.overfit_gate --pairs 1 --steps 400
        [--lr 3e-4] [--tiny] [--cpu] [--dump_dir DIR]

Runs on CUDA unless --cpu is given: without a card, the default raises
instead of falling back to the CPU. Prints "GATE PASS" and exits 0 iff
the final RR is 1.0 and RRE < 5 degrees, else "GATE FAIL" and exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed_base", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument(
        "--dump_dir", default=None,
        help="save final params (msgpack) + est/gt transforms (npz) here",
    )
    args = ap.parse_args(argv)

    import torch

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
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
    model = create_model(cfg, dev)

    print(f"building {args.pairs} pair batches...", flush=True)
    batches = [make_pair_batch(cfg, *random_pair(cfg, args.seed_base + i), device=dev)
               for i in range(args.pairs)]

    tx = adam(args.lr)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device=dev)
    train_step = make_train_step(model, cfg, tx)
    eval_step = make_eval_step(model, cfg)

    def evaluate(tag, dump=False):
        ms = []
        for i, vb in enumerate(batches):
            est, metrics = eval_step(vb, torch.Generator(device=dev).manual_seed(100 + i))
            ms.append({k: float(v) for k, v in metrics.items()})
            if dump and args.dump_dir:
                os.makedirs(args.dump_dir, exist_ok=True)
                np.savez(os.path.join(args.dump_dir, f"transforms_{i}.npz"),
                         est=est.cpu().numpy(), gt=vb.transform.cpu().numpy())
        agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        print(
            f"[{tag}] PIR {agg['PIR']:.3f} IR {agg['IR']:.3f} | "
            f"RRE {agg['RRE']:.2f}deg RTEabs {agg['RTE_abs']:.3f} "
            f"RSE {agg['RSE']:.3f} RMSE {agg['RMSE']:.3f} RR {agg['RR']:.2f}",
            flush=True,
        )
        return agg

    evaluate("step 0")
    t0 = time.time()
    for step in range(1, args.steps + 1):
        state, metrics = train_step(state, [batches[(step - 1) % len(batches)]],
                                    [pair_generator(dev, 1, step, 0)])
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(
                f"step {step}: loss {m['loss']:.4f} c {m['c_loss']:.4f} "
                f"f {m['f_loss']:.4f} PIR {m['PIR']:.3f} "
                f"({(time.time() - t0) / step:.2f}s/step)",
                flush=True,
            )
        if step % args.eval_every == 0:
            evaluate(f"step {step}")

    final = evaluate("final", dump=True)
    if args.dump_dir:
        from gaussreg_tpu_torch.engine.checkpoint import save_checkpoint

        save_checkpoint(args.dump_dir, "overfit", state.params)
    ok = final["RR"] == 1.0 and final["RRE"] < 5.0
    print(f"GATE {'PASS' if ok else 'FAIL'}: RR={final['RR']} RRE={final['RRE']:.2f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
