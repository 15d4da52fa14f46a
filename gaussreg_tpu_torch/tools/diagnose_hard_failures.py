"""Diagnose the hard-tier failures (port of tools/diagnose_hard_failures.py,
with its positional seeds and JSON lines, plus --ckpt, --tiny and
--cpu).

The JAX transcript checkpoints/eval_transcript_hard.json fails seeds
20000004 and 20000030 (180-degree flips, the first with
search_overflow=1820) and 20000006 (a translation failure). Each is re-run
at window_rows0 in {2, 3, 4} to test whether level-0 window truncation (the
only nonzero overflow in either transcript) is causal: wider level-0
windows mean wider window selections for the two level-0 searches.

    python -m gaussreg_tpu_torch.tools.diagnose_hard_failures [SEED ...]
        [--ckpt checkpoints/synthetic_coarse.msgpack] [--tiny] [--cpu]

One JSON line per (window_rows0, seed): the eval step's metrics rounded to
4 digits. RANSAC draws come from a torch.Generator seeded seed % 97 (the
JAX tool's PRNGKey(seed % 97)). Runs on CUDA unless --cpu is given: without
a card the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "checkpoints", "synthetic_coarse.msgpack")
SEEDS = (20000004, 20000030, 20000006)
WINDOW_ROWS = (2, 3, 4)


def with_window_rows0(cfg, window_rows0: int):
    """`cfg` with its level-0 search window set to `window_rows0` rows."""
    return dataclasses.replace(
        cfg, capacity=dataclasses.replace(cfg.capacity, window_rows0=window_rows0)
    )


def diagnose_seed(model, cfg, seed: int, device) -> Dict[str, float]:
    """The eval step's metrics of hard-tier pair `seed`, its pyramid built
    at `cfg`'s window_rows0, rounded as the JAX tool prints them."""
    import torch

    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.trainer import make_eval_step

    batch = make_pair_batch(cfg, *random_pair(cfg, seed, tier="hard"), device=device)
    _, metrics = make_eval_step(model, cfg)(
        batch, torch.Generator(device=device).manual_seed(seed % 97))
    return {k: round(float(v), 4) for k, v in metrics.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", type=int, nargs="*", default=list(SEEDS))
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model

    dev = resolve_device("cpu" if args.cpu else None)
    base = make_tiny_cfg() if args.tiny else make_cfg()
    model = create_model(base, dev)
    model.load_state_dict(load_checkpoint(args.ckpt))
    for wr in WINDOW_ROWS:
        cfg = with_window_rows0(base, wr)
        for seed in args.seeds:
            out = diagnose_seed(model, cfg, seed, dev)
            print(json.dumps({"seed": seed, "window_rows0": wr, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
