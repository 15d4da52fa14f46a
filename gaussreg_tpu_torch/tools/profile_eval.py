"""Eval-forward attribution for the registration model (port of
tools/profile_eval.py, with the same flags and lines, plus --tiny and
--cpu).

Two views:
  1. stage times by the host clock ending in a device sync, the slope
     between 2 and 6 forwards (with_transform False vs True): where a
     pair's time goes;
  2. --trace: one eval forward under torch.profiler, device time by kernel
     name, the device's busy share of the wall time, and device time per
     stage (backbone, transformer, matching, Sinkhorn, LGR, RANSAC: the
     program's own spans, engine/debug.py `annotate`).

    python -m gaussreg_tpu_torch.tools.profile_eval [--trace] [--stages]
        [--tiny] [--cpu]

The model has random weights from a seeded generator (the JAX tool's
model.init at PRNGKey(0)), the pair random_pair(cfg, 0) at the config's
point limit. Runs on CUDA unless --cpu is given: without a card the
default raises.
"""

from __future__ import annotations

import argparse


def build(cfg, device):
    """(model, batch): seeded random weights and pair 0 at the point limit."""
    import torch

    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.models.registration import create_model

    model = create_model(cfg, device)
    model.reset_parameters(torch.Generator().manual_seed(0))
    n = min(cfg.train.point_limit, cfg.capacity.levels[0])
    batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=n), device=device)
    return model, batch


def _perturbed(batch, i):
    return batch._replace(features=batch.features + 1e-6 * i)


def stages(model, batch, device):
    """The two forwards' seconds per call (host clock, device sync)."""
    import torch

    from gaussreg_tpu_torch.tools.profiling import host_slope

    gen = torch.Generator(device=device)

    @torch.no_grad()
    def fwd_no_t(i):
        out = model(_perturbed(batch, i), gen, train=False, with_transform=False)
        return out["ref_feats_c"].sum()

    @torch.no_grad()
    def fwd_full(i):
        out = model(_perturbed(batch, i), gen.manual_seed(i), train=False, with_transform=True)
        return out["estimated_transform"].sum()

    return {
        "no_transform_s": host_slope("eval fwd, no transform (backbone+tfm+OT)", fwd_no_t,
                                     device),
        "full_s": host_slope("eval fwd, full (+LGR+RANSAC)", fwd_full, device),
    }


def trace(model, batch, device):
    """One full eval forward under torch.profiler, by the program's spans."""
    import torch

    from gaussreg_tpu_torch.tools.profiling import profile_call

    gen = torch.Generator(device=device)

    @torch.no_grad()
    def fwd():
        return model(batch, gen.manual_seed(7), train=False, with_transform=True)

    fwd()  # warm-up outside the trace
    return profile_call(fwd, device, "eval fwd, full")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    model, batch = build(cfg, dev)
    if args.stages or not args.trace:
        stages(model, batch, dev)
    if args.trace:
        trace(model, batch, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
