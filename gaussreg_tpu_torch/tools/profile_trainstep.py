"""Train-step attribution (port of tools/profile_trainstep.py, with the same
flags and lines, plus --tiny and --cpu).

Where does a make_cfg() train step's time go? Stages timed in isolation on
one synthetic pair (random_pair(cfg, 0), up to 30 720 points), by the host
clock ending in a device sync:

  - model forward (loss scalar only)
  - model forward + backward (grads)
  - the full train step (forward + backward + Adam), median of 5 after 2

--trace [DIR] runs one more train step under torch.profiler: device time by
kernel name, the device's busy share, and device time per stage of the
forward, the loss, the backward and the optimizer update (the program's
own spans, engine/debug.py `annotate`); with DIR the chrome trace is kept
there.

    python -m gaussreg_tpu_torch.tools.profile_trainstep [--trace [DIR]]
        [--only SUBSTRING] [--tiny] [--cpu]

The JAX tool reused a training run's on-disk batch cache; this one builds
the pair. Runs on CUDA unless --cpu is given: without a card the default
raises.
"""

from __future__ import annotations

import argparse
import time


def build(cfg, device):
    """(model, state, tx, batch): seeded weights (create_train_state),
    Adam at 256 steps per epoch, pair 0."""
    import torch

    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.trainer import create_train_state, make_optimizer
    from gaussreg_tpu_torch.models.registration import create_model

    model = create_model(cfg, device)
    tx = make_optimizer(cfg, steps_per_epoch=256)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device)
    batch = make_pair_batch(cfg, *random_pair(cfg, 0), device=device)
    return model, state, tx, batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    help="profile one step; keep the chrome trace in this directory if given")
    ap.add_argument("--only", default=None, help="substring stage filter")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import torch

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.trainer import make_train_step, pair_generator
    from gaussreg_tpu_torch.models.losses import overall_loss
    from gaussreg_tpu_torch.tools.profiling import host_slope, profile_call, sync

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    model, state, tx, batch = build(cfg, dev)

    def loss_of(i):
        pb = batch._replace(features=batch.features + 1e-6 * i)
        out = model(pb, pair_generator(dev, 0, i), train=True, with_transform=False)
        return overall_loss(cfg, out, pb.transform)["loss"]

    def fwd(i):
        with torch.no_grad():
            return loss_of(i)

    def fwd_bwd(i):
        for p in state.params.values():
            p.grad = None
        loss_of(i).backward()
        leaves = [p.grad for p in state.params.values() if p.grad is not None]
        return sum(g.abs().sum() for g in leaves[::7])

    for name, fn in (("model fwd (loss)", fwd), ("model fwd+bwd (grads)", fwd_bwd)):
        if not args.only or args.only in name:
            host_slope(name, fn, dev, r_lo=1, r_hi=4)
    for p in state.params.values():
        p.grad = None

    # the full step: the state is updated in place, so no slope; the median
    # of timed singles, each input perturbed
    train_step = make_train_step(model, cfg, tx)
    times = []
    st = state
    for i in range(7):
        b = batch._replace(features=batch.features + 1e-6 * i)
        t0 = time.perf_counter()
        st, metrics = train_step(st, [b], [pair_generator(dev, 1, i, 0)])
        float(metrics["loss"])  # host materialization
        times.append(time.perf_counter() - t0)
    mid = sorted(times[2:])
    print(
        f"full train step (median of {len(mid)}): {mid[len(mid) // 2] * 1e3:.0f} ms"
        f"   all={['%.0f' % (t * 1e3) for t in times]}"
    )

    if args.trace is not None:
        b = batch._replace(features=batch.features + 1e-5)

        def one_step():
            nonlocal st
            st, m = train_step(st, [b], [pair_generator(dev, 1, 999, 0)])
            float(m["loss"])

        sync(dev)
        profile_call(one_step, dev, "one train step", save_to=args.trace or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
