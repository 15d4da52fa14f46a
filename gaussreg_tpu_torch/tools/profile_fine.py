"""Fine-registration wall clock at production scale (port of
tools/profile_fine.py, with its positional arguments and lines, plus
--profile, --tiny and --cpu): 200 000 gaussians, 4 views of 640x480, 100
optimization steps.

For sat_cull True and False (gs/fine_registration.py carries each view's
saturation depth from step to step) it runs fine_register twice and prints
the first call's seconds (kernels built and loaded, allocator filled), the
second's, ms per step, the first call's overflow and final loss, and the
refined RRE/RTE/RSE against the known transform. Seconds are host clock
ending in a device sync. --profile adds, per setting, two steps (and their
probes) under torch.profiler: device time by kernel name and the device's
busy share.

    python -m gaussreg_tpu_torch.tools.profile_fine [N [STEPS]] [--profile]
        [--tiny] [--cpu]

The scene is the JAX tool's: default_rng(0) gaussians in a 2-unit cube, the
source the reference under the inverse of a 1.02-scale similarity.
Runs on CUDA unless --cpu is given: without a card the default raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np


def make_gaussians(n, rng, spread=1.0, device=None):
    """`n` random gaussians (the JAX tool's draws, in its order)."""
    from gaussreg_tpu_torch.gs.fine_registration import gaussians_from_numpy

    means = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(-3.4, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    sh[:, :, 1:] = rng.normal(scale=0.05, size=(n, 3, 15))
    return gaussians_from_numpy(means, scales, quats, opac, sh, device=device)


def make_scene(n, device, num_views=4, width=640, height=480):
    """(ref, src, gt, cams): src is ref under the inverse of gt, the
    transform fine_register should recover from the identity."""
    import torch

    from gaussreg_tpu_torch.gs.fine_registration import (
        default_cameras,
        transform_gaussians_device,
    )
    from gaussreg_tpu_torch.ops.transforms import exp_so3

    ref = make_gaussians(n, np.random.default_rng(0), device=device)
    err = np.eye(4, dtype=np.float32)
    err[:3, :3] = 1.02 * exp_so3(torch.tensor([0.02, -0.015, 0.01])).numpy()
    err[:3, 3] = [0.03, -0.02, 0.01]
    gt = torch.from_numpy(err).to(device)
    with torch.no_grad():
        src = transform_gaussians_device(ref, torch.linalg.inv(gt))
    cams = default_cameras(ref.means.cpu().numpy(), num_views=num_views, width=width,
                           height=height)
    return ref, src, gt, cams


def quality(gt, est):
    """(RRE deg, RTE, RSE) of `est` against `gt`."""
    from gaussreg_tpu_torch.models.metrics import isotropic_transform_error

    return tuple(float(x) for x in isotropic_transform_error(gt, est))


def profile(ref, src, gt, cams, steps, sat_cull, device) -> Dict[str, float]:
    """Two fine_register calls at `sat_cull`; returns the first and second
    call's seconds, ms per step, overflow, final loss and refined errors."""
    import torch

    from gaussreg_tpu_torch.gs.fine_registration import fine_register
    from gaussreg_tpu_torch.tools.profiling import sync

    res: Dict[str, float] = {}
    for call in ("first", "second"):
        sync(device)
        t0 = time.perf_counter()
        out = fine_register(ref, src, torch.eye(4), cams, num_steps=steps, sat_cull=sat_cull)
        final_loss = float(out.losses[-1])  # host materialization
        sync(device)
        res[f"{call}_s"] = time.perf_counter() - t0
        if call == "first":
            res["overflow"], res["final_loss"] = int(out.overflow), final_loss
    res["ms_per_step"] = res["second_s"] / steps * 1e3
    res["RRE"], res["RTE"], res["RSE"] = quality(gt, out.transform)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=200_000)
    ap.add_argument("steps", type=int, nargs="?", default=100)
    ap.add_argument("--profile", action="store_true",
                    help="also profile two steps per setting under torch.profiler")
    ap.add_argument("--tiny", action="store_true",
                    help="1 000 gaussians, 1 view of 64x48, 2 steps (CPU smoke run)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import torch

    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.gs.fine_registration import fine_register
    from gaussreg_tpu_torch.tools.profiling import profile_call

    dev = resolve_device("cpu" if args.cpu else None)
    if args.tiny:
        n, steps, views, width, height = 1_000, 2, 1, 64, 48
    else:
        n, steps, views, width, height = args.n, args.steps, 4, 640, 480
    ref, src, gt, cams = make_scene(n, dev, views, width, height)
    rre0, rte0, ds0 = quality(gt, torch.eye(4, device=dev))
    print(f"coarse residual: RRE {rre0:.3f} deg, RTE {rte0:.4f}, RSE {ds0:.4f}")

    for cull in (True, False):
        r = profile(ref, src, gt, cams, steps, cull, dev)
        print(
            f"sat_cull={cull}: first {r['first_s']:.3f}s (incl build), "
            f"second {r['second_s']:.3f}s -> {r['ms_per_step']:.1f} ms/step "
            f"({len(cams)} views/step), overflow={r['overflow']}, "
            f"final_loss={r['final_loss']:.4f}, refined RRE {r['RRE']:.3f} deg, "
            f"RTE {r['RTE']:.4f}, RSE {r['RSE']:.4f}",
            flush=True,
        )
        if args.profile:
            profile_call(lambda: fine_register(ref, src, torch.eye(4), cams, num_steps=2,
                                               sat_cull=cull),
                         dev, f"sat_cull={cull}: fine_register, 2 steps and their probes",
                         top=12)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
