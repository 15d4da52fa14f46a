"""Attribution helpers of the profile tools (profile_eval, profile_trainstep,
profile_fine): a host-clock slope, and the report of one call under
torch.profiler (device time by kernel name, the device's busy share, device
time by stage).

A stage is one of the program's own spans (engine/debug.py `annotate`,
`record_function` ranges while a profiler records): the pyramid
(`pair_batch`), the model's layers in models/registration.py, and the train
step's `loss`, `backward` and `optimizer` in engine/trainer.py.

A kernel is given to the stage in whose window on the device it starts:
the window runs from the first to the last device event whose launch (the
runtime call with the same correlation id) lies inside the stage's range
on the host. Kernels that a ctypes wrapper launches carry no correlation
to a torch op, but they start inside their stage's window, between the
stage's torch kernels.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

# in the order a call runs them: the pyramid, then an eval forward's or a train step's
STAGES = ("pair_batch", "partition", "backbone", "transformer", "gt_overlaps", "matching",
          "gt_sampling", "patch_scores", "sinkhorn", "LGR", "RANSAC", "loss", "backward",
          "optimizer")

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_slope(name: str, fn: Callable[[int], object], device, r_lo: int = 2, r_hi: int = 6,
               n_meas: int = 3) -> float:
    """Seconds per call of fn(i) by the host clock: r calls fn(k), fn(k+1),
    ... (fn perturbs its inputs by its argument) ended by a device sync,
    the fastest of n_meas; the slope between r_lo and r_hi calls drops the
    fixed cost of a measurement. Prints the JAX tools' `timed_slope` line."""
    fn(0)  # warm-up: builds the kernels, fills the allocator
    sync(device)
    k = 1

    def meas(r):
        nonlocal k
        best = float("inf")
        for _ in range(n_meas):
            t0 = time.perf_counter()
            for _ in range(r):
                fn(k)
                k += 1
            sync(device)
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = meas(r_lo), meas(r_hi)
    per = (t_hi - t_lo) / (r_hi - r_lo)
    print(f"{name:45s} {per * 1e3:8.2f} ms/rep   (lo {t_lo * 1e3:.0f} hi {t_hi * 1e3:.0f})",
          flush=True)
    return per


def _trace_events(prof, save_to: Optional[str] = None) -> List[dict]:
    """The complete events of `prof`'s chrome trace, kept in `save_to`
    (a directory) when given."""
    with tempfile.TemporaryDirectory() as tmp:
        if save_to:
            os.makedirs(save_to, exist_ok=True)
        path = os.path.join(save_to or tmp, "trace.json")
        prof.export_chrome_trace(path)
        if save_to:
            print(f"trace written to {path}")
        with open(path) as f:
            return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def attribute(events: List[dict]) -> Tuple[float, Dict[str, float], Dict[str, Tuple[float, int]],
                                           bool]:
    """From a chrome trace's complete events: (busy ms, {stage: ms},
    {kernel name: (ms, count)}, on_device). On a trace without device
    events (a CPU run) busy is 0 and each stage's ms is its host range's."""
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") in STAGES]
    by_name: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += e["dur"] / 1e3
        by_name[e["name"]][1] += 1
    stages: Dict[str, float] = collections.defaultdict(float)
    if not dev:
        for r in ranges:
            stages[r["name"]] += r["dur"] / 1e3
        return 0.0, dict(stages), {k: tuple(v) for k, v in by_name.items()}, False

    # host-side CUDA API calls (cat "cuda_runtime" and the like)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    ranges.sort(key=lambda r: r["ts"])
    windows = []  # (start, end, stage) on the device's clock
    for r in ranges:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        inside = [e for e in dev
                  if lo <= launch_ts.get(e.get("args", {}).get("correlation"), -1.0) <= hi]
        if inside:
            windows.append((min(e["ts"] for e in inside),
                            max(e["ts"] + e["dur"] for e in inside), r["name"]))
    for e in dev:
        hit = [w for w in windows if w[0] <= e["ts"] < w[1]]
        if hit:  # the innermost window, should ranges nest
            stages[min(hit, key=lambda w: w[1] - w[0])[2]] += e["dur"] / 1e3
    busy = sum(e["dur"] for e in dev) / 1e3
    return busy, dict(stages), {k: tuple(v) for k, v in by_name.items()}, True


def profile_call(fn: Callable[[], object], device, what: str, top: int = 40,
                 save_to: Optional[str] = None) -> Dict[str, float]:
    """Run fn() once under torch.profiler (the device's activity too on a
    card); print the device time by kernel name (the heaviest `top`), the
    device's busy share of the wall time and the time of each stage; with
    `save_to` keep the chrome trace there. Returns {"busy_ms", "wall_ms",
    "<stage>_ms", ...}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, stages, by_name, on_device = attribute(_trace_events(prof, save_to))
    if on_device:
        print(f"\n== device op aggregate (total {busy:.1f} ms) ==")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"{ms:9.3f} ms  {n:5d}x  {name[:100]}")
        print(f"{what}: wall {wall_ms:.1f} ms (profiled), device busy {busy:.1f} ms "
              f"({100 * busy / wall_ms:.1f}%), {sum(n for _, n in by_name.values())} device "
              "events")
    else:
        print(f"{what}: wall {wall_ms:.1f} ms (profiled), device busy not measured (no "
              "device events: a CPU run)")
    if stages:
        print(f"== {'device' if on_device else 'host'} time by stage ==")
    for stage in STAGES:
        if stage in stages:
            print(f"{stages[stage]:9.3f} ms  {stage}")
    if on_device and stages:
        print(f"{busy - sum(stages.values()):9.3f} ms  other (outside every stage)")
    return {"busy_ms": busy, "wall_ms": wall_ms, **{f"{s}_ms": ms for s, ms in stages.items()}}
