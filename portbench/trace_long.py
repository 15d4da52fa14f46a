"""`trace.profile` for stretches of ~10^6 device operations: the same
reduction as portbench/trace.py `reduce` (the same `Trace`, stage by stage
and operation by operation), computed by sorting and searching where
`reduce` compares every range with every operation, which at a fine call's
~4 000 operations a step and ~400 ranges would take minutes. A stage's
window, the innermost window an operation starts in and the stage an idle
gap begins under follow `trace.attribute` and `trace.idle_gaps`, ties
included."""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, List

import numpy as np

from portbench.trace import _DEVICE_CATS, OUTSIDE, Trace, _union


def _innermost(points: np.ndarray, spans: List[tuple]) -> np.ndarray:
    """For each of the sorted `points`, the index into `spans` [(lo, hi),
    ...] of the shortest span with lo <= point < hi (the first such in
    `spans`' order among equally short ones), or -1."""
    owner = np.full(points.shape[0], -1, dtype=np.int64)
    order = sorted(range(len(spans)), key=lambda i: (-(spans[i][1] - spans[i][0]), -i))
    for i in order:
        lo, hi = spans[i]
        a = np.searchsorted(points, lo, side="left")
        b = np.searchsorted(points, hi, side="left")
        owner[a:b] = i
    return owner


def attribute(events: List[dict], stages: Iterable[str]) -> Dict[str, Dict[str, float]]:
    """`trace.attribute`: {stage: {device operation name: ms}}."""
    stages = set(stages)
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    ranges = sorted((e for e in events
                     if e.get("cat") == "user_annotation" and e.get("name") in stages),
                    key=lambda r: r["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    if not dev:
        return {}
    ts = np.array([e["ts"] for e in dev], dtype=np.float64)
    end = ts + np.array([e["dur"] for e in dev], dtype=np.float64)
    launch = np.array([launch_ts.get(e.get("args", {}).get("correlation"), -1.0)
                       for e in dev], dtype=np.float64)
    by_launch = np.argsort(launch, kind="stable")
    launch_sorted = launch[by_launch]
    windows = []
    for r in ranges:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        a = np.searchsorted(launch_sorted, lo, side="left")
        b = np.searchsorted(launch_sorted, hi, side="right")
        if b > a:
            inside = by_launch[a:b]
            windows.append((float(ts[inside].min()), float(end[inside].max()), r["name"]))
    by_ts = np.argsort(ts, kind="stable")
    owner = _innermost(ts[by_ts], [(w[0], w[1]) for w in windows])
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for k, w in zip(by_ts, owner):
        if w >= 0:
            e = dev[k]
            out[windows[w][2]][e["name"]] += e["dur"] / 1e3
    return {k: dict(v) for k, v in out.items()}


def idle_gaps(events: List[dict], busy, stages: List[str], top: int = 10) -> List[list]:
    """`trace.idle_gaps`: [[stage, seconds], ...], the largest first."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in set(stages)]
    ends = np.array([hi for _, hi in busy[:-1]], dtype=np.float64)
    gaps = np.array([lo for lo, _ in busy[1:]], dtype=np.float64) - ends
    order = np.argsort(ends, kind="stable")
    owner = np.empty_like(order)
    owner[order] = _innermost(ends[order], [(r[0], r[1]) for r in ranges])
    by_stage: Dict[str, float] = collections.defaultdict(float)
    for o, g in zip(owner, gaps):
        by_stage[ranges[o][2] if o >= 0 else OUTSIDE] += g / 1e6
    return [[s, v] for s, v in sorted(by_stage.items(), key=lambda kv: -kv[1])[:top]]


def reduce(events: List[dict], stages: List[str], calls: int, window_s: float) -> Trace:
    """`trace.reduce`."""
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    kernels: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        kernels[e["name"]][0] += e["dur"] / 1e3
        kernels[e["name"]][1] += 1
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    trace = Trace(calls=calls, window_s=window_s, busy_s=busy_s,
                  stage_ops=attribute(events, stages),
                  kernels={k: (v[0], v[1]) for k, v in kernels.items()})
    trace.breakdown = {
        "device_ops": [[name, ms / 1e3] for name, (ms, _) in
                       sorted(trace.kernels.items(), key=lambda kv: -kv[1][0])[:10]],
        "idle_gaps": idle_gaps(events, busy, stages),
    }
    return trace


def profile(fn: Callable[[], int], stages: Iterable[str]) -> Trace:
    """`trace.profile` with this module's reduction; only the events it reads
    (device operations, runtime calls that carry a correlation, the stages'
    ranges) are kept from the exported trace."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    stages = list(stages)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    names = set(stages)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("ph") == "X" and (
                          e.get("cat") in _DEVICE_CATS
                          or (e.get("cat", "").startswith("cuda_")
                              and "correlation" in e.get("args", {}))
                          or (e.get("cat") == "user_annotation" and e.get("name") in names))]
    return reduce(events, stages, calls, window_s)
