"""The traced stretch of a run: torch.profiler over a few calls, with the
program's layers marked from outside, reduced to what the per-layer
readers (portbench/metrics/) and the result's `breakdown` read.

Stages are `record_function` ranges the benchmark opens around the
program's calls, never inside the program: forward hooks on submodules and
wrappers on module attributes, undone on exit (`stage_ranges`). A device
event is given to the stage in whose window on the device it starts; the
window of a stage runs from the first to the last device event launched
(same correlation id) while the stage's host range was open. Kernels that a
ctypes wrapper launches carry no correlation, but start inside their
stage's window (frozen copy of the port's `tools/profiling.py` `attribute`).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside"


@contextlib.contextmanager
def stage_ranges(hooks: Iterable[Tuple[str, object]] = (),
                 wrappers: Iterable[Tuple[str, object, str]] = ()):
    """Open a `record_function(stage)` range around each forward of the
    given (stage, nn.Module) pairs and each call of the given (stage, module,
    attribute) functions while inside."""
    from torch.autograd.profiler import record_function

    open_ranges: Dict[str, List] = collections.defaultdict(list)
    handles = []
    for stage, sub in hooks:
        def pre(_mod, _args, stage=stage):
            rf = record_function(stage)
            rf.__enter__()
            open_ranges[stage].append(rf)

        def post(_mod, _args, _out, stage=stage):
            open_ranges[stage].pop().__exit__(None, None, None)

        handles += [sub.register_forward_pre_hook(pre), sub.register_forward_hook(post)]
    saved = []
    for stage, module, attr in wrappers:
        orig = getattr(module, attr)

        def wrapper(*args, _orig=orig, _stage=stage, **kwargs):
            with record_function(_stage):
                return _orig(*args, **kwargs)

        saved.append((module, attr, orig))
        setattr(module, attr, wrapper)
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)


@contextlib.contextmanager
def host_spans(spans: Dict[str, List[float]], wrappers: Iterable[Tuple[str, object, str]]):
    """Time each call of the given (span, module, attribute) functions by the
    host clock, from a device sync before it to one after it, into
    spans[span] (seconds), and mark it as a stage of the same name."""
    import torch
    from torch.autograd.profiler import record_function

    saved = []
    for span, module, attr in wrappers:
        orig = getattr(module, attr)

        def wrapper(*args, _orig=orig, _span=span, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(_span):
                out = _orig(*args, **kwargs)
                torch.cuda.synchronize()
            spans.setdefault(_span, []).append(time.perf_counter() - t0)
            return out

        saved.append((module, attr, orig))
        setattr(module, attr, wrapper)
    try:
        yield
    finally:
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def attribute(events: List[dict], stages: Iterable[str]) -> Dict[str, Dict[str, float]]:
    """{stage: {device operation name: ms}} from a chrome trace's complete
    events."""
    stages = set(stages)
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    ranges = sorted((e for e in events
                     if e.get("cat") == "user_annotation" and e.get("name") in stages),
                    key=lambda r: r["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    windows = []  # (start, end, stage) on the device's clock
    for r in ranges:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        inside = [e for e in dev
                  if lo <= launch_ts.get(e.get("args", {}).get("correlation"), -1.0) <= hi]
        if inside:
            windows.append((min(e["ts"] for e in inside),
                            max(e["ts"] + e["dur"] for e in inside), r["name"]))
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for e in dev:
        hit = [w for w in windows if w[0] <= e["ts"] < w[1]]
        if hit:  # the innermost window, should ranges nest
            out[min(hit, key=lambda w: w[1] - w[0])[2]][e["name"]] += e["dur"] / 1e3
    return {k: dict(v) for k, v in out.items()}


@dataclass
class Trace:
    """What the traced stretch gives the per-layer readers."""

    calls: int  # the calls profiled
    window_s: float  # the profiled stretch's wall time
    busy_s: float  # the union of the device's operations in it
    stage_ops: Dict[str, Dict[str, float]]  # device ms by stage and operation name
    kernels: Dict[str, Tuple[float, int]]  # device ms and count by operation name
    host_s: Dict[str, List[float]] = field(default_factory=dict)  # host spans (s) by name
    info: Dict[str, object] = field(default_factory=dict)  # counts, untraced timings, peaks
    breakdown: Dict[str, list] = field(default_factory=dict)

    @property
    def stage_ms(self) -> Dict[str, float]:
        """Device ms by stage over the stretch."""
        return {s: sum(ops.values()) for s, ops in self.stage_ops.items()}

    def kernel_ms(self, symbol: str, stage: Optional[str] = None) -> Optional[float]:
        """Device ms over the stretch (inside `stage` if given) of the
        operations whose name holds `symbol`; None where none ran."""
        ops = ({n: ms for n, (ms, _) in self.kernels.items()} if stage is None
               else self.stage_ops.get(stage, {}))
        hits = [ms for name, ms in ops.items() if symbol in name]
        return sum(hits) if hits else None


def profile(fn: Callable[[], int], stages: Iterable[str]) -> Trace:
    """Run fn() (which returns the calls it made, ending in a device sync)
    under torch.profiler; reduce its trace."""
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    return reduce(events, stages, calls, window_s)


def reduce(events: List[dict], stages: List[str], calls: int, window_s: float) -> Trace:
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


def idle_gaps(events: List[dict], busy: List[Tuple[float, float]], stages: List[str],
              top: int = 10) -> List[list]:
    """The device's idle time between its operations, summed by the stage
    the host was in when each gap began (the innermost open stage range;
    `outside` where none): [[stage, seconds], ...], the largest first."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in set(stages)]
    by_stage: Dict[str, float] = collections.defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        open_ = [r for r in ranges if r[0] <= end < r[1]]
        stage = min(open_, key=lambda r: r[1] - r[0])[2] if open_ else OUTSIDE
        by_stage[stage] += (start - end) / 1e6
    return [[s, v] for s, v in sorted(by_stage.items(), key=lambda kv: -kv[1])[:top]]
