"""The program's own spans in a cell's traced stretch: device time, idle
time and host waits by the span the host was in.

The program opens a `record_function` span where the work happens
(gaussreg_tpu_torch/engine/debug.py `annotate`): `coarse_call` around each
call of `api.coarse_register_clouds`, and inside it the layers' spans, which
LAYERS maps to the benchmark's layers by name. Spans nest on the one host
thread, so a moment's span is the innermost program span open then. The
benchmark's own ranges (portbench/trace.py `stage_ranges`, `host_spans`)
stay: those that share a name with a program span sit inside it and read
the same; `pyramid` is not a program span, so what happens in it outside
`pair_batch` (the benchmark's syncs) belongs to `coarse_call`.

- Device time of a layer: `trace.attribute` with the layer's outermost
  span names (the window on the device of what the span launched).
- Idle time of a layer: `trace.idle_gaps` by the program's span names,
  each gap given to the innermost program span open when it began.
- A host wait: a synchronizing CUDA runtime call (SYNCS; a blocking copy
  is an asynchronous copy followed by a stream sync), given to the
  innermost program span open around it. Waits whose innermost span is
  `coarse_call` itself (the benchmark's syncs) or none are not counted.

Every function reads a chrome trace's complete events; a layer's number is
None where they hold no `coarse_call` (a program without the spans). No
per-layer metric reads these: a reader gets the reduced `trace.Trace`,
which keeps no events. This is a diagnostic of its own:

    python -m portbench.spans --workload indoor_pairs --seed <n> [--seconds 5]

runs the cell's set-up, a short window and the runner's traced stretch
(marked as in a `--trace 1` run, its events kept), and prints one JSON
line: per call, each span's device ms, idle ms and host waits, the layers'
sums, the host waits by span and by the `aten::` operation the program
called (the outermost `cpu_op` around the wait in its span), and the
runner's own idle gaps by stage beside them.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from portbench import trace as trace_mod

CALL = "coarse_call"
# benchmark layer: (the spans at its top, prefixes of its nested spans)
LAYERS = {
    "pyramid": (("pair_batch",), ("pair_batch.",)),
    "backbone": (("backbone",), ("backbone.",)),
    "transformer and matching": (("partition", "transformer", "matching", "patch_scores",
                                  "sinkhorn"), ("transformer.",)),
    "registration": (("LGR", "RANSAC"), ()),
}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


def layer_of(name: str) -> Optional[str]:
    """The benchmark layer of a program span's name, or None."""
    for layer, (tops, prefixes) in LAYERS.items():
        if name in tops or name.startswith(prefixes):
            return layer
    return None


def _program_names(events: List[dict]) -> List[str]:
    """The program's span names in the events: coarse_call and the layers'."""
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    return sorted(n for n in names if n == CALL or layer_of(n) is not None)


def present(events: List[dict]) -> bool:
    return any(e.get("cat") == "user_annotation" and e.get("name") == CALL for e in events)


def _innermost(ranges: List[Tuple[float, float, str]], ts: float) -> Optional[tuple]:
    open_ = [r for r in ranges if r[0] <= ts < r[1]]
    return min(open_, key=lambda r: r[1] - r[0]) if open_ else None


def device_ms(events: List[dict], layer: str, calls: int) -> Optional[float]:
    """Device ms a call in the windows of the layer's top spans."""
    if not present(events):
        return None
    ops = trace_mod.attribute(events, LAYERS[layer][0])
    return sum(sum(v.values()) for v in ops.values()) / calls


def idle_by_span(events: List[dict]) -> Dict[str, float]:
    """{program span: device idle seconds over the stretch whose gap began
    in it}; gaps that began in no program span are under `outside`."""
    names = _program_names(events)
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in trace_mod._DEVICE_CATS]
    gaps = trace_mod.idle_gaps(events, trace_mod._union(dev), names, top=len(names) + 1)
    return dict(gaps)


def idle_ms(events: List[dict], layer: str, calls: int) -> Optional[float]:
    """Device idle ms a call whose gap began under the layer's spans."""
    if not present(events):
        return None
    gaps = idle_by_span(events)
    return 1e3 * sum(s for n, s in gaps.items() if layer_of(n) == layer) / calls


def waits(events: List[dict]) -> List[Tuple[str, str]]:
    """(innermost program span, aten op) of every host wait in the events,
    those under `coarse_call` itself included; waits in no program span
    are left out."""
    names = set(_program_names(events))
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in names]
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "cpu_op")
    starts = [o[0] for o in ops]
    out = []
    for e in events:
        if not (e.get("cat", "").startswith("cuda_") and e.get("name") in SYNCS):
            continue
        span = _innermost(ranges, e["ts"])
        if span is None:
            continue
        op = "-"
        for i in range(bisect.bisect_right(starts, e["ts"]) - 1, -1, -1):
            lo, hi, name = ops[i]
            if lo < span[0]:
                break
            if hi >= e["ts"] + e["dur"]:
                op = name  # keeps going back: the outermost op in the span
        out.append((span[2], op))
    return out


def host_waits(events: List[dict], calls: int) -> Optional[float]:
    """Host waits a call in the program's layer spans."""
    if not present(events):
        return None
    return sum(1 for span, _ in waits(events) if span != CALL) / calls


def report(events: List[dict], calls: int, window_s: float) -> dict:
    """Per call: each program span's device ms, idle ms and host waits, the
    layers' sums, the waits by (span, aten op), and the stretch's wall and
    busy ms."""
    n = calls
    names = _program_names(events)
    dev = {s: sum(v.values()) / n for s, v in trace_mod.attribute(events, names).items()}
    idle = {s: 1e3 * v / n for s, v in idle_by_span(events).items()}
    sites = waits(events)
    by_span = collections.Counter(s for s, _ in sites)
    spans = {s: {"device_ms": dev.get(s, 0.0), "idle_ms": idle.get(s, 0.0),
                 "waits": by_span.get(s, 0) / n}
             for s in sorted(set(dev) | set(idle) | set(by_span))}
    layers = {layer: {"device_ms": device_ms(events, layer, n),
                      "idle_ms": idle_ms(events, layer, n)} for layer in LAYERS}
    busy = trace_mod._union([(e["ts"], e["ts"] + e["dur"]) for e in events
                             if e.get("cat") in trace_mod._DEVICE_CATS])
    return {
        "calls": n,
        "wall_ms": 1e3 * window_s / n,
        "busy_ms": sum(hi - lo for lo, hi in busy) / 1e3 / n,
        "host_waits": host_waits(events, n),
        "layers": layers,
        "spans": spans,
        "wait_sites": [[s, op, c / n] for (s, op), c in
                       sorted(collections.Counter(sites).items(), key=lambda kv: -kv[1])],
    }


def traced(runner) -> Tuple[trace_mod.Trace, List[dict]]:
    """runner.traced(), and the events its profile reduced (kept by
    wrapping `trace.reduce` for the call's length)."""
    kept: List[List[dict]] = []
    reduce = trace_mod.reduce

    def keep(events, *args, **kwargs):
        kept.append(events)
        return reduce(events, *args, **kwargs)

    trace_mod.reduce = keep
    try:
        tr = runner.traced()
    finally:
        trace_mod.reduce = reduce
    return tr, kept[-1]


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the program's spans in a cell's traced stretch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    from portbench import peaks, run, spec

    run._environment(spec.PKG)
    cell = spec.load_cell(args.workload)
    runner = cell.runner().Runner(cell, args.seed, "cuda")
    runner.setup()
    runner.window(args.seconds)
    tr, events = traced(runner)
    out = report(events, tr.calls, tr.window_s)
    out["stage_idle_ms"] = {s: 1e3 * v / tr.calls for s, v in tr.breakdown["idle_gaps"]}
    out["power"] = peaks.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
