"""Run one cell of BENCHMARK.json once and print its result line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and per-layer readers are found by name
(portbench/spec.py). The run: set-up (build, weights, inputs drawn from the
seed, every shape warmed up), the measured window of `--seconds` (a closed
loop of the runner's calls, nothing compiled in it), with `--trace 1` a
profiled stretch after it; then the peak memory is read, the program's
state freed, and the plain reference (portbench/reference/) judges the
compared calls. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, breakdown (--trace 1) and
checks (each compared number beside its limit), which standard error also
ends with. Exits non-zero with no result without enough CUDA cards, in a
checkout without the program, or if JAX or the JAX package got loaded."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _process_start() -> float:
    """This process's start on the time.time() clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def _environment(pkg: str) -> None:
    """Keep every build and kernel cache at fixed paths inside the checkout,
    and keep libraries from loading JAX or Flax on their own."""
    build = os.path.join(pkg, "_build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _finite(x: float) -> float:
    """JSON has no infinity: a number that is not finite reads 1e308."""
    return x if math.isfinite(x) else 1e308


def run_cell(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             started: float = None):
    """Run `cell` once on `device`; returns the result dict (without the
    import guard, which `main` applies)."""
    import torch

    from portbench import spec

    started = time.time() if started is None else started
    torch.set_num_threads(2)
    runner = cell.runner().Runner(cell, seed, device)
    runner.setup()
    setup_s = time.time() - started
    values, attempted, failed = runner.window(seconds)
    lat = sorted(runner.latencies)
    print(f"portbench: window {attempted} calls, latency s min {lat[0]:.4f} median "
          f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}; in order "
          f"{[round(x, 4) for x in runner.latencies]}", file=sys.stderr)
    trace = runner.traced() if traced else None
    cuda = device.startswith("cuda")
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips if cuda else 0,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0,
    }
    runner.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = runner.check()
    limits = cell.traffic["limits"]
    checks = {"failed_calls": {"value": failed, "limit": 0}}
    for name, limit in limits.items():
        checks[name] = {"value": _finite(numbers.get(name, math.inf)), "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    values["setup_s"] = setup_s
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = trace.breakdown
    result["checks"] = checks
    result["readings"] = {k: v for k, v in numbers.items() if k not in checks}
    return result


def main(argv=None) -> int:
    started = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import guard, spec

    _environment(spec.PKG)
    try:
        import gaussreg_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import peaks

    print(f"portbench: {peaks.power_limit()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result.pop("readings").items():
        print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
