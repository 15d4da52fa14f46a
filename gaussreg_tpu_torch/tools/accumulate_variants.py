"""Time K6's generic entry (csrc/segment_accumulate.cu,
`gaussreg_segment_accumulate`) and variants of it beside `index_add_` on
the rows of one full-width fine-registration step, on one CUDA card. Run
from the repository root (it takes the scene from chip_smoke.py):

    python -m gaussreg_tpu_torch.tools.accumulate_variants [--rounds 3]

The inputs are chip_smoke.py phase 13(c)'s: one fine step at 200 000
gaussians and 4 views of 640x480, each view's gradient rows and compacted
ids (196 608 rows into 200 001 outputs). Each variant is the source built
with other values of its SEGACC_* switches (one nvcc process per build,
all started together):

- `shipped`: the sum kernel's half-warp takes 8 outputs (SEGACC_OUTS),
  its registers capped for four resident blocks of 256 threads per SM
  (SEGACC_SUM_MIN_BLOCKS, 64 registers);
- `outs4`, `outs16`: 4 or 16 outputs per half-warp;
- `min_blocks1`, `min_blocks3`, `min_blocks5`, `min_blocks6`: registers
  at the compiler's choice (118), or capped for three, five or six blocks.

Every variant must equal `index_add_` in row order (the plain version on
the host) bit for bit. A call's time is its graph slope (utils.timing.slope,
8 against 40 launches) and, beside it, the mean of 20 launches between
CUDA events; the entries and `index_add_` (into zeros, as the plain
version) are taken in turns for --rounds rounds and the median round is
kept, summed over the four views. Then the same for one id holding ~10 %
of the first view's rows and for every row on one id (the long-run paths).

The shipped build's kernels on the first view are also timed by name
under torch.profiler. Prints the run lengths, a line per variant, that
breakdown, the card's name and power limit, and all of it as one JSON
object on the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from gaussreg_tpu_torch.gs.rasterizer import accumulate
from gaussreg_tpu_torch.ops import _cuda
from gaussreg_tpu_torch.utils.timing import slope

VARIANTS = {
    "shipped": [],
    "outs4": ["-DSEGACC_OUTS=4"],
    "outs16": ["-DSEGACC_OUTS=16"],
    "min_blocks1": ["-DSEGACC_SUM_MIN_BLOCKS=1"],
    "min_blocks3": ["-DSEGACC_SUM_MIN_BLOCKS=3"],
    "min_blocks5": ["-DSEGACC_SUM_MIN_BLOCKS=5"],
    "min_blocks6": ["-DSEGACC_SUM_MIN_BLOCKS=6"],
}


def build(out_dir: str):
    """nvcc every variant in parallel; returns name -> C entry point."""
    src = os.path.join(_cuda.CSRC, "segment_accumulate.cu")
    jobs = {}
    for name, flags in VARIANTS.items():
        path = os.path.join(out_dir, f"{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", path, src]
        jobs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    fns = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
        fn = ctypes.CDLL(path).gaussreg_segment_accumulate
        fn.restype = ctypes.c_int
        fn.argtypes = accumulate.GENERIC_KERNEL.argtypes + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def launcher(fn, rows, gid, num_out):
    """A call of one build through the wrapper's scratch layout."""
    n, m = rows.shape[0], num_out + 1

    def run():
        scratch = torch.empty(2 * -(-m // accumulate.SCAN_TILE) + 2 + 2 * m + n,
                              dtype=torch.int32, device=rows.device)
        out = torch.empty((num_out, accumulate.NCHAN), device=rows.device)
        rc = fn(rows.data_ptr(), gid.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                scratch.numel(), num_out, n, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"segment_accumulate variant: launch failed with error {rc}")
        return out

    return run


def index_add(rows, gid, num_out):
    idx = torch.where((gid >= 0) & (gid < num_out), gid, num_out).long()
    return lambda: torch.zeros((num_out + 1, accumulate.NCHAN),
                               device=rows.device).index_add_(0, idx, rows)


def event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_rows():
    """(rows, compacted ids, num_out) of each view of one fine step at
    chip_smoke.py's width."""
    import chip_smoke
    from gaussreg_tpu_torch.gs import fine_registration as fine_mod
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    ref, _, _ = chip_smoke.make_fine_scene(chip_smoke.FINE_GAUSSIANS, 0, "cuda")
    cams = fine_mod.default_cameras(ref.means.cpu().numpy(), num_views=chip_smoke.FINE_VIEWS)
    with chip_smoke.Capture(kernels, "rasterize_backward") as c5, \
            chip_smoke.Capture(kernels, "accumulate_pairs") as c6:
        fine_mod.fine_register(ref, ref, torch.eye(4), cams, num_steps=1)
    torch.cuda.synchronize()
    calls = []
    for (a5, _), (a6, _) in zip(c5.calls[-len(cams):], c6.calls[-len(cams):]):
        grad_rows, _, _, starts, offs, _, num_out = a6
        ids = kernels.compacted_gids(a5[1], starts, offs, a5[5], drop_id=num_out)
        calls.append((grad_rows, ids.to(torch.int32), num_out))
    return calls


KERNEL_NAMES = {"count_ids_kernel", "scan_counts_kernel", "place_rows_kernel", "sum_runs_kernel",
                "Memset (Device)"}


def profile(fn, reps: int = 20) -> dict:
    """Device microseconds per call of each kernel and memset fn launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        for name in KERNEL_NAMES:
            if us and name in e.key:
                times[name] = times.get(name, 0.0) + us / reps
    return times


def time_cases(fns, cases, rounds: int):
    """name -> (graph ms, events ms) summed over the cases, median round;
    every build checked bit for bit against the plain version first."""
    for rows, gid, num_out in cases:
        want = accumulate.segment_accumulate_plain(rows.cpu(), gid.cpu(), num_out)
        for name, fn in fns.items():
            if not torch.equal(launcher(fn, rows, gid, num_out)().cpu(), want):
                raise AssertionError(f"variant {name} differs from the plain version")
    runs = {name: [] for name in [*fns, "index_add_"]}
    for _ in range(rounds):
        for name in runs:
            g = e = 0.0
            for rows, gid, num_out in cases:
                fn = (index_add(rows, gid, num_out) if name == "index_add_"
                      else launcher(fns[name], rows, gid, num_out))
                g += slope(lambda i: fn(), 8, 40) * 1e3
                e += event_ms(fn)
            runs[name].append((g, e))
    return {name: (statistics.median(r[0] for r in rs), statistics.median(r[1] for r in rs))
            for name, rs in runs.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("accumulate_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(tmp)
        calls = capture_rows()
        result = {"card": card, "views": []}
        for rows, gid, num_out in calls:
            live = gid[(gid >= 0) & (gid < num_out)]
            lengths = torch.bincount(live, minlength=num_out)
            hist = {int(k): int((lengths == k).sum()) for k in torch.unique(lengths).tolist()}
            result["views"].append({"rows": rows.shape[0], "num_out": num_out,
                                    "live_rows": int(live.numel()), "run_lengths": hist})
            print(f"view: {rows.shape[0]} rows ({live.numel()} live) into {num_out}; runs by "
                  f"length {hist}", flush=True)
        fine = time_cases(fns, calls, args.rounds)
        result["profile_us"] = profile(launcher(fns["shipped"], *calls[0]))
        print(f"shipped, first view, device us by kernel (mean of 20 calls): "
              f"{result['profile_us']}", flush=True)
        rows, gid, num_out = calls[0]
        rng = np.random.default_rng(13)
        heavy = rng.integers(0, num_out, size=gid.numel())
        heavy[rng.random(gid.numel()) < 0.1] = num_out // 2
        one = np.full(gid.numel(), num_out // 3)
        long_runs = {}
        for what, ids in (("heavy_10pct", heavy), ("one_id", one)):
            case = [(rows, torch.from_numpy(ids.astype(np.int32)).cuda(), num_out)]
            long_runs[what] = time_cases(fns, case, 1)
        result.update(fine=fine, long_runs=long_runs)
        lib_g, lib_e = fine["index_add_"]
        for name, (g, e) in fine.items():
            print(f"{name}: graph slope {g:.4f} ms ({g / lib_g:.2f}x index_add_), events "
                  f"{e:.4f} ms ({e / lib_e:.2f}x)", flush=True)
        for what, times in long_runs.items():
            print(f"{what}: " + ", ".join(f"{n} {g:.4f} / {e:.4f} ms" for n, (g, e)
                                          in times.items()) + " (graph slope / events)")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
