"""Time K3's `select_min_k` routes (csrc/select_k.cu) and both forms of its
filter entry beside torch.topk, at the shapes the library's searches give
it, and sweep the filter's two forms across widths, on one CUDA card. Run
from the repository root (it takes the capture helpers from
chip_smoke.py):

    python -m gaussreg_tpu_torch.tools.select_variants [--rounds 3]

Inputs, made from seeds at make_cfg() (chip_smoke.py's held-out pair 7,
random_pair(cfg, 20_000_007)):

- `search`: the 30 (1 024, 30 720) k = 35 distance blocks that
  radius_search gives K3 on the pair's level-0 points (chip_smoke.py phase
  13(b));
- `pyramid`: the 13 window-distance rows (B*M, 9*256) that the `pallas`
  grid searches give it on the pair's pyramid, at each level's limit
  (phase 13(a));
- `lgr`: two (32 768, 128) k = 3 blocks of negated random scores (the
  shape of phase 4's generic run).

Per set: the route select_min_k takes (`shipped`, with the route's name);
the filter entry one warp per row (`narrow`) and one block of
FILTER_WIDE_WARPS warps per row (`wide`); the rounds kernels at the same
k (`rounds`: the route select_min_k_rounds, the filter's predecessor, and
its wide mode past 25 600 columns); and torch.topk. Every kernel call
must equal the plain stable sort bit for bit. A call's time is the sum
over the set's calls of graph slopes (utils.timing.slope, 8 against 40
launches), the median of --rounds rounds taken in turns.

The sweep: the search's 30 blocks stacked and cut to their first R rows
and W columns (R = 1 024: one block of a library search on a W-point
cloud, distances in the points' order; up to R = 30 720: many rows, as
the pyramid's calls have), R in SWEEP_ROWS, W in SWEEP_WIDTHS, k in
SWEEP_KS, `narrow` against `wide`, and the form select_k.route picks at
each point. For each (R, k) it prints the smallest swept width from
which `wide` wins at every wider one (the measured ground for the route's
FILTER_WIDE_* constants), and over all points the route's time against
the faster form's, at worst and summed.

Prints a line per set and call beside the set's bound (the input read
once and the values and positions written, at 3.35 TB/s), the card's
name and power limit, and all of it as one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess

import torch

from gaussreg_tpu_torch.ops import select_k as sk
from gaussreg_tpu_torch.utils.timing import slope

PEAK_BYTES_PER_S = 3.35e12
SWEEP_WIDTHS = (2304, 4096, 6144, 8192, 12_288, 16_384, 20_480, 25_600, 30_720)
SWEEP_KS = (3, 35, 89)
SWEEP_ROWS = (1024, 2048, 4096, 8192, 30_720)


def outputs(x, k):
    r = x.shape[0]
    return (torch.empty((r, k), device=x.device),
            torch.empty((r, k), dtype=torch.int32, device=x.device))


def filter_call(x, k, wide: bool):
    """One launch of the filter entry, one warp per row or (wide) one
    block per row, whatever route select_min_k would take."""
    def run():
        vals, pos = outputs(x, k)
        sk.KERNEL.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), x.shape[0], x.shape[1],
                         k, int(wide))
        return vals, pos
    return run


def rounds_call(x, k):
    """The rounds kernels at this k (their wide mode past 25 600 columns)."""
    r, w = x.shape

    def run():
        vals, pos = outputs(x, k)
        if w < sk.WIDE_MIN_WIDTH:
            sk.ROUNDS_KERNEL.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), r, w, k)
        else:
            cand = torch.empty((r, -(-w // sk.WIDE_CHUNK) * k), dtype=torch.int64,
                               device=x.device)
            sk.ROUNDS_WIDE_KERNEL.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(),
                                         cand.data_ptr(), r, w, k)
        return vals, pos
    return run


def variant_calls(x, k):
    """name -> a call computing select_min_k(x, k) that way."""
    return {"shipped": lambda: sk.select_min_k(x, k), "narrow": filter_call(x, k, False),
            "wide": filter_call(x, k, True), "rounds": rounds_call(x, k),
            "torch.topk": lambda: torch.topk(x, k, dim=1, largest=False)}


def capture_inputs():
    """name -> list of (x, k): the search's and the pyramid's K3 calls on
    held-out pair 7 at make_cfg(), and the LGR-shaped blocks."""
    import chip_smoke
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.data import pipeline as pipeline_mod
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.ops import neighbors as nb

    cfg = make_cfg()
    rp, rf, sp, sf, m = random_pair(cfg, 20_000_007)
    grid = functools.partial(nb.grid_radius_search, select_kernel="pallas")
    with chip_smoke.Swap(pipeline_mod, "grid_radius_search", grid), \
            chip_smoke.Capture(nb, "select_min_k") as c3:
        batch = pipeline_mod.make_pair_batch(cfg, rp, rf, sp, sf, m, device="cuda")
    pts, msk = batch.pyramid.points[0][0], batch.pyramid.masks[0][0]
    with chip_smoke.Capture(nb, "select_min_k") as cw:
        nb.radius_search(pts, pts, msk, msk, cfg.backbone.init_radius,
                         cfg.capacity.neighbor_limits[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    lgr = [(-torch.exp(torch.randn(32_768, 128, device="cuda", generator=gen)), 3)
           for _ in range(2)]
    torch.cuda.synchronize()
    return {"search": [a for a, _ in cw.calls], "pyramid": [a for a, _ in c3.calls], "lgr": lgr}


def time_set(calls, rounds: int, names=None):
    """name -> ms summed over the calls (median round); every kernel call
    checked bit for bit against the plain version first."""
    per_call = [{n: f for n, f in variant_calls(x, k).items() if names is None or n in names}
                for x, k in calls]
    for (x, k), variants in zip(calls, per_call):
        vp, pp = sk.select_min_k_plain(x, k)
        for name, fn in variants.items():
            if name == "torch.topk":
                continue
            vals, pos = fn()
            torch.cuda.synchronize()
            if not (torch.equal(pos, pp) and torch.equal(vals.view(torch.int32),
                                                         vp.view(torch.int32))):
                raise AssertionError(f"{name} differs from the plain version at "
                                     f"{tuple(x.shape)}, k={k}")
    runs = {name: [] for name in per_call[0]}
    for _ in range(rounds):
        for name in runs:
            runs[name].append(sum(slope(lambda i, f=v[name]: f(), 8, 40) * 1e3
                                  for v in per_call))
    return {name: statistics.median(r) for name, r in runs.items()}


def sweep(rows, rounds: int):
    """"R,k" -> W -> {narrow, wide, route} on the first R rows and W
    columns of `rows` (ms of each form, and the form select_k.route picks),
    "R,k" -> the smallest swept W from which wide wins at every wider one
    (None if it never does), and the route's cost: its time over the
    faster form's, worst and in all."""
    table, crossover = {}, {}
    worst, picked, best = 1.0, 0.0, 0.0
    for r in SWEEP_ROWS:
        for k in SWEEP_KS:
            key = f"{r},{k}"
            table[key] = {}
            for w in SWEEP_WIDTHS:
                x = rows[:r, :w].contiguous()
                t = time_set([(x, k)], rounds, ("narrow", "wide"))
                t["route"] = "wide" if sk.route(w, k, r) == "select_min_k_wide" else "narrow"
                table[key][w] = t
                worst = max(worst, t[t["route"]] / min(t["narrow"], t["wide"]))
                picked, best = picked + t[t["route"]], best + min(t["narrow"], t["wide"])
                print(f"  sweep R={r} k={k} W={w}: narrow {t['narrow']:.4f} ms, wide "
                      f"{t['wide']:.4f} ms, the route takes {t['route']}", flush=True)
                del x
            crossover[key] = None
            for w in reversed(SWEEP_WIDTHS):
                if table[key][w]["wide"] >= table[key][w]["narrow"]:
                    break
                crossover[key] = w
            print(f"  sweep R={r} k={k}: wide wins from W = {crossover[key]} on", flush=True)
    cost = {"worst": worst, "summed": picked / best}
    print(f"  sweep: the route's choice over the faster form: worst {worst:.3f}x, summed over "
          f"the points {cost['summed']:.3f}x", flush=True)
    return table, crossover, cost


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("select_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    result = {"card": card, "sets": {}}
    inputs = capture_inputs()
    for name, calls in inputs.items():
        shapes = sorted({(tuple(x.shape), k) for x, k in calls}, reverse=True)
        routes = sorted({sk.route(x.shape[1], k, x.shape[0]) for x, k in calls})
        nbytes = sum(x.numel() * 4 + x.shape[0] * k * 8 for x, k in calls)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        times = time_set(calls, args.rounds)
        result["sets"][name] = {"calls": len(calls), "shapes": shapes, "routes": routes,
                                "bound_ms": bound_ms, "ms": times}
        print(f"{name}: {len(calls)} calls, largest {shapes[0]}, routes {routes}, bound "
              f"{bound_ms:.4f} ms", flush=True)
        for variant, ms in times.items():
            print(f"  {variant}: {ms:.4f} ms ({ms / bound_ms:.2f}x the bound, "
                  f"{ms / times['torch.topk']:.3f}x torch.topk)", flush=True)
    print("sweep: the search's blocks stacked, cut to R rows and W columns", flush=True)
    stacked = torch.cat([x for x, _ in inputs.pop("search")])
    inputs.clear()
    table, crossover, cost = sweep(stacked, args.rounds)
    result["sweep"] = {"ms": table, "wide_wins_from": crossover, "route_cost": cost}
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
