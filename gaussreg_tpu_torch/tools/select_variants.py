"""Time K3's `select_min_k` routes (csrc/select_k.cu) and each of its
kernels (the filter entry in both forms, the radix entry) beside
torch.topk, at the shapes the library's searches give it, and sweep them
across widths, rows and k, on one CUDA card. Run from the repository root
(it takes the capture helpers from chip_smoke.py):

    python -m gaussreg_tpu_torch.tools.select_variants [--rounds 3]
        [--ks 3,35,...] [--rows 1024,...] [--source copy.cu ...]

Inputs, made from seeds at make_cfg() (chip_smoke.py's held-out pair 7,
random_pair(cfg, 20_000_007)):

- `search`: the 30 (1 024, 30 720) k = 35 distance blocks that
  radius_search gives K3 on the pair's level-0 points (chip_smoke.py phase
  13(b));
- `pyramid`: the 13 window-distance rows (B*M, 9*256) that the `pallas`
  grid searches give it on the pair's pyramid, at each level's limit
  (phase 13(a));
- `lgr`: two (32 768, 128) k = 3 blocks of negated random scores (the
  shape of phase 4's generic run);
- past k = 128 (phase 13(b2)): `widest:129` and `widest:700`, the
  pyramid's widest call, (61 440, 2 304), at k = 129 and 700;
  `block:129`, the search's first block at k = 129; `knn:2048`, the 30
  (1 024, 30 720) blocks of knn_search at k = 2 048 on the same points.

Per set: the route select_min_k takes (`shipped`, with the route's name);
the filter entry one warp per row (`narrow`) and one block of
FILTER_WIDE_WARPS warps per row (`wide`, up to FILTER_WIDE_LIST_MAX_K);
the radix entry (`radix`, where select_k.radix_fits); and torch.topk.
Every kernel call must equal the plain stable sort bit for bit. A call's
time is the sum over the set's calls of graph slopes (utils.timing.slope,
8 against 40 launches; 2 against 6 for a call past 1 ms), the median of
--rounds rounds taken in turns.

The sweep: the search's 30 blocks stacked and cut to their first R rows
and W columns (R = 1 024: one block of a library search on a W-point
cloud, distances in the points' order; up to R = 30 720: many rows, as
the pyramid's calls have), R in --rows, W in SWEEP_WIDTHS, k in --ks
(k <= W), `narrow`, `wide` and `radix` with torch.topk beside each
point, and the form select_k.route picks there. For each (R, k) it
prints the smallest swept width from which `wide` wins at every wider
one (the measured ground for the route's FILTER_WIDE_* constants), and
over all points the route's time against the fastest form's, at worst
and summed; the points' table is the ground for RADIX_*. The defaults
take about an hour on the card: pick --ks and --rows.

--source: other copies of csrc/select_k.cu (say with another kLargeQueue,
the lane queue's length past k = 192, in threshold_filter.cuh: a copy
takes the header beside it before the shipped one; or a parent commit's
select_k.cu), each built into its own library
and its entries timed beside the shipped build's, in every set and at
every sweep point, under `narrow@<stem>`, `wide@<stem>` and
`radix@<stem>`; their calls are held bit for bit as well.

Prints a line per set and call beside the set's bound (the input read
once and the values and positions written, at 3.35 TB/s), a line per
sweep point, the card's name and power limit, and all of it as one JSON
object on the last line.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess

import torch

from gaussreg_tpu_torch.ops import _cuda
from gaussreg_tpu_torch.ops import select_k as sk
from gaussreg_tpu_torch.utils.timing import slope

PEAK_BYTES_PER_S = 3.35e12
SWEEP_WIDTHS = (2304, 4096, 6144, 8192, 12_288, 16_384, 20_480, 25_600, 30_720)
SWEEP_KS = (3, 35, 89, 129, 192, 256, 384, 700, 2048)
SWEEP_ROWS = (1024, 2048, 4096, 8192, 30_720)
LONG_CALL_MS = 1.0  # past this, slopes of 2 against 6 launches
FORMS = {"select_min_k": "narrow", "select_min_k_wide": "wide", "select_min_k_radix": "radix"}


def outputs(x, k):
    r = x.shape[0]
    return (torch.empty((r, k), device=x.device),
            torch.empty((r, k), dtype=torch.int32, device=x.device))


def filter_call(kernel, x, k, wide: bool):
    """One launch of a build's filter entry, one warp per row or (wide)
    one block per row, whatever route select_min_k would take."""
    def run():
        vals, pos = outputs(x, k)
        kernel.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), x.shape[0], x.shape[1], k,
                      int(wide))
        return vals, pos
    return run


def source_kernels(paths):
    """stem -> (the filter entry, the radix entry) of each copy of
    select_k.cu, built (not registered, so the routes' counts do not see
    them)."""
    kernels = {os.path.splitext(os.path.basename(p))[0]: tuple(
        _cuda.CudaKernel(os.path.abspath(p), kern.symbol, kern.argtypes)
        for kern in (sk.KERNEL, sk.RADIX_KERNEL)) for p in paths}
    _cuda._build([pair[0] for pair in kernels.values()])
    return kernels


def radix_call(kernel, x, k):
    """One launch of a build's radix entry, whatever route select_min_k
    would take."""
    def run():
        vals, pos = outputs(x, k)
        kernel.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), x.shape[0], x.shape[1], k)
        return vals, pos
    return run


def variant_calls(x, k, sources, shipped=True):
    """name -> a call computing select_min_k(x, k) that way."""
    calls = {"shipped": lambda: sk.select_min_k(x, k)} if shipped else {}
    builds = [("", (sk.KERNEL, sk.RADIX_KERNEL)), *((f"@{s}", b) for s, b in sources.items())]
    for tag, (filt, radix) in builds:
        if sk.radix_fits(x.shape[1], k):
            calls["radix" + tag] = radix_call(radix, x, k)
        calls["narrow" + tag] = filter_call(filt, x, k, False)
        if k <= sk.FILTER_WIDE_LIST_MAX_K:
            calls["wide" + tag] = filter_call(filt, x, k, True)
    calls["torch.topk"] = lambda: torch.topk(x, k, dim=1, largest=False)
    return calls


def capture_inputs():
    """name -> list of (x, k): the search's and the pyramid's K3 calls on
    held-out pair 7 at make_cfg(), the LGR-shaped blocks, and the calls
    past k = 128."""
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
    with chip_smoke.Capture(nb, "select_min_k") as ck:
        nb.knn_search(pts, pts, msk, msk, chip_smoke.KNN_K)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lgr = [(-torch.exp(torch.randn(32_768, 128, device="cuda", generator=gen)), 3)
           for _ in range(2)]
    torch.cuda.synchronize()
    pyramid = [a for a, _ in c3.calls]
    widest = max((x for x, _ in pyramid), key=lambda x: x.numel())
    search = [a for a, _ in cw.calls]
    return {"search": search, "pyramid": pyramid, "lgr": lgr,
            "widest:129": [(widest, 129)], "widest:700": [(widest, 700)],
            "block:129": [(search[0][0], 129)], "knn:2048": [a for a, _ in ck.calls]}


def check(name, x, k, fn, want):
    vals, pos = fn()
    torch.cuda.synchronize()
    vp, pp = want
    if not (torch.equal(pos, pp) and torch.equal(vals.view(torch.int32), vp.view(torch.int32))):
        raise AssertionError(f"{name} differs from the plain version at {tuple(x.shape)}, k={k}")


def time_set(calls, rounds: int, sources, shipped=True):
    """name -> ms summed over the calls (median round); every kernel call
    checked bit for bit against the plain version first."""
    per_call = [variant_calls(x, k, sources, shipped) for x, k in calls]
    reps = []
    for (x, k), variants in zip(calls, per_call):
        want = sk.select_min_k_plain(x, k)
        for name, fn in variants.items():
            if name != "torch.topk":
                check(name, x, k, fn, want)
        del want
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        variants["torch.topk"]()
        end.record()
        end.synchronize()
        reps.append((8, 40) if start.elapsed_time(end) < LONG_CALL_MS else (2, 6))
    runs = {name: [] for name in per_call[0]}
    for _ in range(rounds):
        for name in runs:
            runs[name].append(sum(slope(lambda i, f=v[name]: f(), lo, hi) * 1e3
                                  for v, (lo, hi) in zip(per_call, reps)))
    return {name: statistics.median(r) for name, r in runs.items()}


def sweep(rows, row_counts, ks, rounds: int, sources):
    """"R,k" -> W -> {narrow, wide, torch.topk, ..., route} on the first R
    rows and W columns of `rows` (ms of each form, and the form
    select_k.route picks), "R,k" -> the smallest swept W from which wide
    wins at every wider one (None if it never does), and the route's cost:
    its time over the fastest form's, worst and in all."""
    table, crossover = {}, {}
    worst, picked, best = 1.0, 0.0, 0.0
    for r in row_counts:
        for k in ks:
            key = f"{r},{k}"
            table[key] = {}
            for w in SWEEP_WIDTHS:
                if k > w:
                    continue
                x = rows[:r, :w].contiguous()
                t = time_set([(x, k)], rounds, sources, shipped=False)
                t["route"] = FORMS[sk.route(w, k, r)]
                table[key][w] = t
                fastest = min(t[f] for f in FORMS.values() if f in t)
                worst = max(worst, t[t["route"]] / fastest)
                picked, best = picked + t[t["route"]], best + fastest
                print(f"  sweep R={r} k={k} W={w}: " + ", ".join(
                    f"{n} {v:.4f}" for n, v in t.items() if n != "route")
                    + f" ms; the route takes {t['route']}", flush=True)
                del x
            crossover[key] = None
            for w in reversed(list(table[key])):
                if "wide" not in table[key][w] or table[key][w]["wide"] >= table[key][w]["narrow"]:
                    break
                crossover[key] = w
            print(f"  sweep R={r} k={k}: wide wins from W = {crossover[key]} on", flush=True)
    cost = {"worst": worst, "summed": picked / best}
    print(f"  sweep: the route's choice over the fastest form: worst {worst:.3f}x, summed over "
          f"the points {cost['summed']:.3f}x", flush=True)
    return table, crossover, cost


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--ks", default=",".join(map(str, SWEEP_KS)),
                        help="the sweep's k, comma-separated (empty: no sweep)")
    parser.add_argument("--rows", default=",".join(map(str, SWEEP_ROWS)),
                        help="the sweep's row counts, comma-separated")
    parser.add_argument("--source", action="append", default=[],
                        help="another copy of csrc/select_k.cu to time beside the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("select_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    sources = source_kernels(args.source)
    result = {"card": card, "sources": args.source, "sets": {}}
    inputs = capture_inputs()
    for name, calls in inputs.items():
        shapes = sorted({(tuple(x.shape), k) for x, k in calls}, reverse=True)
        routes = sorted({sk.route(x.shape[1], k, x.shape[0]) for x, k in calls})
        nbytes = sum(x.numel() * 4 + x.shape[0] * k * 8 for x, k in calls)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        times = time_set(calls, args.rounds, sources)
        result["sets"][name] = {"calls": len(calls), "shapes": shapes, "routes": routes,
                                "bound_ms": bound_ms, "ms": times}
        print(f"{name}: {len(calls)} calls, largest {shapes[0]}, routes {routes}, bound "
              f"{bound_ms:.4f} ms", flush=True)
        for variant, ms in times.items():
            print(f"  {variant}: {ms:.4f} ms ({ms / bound_ms:.2f}x the bound, "
                  f"{ms / times['torch.topk']:.3f}x torch.topk)", flush=True)
    ks = [int(k) for k in args.ks.split(",") if k]
    if ks:
        print("sweep: the search's blocks stacked, cut to R rows and W columns", flush=True)
        stacked = torch.cat([x for x, _ in inputs["search"]])
        inputs.clear()
        row_counts = [int(r) for r in args.rows.split(",")]
        table, crossover, cost = sweep(stacked, row_counts, ks, args.rounds, sources)
        result["sweep"] = {"ms": table, "wide_wins_from": crossover, "route_cost": cost}
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
