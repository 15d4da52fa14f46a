#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (gaussreg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, needs one CUDA card

Phases, each of which fails the run (non-zero exit, no result line):

1. build: nvcc compiles every csrc/*.cu kernel (eight sources, one process
   per source, in parallel) into gaussreg_tpu_torch/_build/.
2. main path: the trained checkpoint (checkpoints/synthetic_coarse.msgpack)
   at make_cfg() width registers the 8 held-out synthetic pairs
   random_pair(cfg, 20_000_000 + i) through api.coarse_register_clouds;
   every pair must have RR = 1 (RMSE < 0.2) and RRE < 5 degrees. Kernel
   launch counts are zeroed just before and read just after: 13 window
   selections (K1), 14 KPConv aggregations (K2) and one fused mutual-top-k
   threshold launch (K3's `kth_largest_rows_cols`) per pair, and no launch
   of the generic k-min selection on any of its three routes
   (`select_min_k`, `select_min_k_wide`, `select_min_k_radix`). K1 runs
   in place (`fused_select.window_select_runs`): its windows are never
   gathered (`fused_select.gather_windows`) and its plain version never
   runs (both captured around the pairs: zero calls).
3. .ply entry point: api.register_gs_pair(fine=False) on two .ply files of
   one synthetic scene written by the port's gs/ply.py writer (counts
   zeroed and read around it too); the transform must be finite and its
   rotation within 5 degrees of the known one.
4. kernels: every K1/K2/K3 call of one pair's forward is replayed on its
   captured inputs (K1's 13 calls of its in-place entry; beside each, the
   gathered entry on the gathered windows, held against it bit for bit, and
   the old route, the gather and the gathered entry, timed; torch.topk
   runs on the masked d2 made before the timed call, so it leaves out the
   gather and the d2; K1's bound counts the queries, run bounds, window
   rows, the sorted planes once and the outputs, and 8 f32 operations per
   valid candidate, with the L2 reads printed beside it); the
   kernel is held against its plain PyTorch version
   (K1 and K3 index-for-index and value-for-value; K2 within 4e-3 of the
   plain output's max, the size of one bf16 rounding step of a weighted
   sum) and timed (kernel and library call by the slope between CUDA
   graphs of 8 and 40 launches, so that the wrappers' host time between
   launches is not counted; the plain version by CUDA events, mean of 5
   after a warm-up; inputs left in L2 as the forward leaves them) beside
   the plain version, one PyTorch library call for the same function, and
   the least time the card could take (bytes at 3.35 TB/s or operations at
   the inputs' peak rate).
   K3's fused entry (one call per pair) is held against its plain version
   bit for bit and timed beside torch.topk on both axes, beside the route
   the path took before it (negation, transpose copy and two select_min_k
   launches) and beside its bound, once on the captured block (left in L2)
   and once on six rotating copies of it (101 MB, out of L2). The generic
   select_min_k, no longer on the path, is launched on that route's two
   inputs with its routes' counts read around that run (each call must
   take the route select_k.route names, printed per shape), held against
   its plain version and timed (`k3_phase`, `k3_routes_run`).
   k2 backward: the backward of each of one pair's 14 captured K2 calls
   (the VJP of the plain einsums) against reference_apply's own autograd
   and timed, then a grad-enabled backbone forward and backward at
   make_tiny_cfg() from the same seeded weights on the card through K2,
   on the card through K2's plain version, and on the CPU
   (`k2_backward_phase`).
5. profile: one pair under torch.profiler, device time by kernel and the
   device's busy share of the wall time.
6. fine registration at full width: a synthetic scene of 200 000 gaussians
   (numpy, from a seed) whose source model is the reference under the
   inverse of a 1.02-scale, ~1.5-degree, (0.03, -0.02, 0.01) similarity;
   gs.fine_registration.fine_register from the identity, 4 orbit views of
   640x480, 100 Adam steps, 32x32 tiles, SH degree 3. Launch counts zeroed
   before and read after: the backward (K5) and the accumulation (K6)
   400 each, the forward (K4) at least 404. The losses must be finite, the
   last under the first, and RRE, RTE and RSE against the known transform
   each lower than at the start.
7. fine entry point: api.register_gs_pair(fine=True, fine_steps=20) on the
   two .ply files (finite, rotation within 5 degrees, K4-K6 launched) and
   on the reference file against an exact copy of it under the inverse of
   the known transform (the refinement must not leave the optimum: rotation
   error not above the coarse one, or under 0.1 degree), then
   api.gaussian_fuse with the estimated transform: the fused .ply reads
   back, finite, with between N and 2N gaussians.
8. rasterizer kernels: the K4/K5/K6 calls of one full-width step (4 views)
   are replayed on their captured inputs, held against their plain PyTorch
   versions (limits at `compare_forward`, `compare_backward`, the forward's
   chunk-start state included; two K5 launches equal bit for bit; K6 equal
   bit for bit to its plain version and to `index_add_` on the compacted
   ids on the host, which adds in row order) and timed (K4 and K5 by
   `graph_ms`, as K1-K3) beside them and beside their bounds (K4 and K5 over the tiles' own pairs of the chunks
   walked) and, for K4 and K5 on their log lines, the critical-path bound
   of a design that keeps a tile on one SM (the heaviest tile's operations
   at 1/132 of the f32 peak; not in the kernels line, which holds measured
   numbers and `bound_ms`). Per view it prints walked pairs per tile and kend (the
   imbalance) and the chunk-start state's bytes; after phase 6
   torch.cuda.max_memory_allocated().
   K6 is timed as the path pays for it: the pair table that the backward
   of each differentiated render builds from the binning's sort, plus the
   accumulation, beside `index_add_` on the card (K4 and K5 have no single
   PyTorch call). The backward of one differentiated render per view runs
   under torch.profiler, which counts its sort and searchsorted launches;
   two steps run under torch.profiler, which also counts the sort kernels
   by name.

9. probes: the twins of the TPU probes P1 (three row gathers,
   gaussreg_tpu_torch/tools/probe_vmem_gather.py: from device memory, from
   a table staged in shared memory, and `onehot`, the TPU's one-hot product,
   here a direct gather of two lanes per 32-byte row) and P2 (the
   compositing loop with cores A-D, tools/probe_kernels_r5.py) at the
   probes' shapes, launches counted around their run; held against their
   plain versions (`probe_phase`, `compare_cores`), timed by graph slopes
   and bounded. P1 moves ~8 KB (a bound of ~2.6 ns), so its variants are
   held by launch latency, beside torch.index_select's; `kernel2`'s twin
   (the table staged across a cluster of 8 blocks) is printed beside
   `kernel3`'s (a direct gather): the difference is the staging's cost.
   P2's bound is the largest of its f32 operations, its transcendentals
   at the special-function unit's rate and its bytes (`p2.bound`).
10. CLIs: `python -m gaussreg_tpu_torch.tools.demo` on phase 3's .ply pair
   with the trained checkpoint (RRE < 5 degrees), again with
   --torch_snapshot on a saved fake reference state dict, and
   `python -m gaussreg_tpu_torch.tools.fuse` on the written transform
   (`cli_phase`). The snapshot's path (the reference's neighbour limits,
   89 slots at level 0) also runs in this process with the launch counts
   zeroed before and read after, and each of its K2 calls is held against
   the plain version as in phase 4 (`snapshot_path`).

11. training at full width (`train_phase`): TRAIN_STEPS = 30 steps of
   make_train_step at make_cfg() on random_pair(cfg, 0, num_points=20000)
   from flax-distributed seeded weights (Adam at 3e-4 with weight decay):
   every step's gradients finite, the loss falling (mean of the last 5
   steps under the first 5's), every parameter moved, 14 K2 launches per
   step and no other kernel launch (the pyramid is built before the counts
   are zeroed); one step profiled (K2 forward and backward ms by
   record_function spans); a checkpoint round trip that leaves the eval
   step's transform bit for bit; one make_tiny_cfg() step on the card
   against the CPU. Each step draws its pair from its own generator
   (`pair_generator(dev, 1, step, 0)`).
12. train and evaluate through the CLIs (`cli_train_eval_phase`): `python
   -m gaussreg_tpu_torch.tools.trainval --synthetic` at make_cfg() (8 pool
   pairs, 4 validation pairs) with --distributed at world 1 on NCCL, one
   epoch, then --resume to epoch 2 in a new process: 16 logged steps, all
   finite with grad_finite 1, the snapshot at step 16, per epoch the prep,
   proc and prefetch build seconds (epoch 2 replays the batch cache);
   `tools.ddp_check` with 2 gloo ranks on this card at make_tiny_cfg()
   (the ranks bit-equal after 2 steps, step-1 metrics equal to a 1-rank
   run's, the gradient all-reduce's ms); a fake ScanNet-GSReg tree of
   write_scene_plys scenes (2 train, 2 test): `trainval --data_root` for
   one augmented epoch, `tools.eval_scannet` with the trained checkpoint in
   this process (launch counts zeroed before and read after: 13 K1, 14 K2,
   1 fused K3 per scene; every scene under 5 degrees RRE), then `--fine
   --fine_steps 20` on one scene (finite, K4-K6 launched);
   `tools.eval_synthetic` on phase 2's 8 held-out pairs (recall_RMSE<0.2 =
   1.0).

13. the library surface beyond the main path (`library_phase`): one
   held-out pair's pyramid through the legacy select_kernel="pallas"
   branch (K3's `select_min_k` route, 13 launches) equal to the fused
   route's, both timed, its K3 calls held and timed; the fused route with
   K1 in place and through the old route (the gather and the gathered
   entry), equal index for index, each timed warm over PYRAMID_REPEATS
   turns that alternate which route runs first (medians), with its peak
   torch.cuda.max_memory_allocated above what was held before; the brute-force
   radius_search at N = M = 30 720 through K3's `select_min_k_wide` route,
   equal to its plain version, timed; K3 past k = 128 (the filter or the
   radix select, as the route names) on the widest pyramid call's rows at
   k = 129 and 700, on one search block at k = 129, and through
   knn_search at k = 2 048 on the same 30 720 points (30 blocks), equal to
   its plain version, each call held and timed
   (each phase prints the route of each call); K6's own
   signature (`segment_accumulate`, a counting sort over
   the id range with each run's row order restored) on one fine step's
   gradient rows, bit-equal to its plain version on the host, timed beside
   index_add_ by graph slopes and by CUDA events, and again with one id
   holding ~10 % of the rows and with every row on one id (its long-run
   paths), bit-equal and repeatable; a make_cfg()-width KPConvFPN forward at kernel_size 20 and
   36 (the einsum route: 14 calls, no K2 launch); render_sharded with 2
   gloo ranks on this card (200 000 gaussians, one 640x480 view, forward
   and backward) against render, K4-K6 launched on each rank.
14. the hard-tier gate and the diagnostic tools' twins
   (`diagnostics_phase`): the JAX test's gate
   (tests/test_trained_checkpoint.py:72-116) with the trained checkpoint on
   random_pair(cfg, 20_000_000 + i, tier="hard"), i < 8, through
   make_eval_step (RANSAC seeded seed % 97, as the JAX test's keys): at
   least 6 pairs with RR = 1, every success with RRE < 5 deg and RMSE <
   0.1, each pair's line beside the JAX transcript's
   (checkpoints/eval_transcript_hard.json: 6 of these 8, recall 0.906 over
   32); then gaussreg_tpu_torch.tools' calibrate_neighbors on 2 synthetic
   pairs (K1 at limit 128), probe_overflow on 2 seeds, diagnose_eval on one
   pair and diagnose_hard_failures on its 3 seeds at window_rows0 2, 3 and
   4, launch counts zeroed before each and read after (13 K1 per pyramid;
   14 K2 and one fused K3 per forward); K1's first call at limit 128 and at
   window_rows0 = 4 held against window_select_runs_plain index for index
   and timed as in phase 4.

Prints the build seconds, the card's name and power limit, a line per
pair, a line per kernel call, the profiles, a {"kernels": [...]} JSON line
listing twenty-three entries (K1, K2, K3's two entries, K4-K6, P1's three,
P2's four, and from phase 13 K3's `select_min_k` route on the pallas
pyramid, its `select_min_k_wide` route, its four runs past k = 128 (named
by route and shape: `select_min_k:widest_k129`,
`select_min_k_radix:widest_k700`, `select_min_k:block_k129`,
`select_min_k_radix:knn_k2048`) and K6's
generic entry, and from phase 14 K1 as `window_select_idx:limit128` and
`window_select_idx:window_rows0_4`); K2's entry also carries its backward's
time, and its forward's and backward's device ms in one profiled train
step), the card's name and power limit again, and as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "synthetic_coarse.msgpack")

# H100 SXM data-sheet peaks (dense), used for the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device milliseconds of fn() over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, r_lo: int = 8, r_hi: int = 40) -> float:
    """Device milliseconds per call of fn() without the host's time between
    launches: the slope between CUDA graphs of r_lo and r_hi calls, replayed
    and timed with CUDA events (utils.timing.slope). What remains of a
    launch is the kernel and the device's gap between two kernels of a
    graph."""
    from gaussreg_tpu_torch.utils.timing import slope

    return slope(lambda i: fn(), r_lo, r_hi) * 1e3


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Capture:
    """Record the arguments of a function looked up as a module attribute
    (the caller's import), for one forward pass. `record` picks what to keep
    of each call (default: everything, which keeps the tensors alive)."""

    def __init__(self, module, name, record=lambda args, kwargs: (args, kwargs)):
        self.module, self.name, self.record = module, name, record
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            self.calls.append(self.record(args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Swap(Capture):
    """Replace a function looked up as a module attribute while inside."""

    def __init__(self, module, name, replacement):
        super().__init__(module, name)
        self.replacement = replacement

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.replacement)
        return self


def measure(name, calls, kernel, plain, compare, library, cost, kind, plain_reps: int = 5):
    """Replay each captured call: hold the kernel against its plain version
    (`compare(kernel_out, plain_out, args)` raises on a mismatch and
    returns the max abs error), time
    kernel, plain version and library call (None: no single PyTorch call
    computes the function), and bound the call's work. Kernel and library
    call are timed by `graph_ms`, so that the wrapper's host time between
    launches is not counted; the plain version by `cuda_ms`.
    Returns the per-call lines and the totals over the calls."""
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0 if library else None, err=0.0,
               bytes=0.0, ops=0.0)
    for args, kw in calls:
        err = compare(kernel(*args, **kw), plain(*args, **kw), args)
        t_k = graph_ms(lambda: kernel(*args, **kw))
        t_p = cuda_ms(lambda: plain(*args, **kw), reps=plain_reps)
        t_l = graph_ms(library(*args, **kw)) if library else None
        nbytes, ops, shape = cost(*args, **kw)
        b_ms, _ = bound(nbytes, ops, kind)
        lib_txt = f"{t_l:.4f}ms" if library else "none"
        rows.append(f"{name} {shape}: err={err:.3e} kernel={t_k:.4f}ms plain={t_p:.4f}ms "
                    f"library={lib_txt} bound={b_ms:.4f}ms")
        tot["err"] = max(tot["err"], err)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("bytes", nbytes), ("ops", ops)):
            tot[key] += v
        if library:
            tot["library_ms"] += t_l
    return rows, tot


def exact(a, b, _args):
    """K1/K3: values and indices must be equal."""
    import torch

    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError(f"kernel differs from its plain version in "
                             f"{(a[1] != b[1]).sum().item()} indices")
    return 0.0


def within_bf16_step(a, b, _args):
    """K2: within 4e-3 of the plain output's max (one bf16 rounding step)."""
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    if not err <= 4e-3 * scale:
        raise AssertionError(f"kpconv_fused_apply err {err} > 4e-3 * {scale}")
    return err


def gathered_args(q, lsle, wrow, px, py, pz, pidx, limit, nruns, wspan):
    """An in-place K1 call's arguments for the gathered entry: its windows
    cut from the sorted planes as the JAX package cuts them (the old route's
    gather, `fused_select.gather_windows`)."""
    from gaussreg_tpu_torch.ops import fused_select as fs

    return (q, lsle, *fs.gather_windows(wrow, px, py, pz, pidx, wspan), limit, nruns, wspan)


def window_select_topk(q, lsle, wrow, px, py, pz, pidx, limit, nruns, wspan):
    """torch.topk on the masked (P, W) d2 of the gathered windows, made
    before the timed call: the yardstick leaves out the gather and the d2."""
    import torch
    from gaussreg_tpu_torch.ops import fused_select as fs

    _, _, wx, wy, wz, _, _, _, _ = gathered_args(q, lsle, wrow, px, py, pz, pidx, limit, nruns,
                                                 wspan)
    masked = torch.where(fs.window_valid(lsle, nruns, wspan), fs.window_d2(q, wx, wy, wz),
                         torch.finfo(torch.float32).max)
    del wx, wy, wz
    return lambda: torch.topk(masked, limit, dim=1, largest=False)


def valid_candidates(lsle, nruns, wspan) -> int:
    """Candidates inside their run's [ls, le), over all rows."""
    lo = lsle[:, :nruns].clamp_min(0)
    hi = lsle[:, nruns:].clamp_max(wspan)
    return int((hi - lo).clamp_min(0).sum())


def window_select_cost(q, lsle, wrow, px, py, pz, pidx, limit, nruns, wspan):
    """K1 in place: the queries, run bounds and window rows read once, the
    sorted x, y, z and id planes once per batch, the (P, limit) d2 and ids
    written; 8 f32 operations (3 subtractions, 3 products, 2 sums) per valid
    candidate, what this call's data needs. Left out: the candidates' reads
    from L2 (16 B each), printed beside it for the (P, W) window and for the
    valid candidates."""
    p, w = q.shape[0], nruns * wspan
    nv = valid_candidates(lsle, nruns, wspan)
    nbytes = 4 * (q.numel() + lsle.numel() + wrow.numel() + 4 * px.numel()) + p * limit * 8
    return nbytes, 8.0 * nv, (f"P={p} W={w} limit={limit} valid={nv} (L2 reads 16 B x P x W "
                              f"{16 * p * w / 1e9:.3f} GB, of the valid {16 * nv / 1e9:.4f} GB)")


def kpconv_einsums(nf, infl, w):
    import torch

    w_bf = w.to(torch.bfloat16)
    return lambda: torch.einsum("bmkc,kcd->bmd", torch.einsum("bmhk,bmhc->bmkc", infl, nf), w_bf)


def kpconv_cost(nf, infl, w):
    b, m, h, c = nf.shape
    k, d, r = infl.shape[-1], w.shape[-1], b * m
    nbytes = r * h * c * 2 + r * h * k * 2 + k * c * d * 2 + r * d * 4
    return nbytes, 2.0 * r * h * k * c + 2.0 * r * k * c * d, f"R={r} H={h} K={k} C={c} D={d}"


def select_topk(x, k):
    import torch

    return lambda: torch.topk(x, k, dim=1, largest=False)


def select_cost(x, k):
    """The row read once, the (R, k) values and positions written; one
    comparison per element (what any selection needs, whatever its k)."""
    r, w = x.shape
    return r * w * 4 + r * k * 8, float(r * w), f"R={r} W={w} k={k}"


def exact_thresholds(a, b, _args):
    """K3's fused entry: both thresholds equal bit for bit."""
    import torch

    torch.cuda.synchronize()
    bad = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum()) for x, y in zip(a, b))
    if bad:
        raise AssertionError(f"kth_largest_rows_cols differs from its plain version in {bad} "
                             "thresholds")
    return 0.0


def thresholds_topk(s, k):
    import torch

    return lambda: (torch.topk(s, k, dim=2).values[..., k - 1],
                    torch.topk(s, k, dim=1).values[:, k - 1])


def thresholds_cost(s, k):
    """Each score read once, each threshold written once; one comparison
    per score and pass."""
    p, w, _ = s.shape
    return p * w * w * 4 + 2 * p * w * 4, 2.0 * p * w * w, f"P={p} W={w} k={k}"


def kernel_entry(name, src, replaces, launches, tot, kind):
    """One entry of the {"kernels": [...]} line from `measure`'s totals."""
    b_ms, b_by = bound(tot["bytes"], tot["ops"], kind)
    lib_txt = "none" if tot["library_ms"] is None else f"{tot['library_ms']:.4f} ms"
    log(f"{name}: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
        f"{lib_txt}, bound {b_ms:.4f} ms ({b_by})")
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"]}


K1_SOURCE = "gaussreg_tpu_torch/csrc/window_select.cu"
K1_REPLACES = "gaussreg_tpu/ops/fused_select.py:145"


def k1_phase(name, calls, launches):
    """K1 on captured calls of the in-place entry (`window_select_runs`), by
    `measure`: held against its plain version index for index and value for
    value, timed beside the plain version, torch.topk on the masked d2
    (`window_select_topk`) and the bound (`window_select_cost`). Beside each
    call, under the same clock: the gathered entry on the gathered windows
    (held against the in-place entry bit for bit) and the old route, the
    gather and the gathered entry together (graph slopes). Returns the
    {"kernels"} entry, with the totals of both as `gathered_ms` and
    `old_route_ms`."""
    import inspect

    import torch
    from gaussreg_tpu_torch.ops import fused_select as fs

    sig = inspect.signature(fs.window_select_runs)
    calls = [(tuple(sig.bind(*a, **kw).arguments.values()), {}) for a, kw in calls]
    rows, tot = measure(name, calls, fs.window_select_runs, fs.window_select_runs_plain, exact,
                        window_select_topk, window_select_cost, "f32")
    t_gathered = t_old = 0.0
    for row, (args, kw) in zip(rows, calls):
        g = gathered_args(*args)
        exact(fs.window_select_idx(*g), fs.window_select_runs(*args), None)
        t_g = graph_ms(lambda: fs.window_select_idx(*g))
        del g
        t_o = graph_ms(lambda: fs.window_select_idx(*gathered_args(*args)))
        t_gathered += t_g
        t_old += t_o
        log(f"{row} gathered_entry={t_g:.4f}ms old_route(gather+gathered entry)={t_o:.4f}ms")
    torch.cuda.empty_cache()
    log(f"{name}: {len(calls)} calls; the gathered entry {t_gathered:.4f} ms, the old route "
        f"{t_old:.4f} ms in all")
    entry = kernel_entry(name, K1_SOURCE, K1_REPLACES, launches, tot, "f32")
    entry["gathered_ms"] = t_gathered
    entry["old_route_ms"] = t_old
    return entry


def k3_phase(calls, launches):
    """K3 on one pair's captured `kth_largest_rows_cols` call. The fused
    entry against its plain version (bit for bit), torch.topk on both axes
    and its bound, by `measure`. Under the same clock the route the path
    took before it, `_rowwise_kth_largest` on the rows and on the transpose
    (negation, transpose copy, two select_min_k launches), which must give
    the same bits; both timed on the captured block (16.8 MB at make_cfg(),
    left in the 50 MB L2 by the graph's replays) and on six rotating copies
    (each call's input last touched five calls earlier: out of L2). Then
    the generic select_min_k, on no path since the fused entry: launched
    once on that route's two inputs with its count read around that run,
    held against its plain version and timed. Returns the two entries."""
    import torch
    from gaussreg_tpu_torch.models import matching as matching_mod
    from gaussreg_tpu_torch.ops import select_k
    from gaussreg_tpu_torch.utils.timing import slope

    rows, tot = measure("kth_largest_rows_cols", calls, select_k.kth_largest_rows_cols,
                        select_k.kth_largest_rows_cols_plain, exact_thresholds,
                        thresholds_topk, thresholds_cost, "f32")
    for row in rows:
        log(row)
    (s, k), _ = calls[-1]
    p, w, _ = s.shape

    def route(x):
        return (matching_mod._rowwise_kth_largest(x.reshape(p * w, w), k),
                matching_mod._rowwise_kth_largest(x.transpose(1, 2).reshape(p * w, w), k))

    exact_thresholds([t.reshape(-1) for t in select_k.kth_largest_rows_cols(s, k)],
                     route(s), None)
    copies = [s.clone() for _ in range(6)]
    fused = select_k.kth_largest_rows_cols
    times = {
        "route_ms": graph_ms(lambda: route(s)),
        "cold_ms": slope(lambda i: fused(copies[i % 6], k), 8, 40) * 1e3,
        "route_cold_ms": slope(lambda i: route(copies[i % 6]), 8, 40) * 1e3,
    }
    del copies
    log(f"kth_largest_rows_cols: per pair, L2-resident: fused {tot['ms']:.4f} ms, the unfused "
        f"route {times['route_ms']:.4f} ms, torch.topk {tot['library_ms']:.4f} ms; out of L2 "
        f"(6 rotating copies): fused {times['cold_ms']:.4f} ms, the unfused route "
        f"{times['route_cold_ms']:.4f} ms")
    fused_entry = kernel_entry("kth_largest_rows_cols", "gaussreg_tpu_torch/csrc/select_k.cu",
                               "gaussreg_tpu/ops/select_k.py:88",
                               launches["kth_largest_rows_cols"], tot, "f32")
    fused_entry.update(times)

    gen_calls = [((-s.reshape(p * w, w), k), {}),
                 ((-s.transpose(1, 2).reshape(p * w, w), k), {})]
    gen_launches = k3_routes_run(gen_calls, "the generic run")["select_min_k"]
    rows, tot = measure("select_min_k", gen_calls, select_k.select_min_k,
                        select_k.select_min_k_plain, exact, select_topk, select_cost, "f32")
    for row in rows:
        log(row)
    gen_entry = kernel_entry("select_min_k", "gaussreg_tpu_torch/csrc/select_k.cu",
                             "gaussreg_tpu/ops/select_k.py:88", gen_launches, tot, "f32")
    return [gen_entry, fused_entry]


def k3_routes_run(calls, what):
    """Launch select_min_k once on each captured (x, k) with K3's route
    counts read around the run; each call must have taken the route that
    select_k.route names for its shape, and no other route launched.
    Returns the counts."""
    from gaussreg_tpu_torch.ops import select_k

    before = {n: kern.launches for n, kern in select_k.ROUTES.items()}
    for (x, kk), _ in calls:
        select_k.select_min_k(x, kk)
    moved = {n: kern.launches - before[n] for n, kern in select_k.ROUTES.items()}
    want = {n: 0 for n in select_k.ROUTES}
    for (x, kk), _ in calls:
        want[select_k.route(x.shape[1], kk, x.shape[0])] += 1
    shapes = sorted({(tuple(x.shape), kk, select_k.route(x.shape[1], kk, x.shape[0]))
                     for (x, kk), _ in calls}, reverse=True)
    log(f"K3 routes, {what}: " + "; ".join(f"{shape} k={kk} -> {r}" for shape, kk, r in shapes)
        + f"; launches {moved}")
    if moved != want:
        raise AssertionError(f"K3 {what}: launches {moved}, the routes name {want}")
    return moved


def random_params_(module, seed):
    """Overwrite a module's trainable parameters from a seeded generator:
    matrices and KPConv kernels normal with variance 1 / fan-in, norm
    scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in module.named_parameters():
            if not prm.requires_grad:
                continue
            noise = torch.randn(prm.shape, generator=gen)
            if prm.dim() <= 1:
                prm.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * noise)
            else:
                fan_in = prm.shape[-1] if prm.dim() == 2 else prm.shape[0] * prm.shape[1]
                prm.copy_(noise / math.sqrt(fan_in))


def k2_backward_phase(calls, dev):
    """k2 backward. (1) On each of one pair's 14 captured K2 calls, the
    gradients of (out * g).sum() through the kernel path against those of
    reference_apply's own autograd on the same inputs: within 1e-6 of each
    gradient's max (equal bit for bit is expected: the backward reads the
    saved inputs and g only); the backward (`reference_vjp`, all three
    gradients) timed by graph_ms. (2) A grad-enabled KPConv-FPN forward and
    backward at make_tiny_cfg() on one pair's pyramid (built on the host),
    from the same seeded weights three times: on the card through K2, on
    the card with K2's plain version in its place (`Swap`), and on the CPU.
    The card's forward launches K2 14 times and every parameter gets a
    finite gradient. Each KPConv weight's gradient through K2 lies within
    2e-2 of the max of the plain version's on the card (the two round the
    aggregation's f32 sums to bf16 in another order; the CPU, rounding in
    float64 instead, moves them by up to 1.7e-2). Against the CPU each
    lies within half its norm (relative Frobenius): at these random
    weights the gradients are chaotic in the last bits of the forward
    (every bf16 rounding that flips and every LeakyReLU pre-activation
    that crosses zero reroutes a share of the gradient), and on the card
    every f32 sum runs in another order. The run measures that chaos on
    the CPU, by moving every weight by 1e-6 of itself, and logs
    it beside the card's distance; a cut graph (fault F1) lies 1.0 away.
    Returns the    backward's ms per pair."""
    import copy

    import torch
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import Pyramid, make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.models import kpconv as kpconv_mod
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    gen = torch.Generator(device=dev).manual_seed(0)
    worst, unequal, bwd_ms = 0.0, 0, 0.0
    for (nf, infl, w), _ in calls:
        g = torch.randn(nf.shape[:2] + (w.shape[-1],), device=dev, generator=gen)

        def grads(fn):
            inputs = [t.detach().clone().requires_grad_() for t in (nf, infl, w)]
            out = fn(*inputs)
            if out.grad_fn is None:
                raise AssertionError(f"{fn.__name__} returned no grad_fn")
            return torch.autograd.grad((out * g).sum(), inputs)

        for x, y in zip(grads(kk.kpconv_fused_apply), grads(kk.reference_apply)):
            err = (x.float() - y.float()).abs().max().item()
            if not (x.dtype == y.dtype and err <= 1e-6 * y.float().abs().max().item()):
                raise AssertionError(f"K2 backward: {x.dtype} gradient {err} from the plain "
                                     f"autograd's {y.dtype}")
            worst, unequal = max(worst, err), unequal + int((x != y).sum())
        bwd_ms += graph_ms(lambda: kk.reference_vjp(nf, infl, w, g))
    log(f"k2 backward: {len(calls)} captured calls, gradients through the kernel path against "
        f"the plain autograd: max abs diff {worst:.3e}, {unequal} elements unequal; the "
        f"backward (VJP of the plain einsums, three gradients) {bwd_ms:.4f} ms per pair")

    cfg = make_tiny_cfg()
    rp, rf, sp, sf, m = random_pair(cfg, 20_000_200)
    batch = make_pair_batch(cfg, rp, rf, sp, sf, m, device="cpu")
    bb_cpu = create_model(cfg, "cpu").backbone
    random_params_(bb_cpu, 0)
    bb_dev = copy.deepcopy(bb_cpu).to(dev)
    to = lambda f, d: tuple(t.to(d) for t in f) if isinstance(f, tuple) else f.to(d)

    def backward(bb, pyramid, feats):
        ff, fc = bb(feats, pyramid)
        gg = torch.Generator().manual_seed(1)
        gf, gc = (torch.randn(t.shape, generator=gg).to(t.device) for t in (ff, fc))
        ((ff * gf).sum() + (fc * gc).sum()).backward()
        return {n: prm.grad for n, prm in bb.named_parameters() if prm.requires_grad}

    pyr_dev = Pyramid(*[to(f, dev) for f in batch.pyramid])
    before = kk.KERNEL.launches
    g_dev = backward(bb_dev, pyr_dev, batch.features.to(dev))
    torch.cuda.synchronize()
    launched = kk.KERNEL.launches - before
    bad = [n for n, gr in g_dev.items() if gr is None or not bool(torch.isfinite(gr).all())]
    if launched != 14 or bad:
        raise AssertionError(f"backbone backward on the card: {launched} K2 launches, no or "
                             f"non-finite gradient for {bad}")
    bb_dev.zero_grad(set_to_none=True)
    with Swap(kpconv_mod, "kpconv_fused_apply", kk.reference_apply):
        g_plain = backward(bb_dev, pyr_dev, batch.features.to(dev))
    g_cpu = backward(bb_cpu, batch.pyramid, batch.features)
    bb_moved, gen = copy.deepcopy(bb_cpu), torch.Generator().manual_seed(2)
    with torch.no_grad():
        for prm in bb_moved.parameters():
            prm.mul_(1.0 + 1e-6 * torch.randn(prm.shape, generator=gen))
    g_moved = backward(bb_moved, batch.pyramid, batch.features)
    names = [n for n in g_dev if n.endswith(".weights")]
    vs_plain = {n: ((g_dev[n] - g_plain[n]).abs().max() / g_plain[n].abs().max()).item()
                for n in names}
    rel_norm = lambda a, b: ((a.cpu() - b).norm() / b.norm()).item()
    vs_cpu = {n: rel_norm(g_dev[n], g_cpu[n]) for n in names}
    plain_vs_cpu = max(rel_norm(g_plain[n], g_cpu[n]) for n in names)
    moved_vs_cpu = max(rel_norm(g_moved[n], g_cpu[n]) for n in names)
    log(f"k2 backward: backbone at make_tiny_cfg() widths, {len(g_dev)} parameters with finite "
        f"gradients on the card ({launched} K2 launches in its forward); {len(names)} KPConv "
        f"weights' gradients through K2 against the plain version's on the card: worst "
        f"{max(vs_plain.values()):.3e} of the max ({max(vs_plain, key=vs_plain.get)}); "
        f"against the CPU: worst {max(vs_cpu.values()):.3e} of the norm "
        f"({max(vs_cpu, key=vs_cpu.get)}; the plain version's on the card: worst "
        f"{plain_vs_cpu:.3e}; the CPU's own with the weights moved by 1e-6 of themselves: "
        f"worst {moved_vs_cpu:.3e})")
    if not (len(names) == 14 and max(vs_plain.values()) <= 2e-2
            and max(vs_cpu.values()) <= 0.5):
        raise AssertionError(f"KPConv weight gradients: against the plain version {vs_plain}, "
                             f"against the CPU {vs_cpu}")
    return bwd_ms


# f32 operations per pair and pixel, counted from the kernels' sources
# (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu): the exponent 10, min, exp,
# the band test and cap 2, the weight 1, four multiply-adds 8, the
# transmittance 2 -> 25 forward; the backward recomputes the first 14 and
# adds the colour product 7, the prefix 2, d_alpha 5 (one division), the
# band test and d_power 2, the weight and 1 - alpha 2, nine products, the
# transmittance 1 and the ten pixel sums 10 -> 52.
FINE_GAUSSIANS, FINE_VIEWS, FINE_STEPS, FINE_TILE = 200_000, 4, 100, 32
K4_OPS_PER_PAIR_PIXEL = 25.0
K5_OPS_PER_PAIR_PIXEL = 52.0
NUM_SMS = 132  # H100 SXM; the critical-path bound gives one tile one SM's share
MAX_FLIPPED_PIXELS = 16


def compare_forward(a, b, args):
    """K4. rgb and T within 5e-4 and depth within 5e-3 (the limits the JAX
    package holds its kernel to against its dense renderer): kernel and
    plain version round the exponent alike and differ by the order of the
    colour sums and exp's last bit. A pair whose raw lies within an ulp of
    1/255 or 0.99 may flip on a pixel and move it by up to 4e-3 (1/255 of a
    colour near 1; depth by ten times that): such pixels are counted, at
    most MAX_FLIPPED_PIXELS allowed, none past that move or not finite. kend
    must be equal except on tiles whose max T lies within 1e-3 (relative) of
    the exit threshold 1e-4. The chunk-start state, where saved, is held to
    the same limits on the slots both walked; a flipped pixel carries its
    difference into every later chunk's state, so up to MAX_FLIPPED_PIXELS
    times the deepest walk of (slot, pixel) entries may pass 5e-4."""
    import torch
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    (pk, kk, *sk), (pp, kp, *sp) = a, b
    torch.cuda.synchronize()
    # depth is held to ten times the limit of the other planes: scaled so,
    # one limit serves all five. A NaN is `over` and fails `worst`.
    diff = (pk - pp).abs()
    diff[3] /= 10.0
    err = diff[[0, 1, 2, 4]].max().item()
    over = ~(diff <= 5e-4).all(dim=0)
    flipped = int(over.sum())
    worst = diff[:, over].max().item() if flipped else 0.0
    log(f"rasterize_forward: {flipped} pixels past 5e-4 (alpha-threshold flips), "
        f"worst {worst:.3e} (depth / 10)")
    if flipped > MAX_FLIPPED_PIXELS or not worst <= 4e-3:
        raise AssertionError(f"rasterize_forward: {flipped} pixels differ, worst {worst}")
    bad = (kk != kp).nonzero()[:, 0].tolist()
    if bad:
        th = tw = FINE_TILE
        ntx = pk.shape[2] // tw
        for t in bad:
            ty, tx = divmod(t, ntx)
            tile = (slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw))
            t_max = [p[4][tile].max().item() for p in (pk, pp)]
            if min(abs(m - kernels.T_EPS) for m in t_max) > 1e-3 * kernels.T_EPS:
                raise AssertionError(f"rasterize_forward: kend differs on tile {t}, "
                                     f"max T {t_max} not at the threshold")
        log(f"rasterize_forward: kend differs on {len(bad)} tiles at the exit threshold")
    if sk and sk[0] is not None:
        slots = kernels.written_state_slots(args[2], torch.minimum(kk, kp), args[1].shape[0])
        sd = (sk[0][slots] - sp[0][slots]).abs()
        sd[:, 4] /= 10.0
        s_over = int((sd > 5e-4).any(dim=1).sum())
        s_worst = sd.max().item() if slots.numel() else 0.0
        log(f"rasterize_forward: chunk-start state of {slots.numel()} slots, {s_over} "
            f"(slot, pixel) entries past 5e-4, worst {s_worst:.3e} (depth / 10)")
        if s_over > MAX_FLIPPED_PIXELS * int(kk.max()) or not s_worst <= 4e-3:
            raise AssertionError(f"rasterize_forward: state differs in {s_over} entries, "
                                 f"worst {s_worst}")
    return err


def compare_backward(a, b, args):
    """K5. Every row within 2e-3 of its channel's max (the limit the JAX
    package holds its gradients to): each value is a sum over a tile's 1024
    pixels, taken in another order by the kernel. Held so against the plain
    version's two forms: from the chunk-start state (`b`) and walking each
    tile's chunks in order from T = 1 (the Pallas kernel's order). A second
    launch on the same inputs gives the same bits (no atomics)."""
    import torch
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    sequential = kernels.rasterize_backward_plain(*args[:10])
    for what, ref in (("its plain version", b), ("the sequential walk", sequential)):
        scale = ref.abs().amax(dim=0).clamp_min(1e-30)
        rel = ((a - ref).abs() / scale).max().item()
        if not rel <= 2e-3:
            raise AssertionError(f"rasterize_backward: rows differ from {what} by {rel} of "
                                 "their channel's max")
    log(f"rasterize_backward: within {rel:.3e} of each channel's max of the sequential walk")
    if not torch.equal(a, kernels.rasterize_backward(*args)):
        raise AssertionError("rasterize_backward: two launches on the same inputs differ")
    log("rasterize_backward: a second launch gives the same bits")
    return (a - b).abs().max().item()


def own_pairs(starts, nchunks, cap):
    """Per tile, the pairs the kernels composite when tile t walks its first
    nchunks[t] chunks: the tile's own rows of those 128-aligned blocks,
    without the neighbouring tiles' rows that a boundary block also holds."""
    import torch
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    s = starts.clamp_max(cap).long()
    c0, c1 = s[:-1], s[1:]
    walked_end = (c0 // kernels.CHUNK + nchunks.long()) * kernels.CHUNK
    return (torch.minimum(c1, walked_end) - c0).clamp_min(0)


def state_bytes(tile_h, tile_w, nchunks):
    """Bytes of the chunk-start state of the walked chunks k >= 1: 5 f32
    per pixel and chunk."""
    return float((nchunks.long() - 1).clamp_min(0).sum()) * tile_h * tile_w * 20


def forward_cost(gdata, sorted_gid, starts, height, width, tile_h, tile_w, save_state=False):
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    kend = kernels.rasterize_forward(gdata, sorted_gid, starts, height, width, tile_h, tile_w)[1]
    pairs = float(own_pairs(starts, kend, sorted_gid.shape[0]).sum())
    nbytes = pairs * (64 + 4) + 5 * height * width * 4 + starts.numel() * 8
    if save_state:
        nbytes += state_bytes(tile_h, tile_w, kend)
    return (nbytes, pairs * tile_h * tile_w * K4_OPS_PER_PAIR_PIXEL,
            f"pairs={int(pairs)} image={height}x{width} G={gdata.shape[0] - 1} "
            f"state={save_state}")


def backward_cost(gdata, sorted_gid, starts, offs, ct_planes, bwd_blocks, height, width,
                  tile_h, tile_w, state=None):
    nchunks = offs[1:] - offs[:-1]
    pairs = float(own_pairs(starts, nchunks, sorted_gid.shape[0]).sum())
    nbytes = (pairs * (64 + 4 + 64) + 7 * height * width * 4 + starts.numel() * 12
              + state_bytes(tile_h, tile_w, nchunks))
    return (nbytes, pairs * tile_h * tile_w * K5_OPS_PER_PAIR_PIXEL,
            f"pairs={int(pairs)} buffer={bwd_blocks} blocks, {int(offs[-1])} chunks walked")


def critical_path_ms(calls, ops_per_pair_pixel):
    """The critical-path bound of a design that keeps a tile on one SM: the
    heaviest tile's operations at 1/NUM_SMS of the f32 peak, summed over the
    calls (one view each). Walked chunks from kend (forward) or offs
    (backward)."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    total = 0.0
    for args, kw in calls:
        gdata, sorted_gid, starts = args[:3]
        if len(args) > 7:  # the backward: (..., offs, ct_planes, bwd_blocks, h, w, th, tw)
            nchunks, (tile_h, tile_w) = args[3][1:] - args[3][:-1], args[8:10]
        else:
            tile_h, tile_w = args[5:7]
            nchunks = kernels.rasterize_forward(gdata, sorted_gid, starts, *args[3:7])[1]
        heaviest = float(own_pairs(starts, nchunks, sorted_gid.shape[0]).max())
        ops = heaviest * tile_h * tile_w * ops_per_pair_pixel
        total += ops / (PEAK_FLOPS["f32"] / NUM_SMS) * 1e3
    return total


def report_imbalance(calls):
    """Per captured forward call (one view): walked pairs per tile and kend,
    and the bytes of the chunk-start state the call saves."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    for v, (args, kw) in enumerate(calls):
        gdata, sorted_gid, starts, height, width, tile_h, tile_w = args
        kend = kernels.rasterize_forward(*args)[1]
        walked = own_pairs(starts, kend, sorted_gid.shape[0]).float()
        kf = kend.float()
        alloc = kernels.state_slots(sorted_gid.shape[0] // kernels.CHUNK, kend.numel())
        log(f"imbalance view {v}: {kend.numel()} tiles, walked pairs per tile mean "
            f"{walked.mean().item():.1f} max {int(walked.max())} tiles>=1000 "
            f"{int((walked >= 1000).sum())} (all {int(walked.sum())}); kend mean "
            f"{kf.mean().item():.2f} max {int(kend.max())} sum {int(kend.sum())}; chunk-start "
            f"state written {state_bytes(tile_h, tile_w, kend) / 1e6:.1f} MB, allocated "
            f"{alloc * tile_h * tile_w * 20 / 1e6:.1f} MB ({alloc} slots), "
            f"save_state={kw.get('save_state', False)}")


def accumulate_cost(grad_rows, slot_pos, row_gid, starts, offs, cap, num_out):
    """K6's bytes: the gradient rows of the walked pairs (64 B each), the
    table (4 B per slot), row_gid, starts and offs read once, the (G + 1)
    64-byte output rows written once; one f32 add per walked pair and
    channel."""
    from gaussreg_tpu_torch.gs.rasterizer import accumulate

    pairs = float(accumulate.pair_rows(slot_pos, starts, offs, cap)[1].sum())
    nbytes = (pairs * 64 + slot_pos.numel() * 4 + row_gid.numel() * 4
              + (starts.numel() + offs.numel()) * 4 + num_out * 64)
    return nbytes, pairs * 16, (f"pairs={int(pairs)} table={tuple(slot_pos.shape)} "
                                f"buffer={grad_rows.shape[0]} out={num_out}")


def measure_accumulate(c5_calls, c6_calls, table_calls):
    """K6 on one step's captured calls: equal bit for bit to its plain
    version and to index_add_ on the compacted ids on the host (sequential,
    in row order); timed as the path pays for it (the backward's pair table
    plus the accumulation), beside the launch alone, the plain
    version and index_add_ on the card. Returns the per-call lines and the
    totals."""
    import torch
    from gaussreg_tpu_torch.gs.rasterizer import accumulate, binning, kernels

    rows = []
    tot = dict(ms=0.0, launch_ms=0.0, table_ms=0.0, plain_ms=0.0, library_ms=0.0, err=0.0,
               bytes=0.0, ops=0.0)
    tables = [tab for tab, _ in table_calls]  # (order, n_rows, mt) per backward
    for (a5, _), (a6, _) in zip(c5_calls, c6_calls):  # in the backward's order
        sorted_gid, bwd_blocks = a5[1], a5[5]
        grad_rows, slot_pos, row_gid, starts, offs, cap, num_out = a6
        # the backward's table build, found by rebuilding it (it must repeat)
        tab = next((t for t in tables if torch.equal(binning.slot_positions(*t), slot_pos)), None)
        if tab is None:
            raise AssertionError("no pair table of the step rebuilds the backward's table")
        out_k = accumulate.accumulate_pairs(*a6)
        out_p = accumulate.accumulate_pairs_plain(*a6)
        ids = kernels.compacted_gids(sorted_gid, starts, offs, bwd_blocks, drop_id=num_out)
        oracle = accumulate.segment_accumulate_plain(grad_rows.cpu(), ids.cpu(), num_out)
        oracle[num_out - 1] = 0.0  # the sentinel row (the backward's old rule)
        if not (torch.equal(out_k, out_p) and torch.equal(out_k.cpu(), oracle)):
            raise AssertionError("segment_accumulate differs from its plain version or from "
                                 "index_add_ on the compacted ids")
        # short eager launches: more repetitions and warm-ups than elsewhere,
        # path and index_add_ in turns
        idx = ids.long()
        index_add = lambda: torch.zeros((num_out + 1, 16), device=grad_rows.device).index_add_(
            0, idx, grad_rows)
        path = lambda: (binning.slot_positions(*tab), accumulate.accumulate_pairs(*a6))
        t_l = cuda_ms(index_add, reps=20, warmup=3)
        t_path = cuda_ms(path, reps=20, warmup=3)
        t_path = (t_path + cuda_ms(path, reps=20, warmup=3)) / 2
        t_l = (t_l + cuda_ms(index_add, reps=20, warmup=3)) / 2
        t_launch = cuda_ms(lambda: accumulate.accumulate_pairs(*a6), reps=20, warmup=3)
        t_table = cuda_ms(lambda: binning.slot_positions(*tab), reps=20, warmup=3)
        t_p = cuda_ms(lambda: accumulate.accumulate_pairs_plain(*a6), reps=2)
        nbytes, ops, shape = accumulate_cost(*a6)
        b_ms, _ = bound(nbytes, ops, "f32")
        rows.append(f"segment_accumulate {shape}: equal, path (table + accumulation)="
                    f"{t_path:.4f}ms (table {t_table:.4f}ms, accumulation {t_launch:.4f}ms) "
                    f"plain={t_p:.4f}ms index_add_={t_l:.4f}ms bound={b_ms:.4f}ms")
        for key, v in (("ms", t_path), ("launch_ms", t_launch), ("table_ms", t_table),
                       ("plain_ms", t_p), ("library_ms", t_l), ("bytes", nbytes), ("ops", ops)):
            tot[key] += v
    return rows, tot


def fine_scene_arrays(n, seed):
    """The fine scene's numpy model: means (n, 3) in a 2-unit cube, linear
    scales, unnormalized wxyz quaternions, opacities in (0, 1), SH degree 3
    (n, 3, 16)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, size=(n, 3))
    scales = np.exp(rng.normal(-3.4, 0.4, size=(n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = 1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))
    sh = np.zeros((n, 3, 16))
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    sh[:, :, 1:] = rng.normal(scale=0.05, size=(n, 3, 15))
    return means, scales, quats, opac, sh


def make_fine_scene(n, seed, dev):
    """The full-width fine-registration scene: `n` random gaussians in a
    2-unit cube, and the same model under the inverse of a small similarity
    (scale 1.02, rotation vector (0.02, -0.015, 0.01), translation
    (0.03, -0.02, 0.01)), the residual a coarse registration leaves.
    Returns (ref, src, gt) with gt the transform fine_register should find."""
    import torch
    from gaussreg_tpu_torch.gs.fine_registration import (
        gaussians_from_numpy,
        transform_gaussians_device,
    )
    from gaussreg_tpu_torch.ops.transforms import exp_so3

    ref = gaussians_from_numpy(*fine_scene_arrays(n, seed), device=dev)
    gt = torch.eye(4, device=dev)
    gt[:3, :3] = 1.02 * exp_so3(torch.tensor([0.02, -0.015, 0.01], device=dev))
    gt[:3, 3] = torch.tensor([0.03, -0.02, 0.01], device=dev)
    with torch.no_grad():
        src = transform_gaussians_device(ref, torch.linalg.inv(gt))
    return ref, src, gt


def profile_backward(ref, cams):
    """One differentiated render per view at full width, then its backward
    alone under torch.profiler: counts the sort and searchsorted launches
    (the accumulation needs none; the binning sorts in the forward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussreg_tpu_torch.gs.rasterizer.render import render

    means = ref.means.detach().clone().requires_grad_(True)
    loss = sum(render(means, ref.scales, ref.quats, ref.opacities, ref.sh_coeffs, cam,
                      valid=ref.valid).rgb.sum() for cam in cams)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    names = [e.key.lower() for e in prof.key_averages() for _ in range(e.count)]
    sorts = sum("sort" in n for n in names)
    searches = sum("searchsorted" in n for n in names)
    log(f"backward of {len(cams)} renders: {len(names)} device kernels, {sorts} sort and "
        f"{searches} searchsorted launches")


def profile_fine_steps(ref, src, cams, steps: int = 2, top: int = 12):
    """`steps` fine-registration steps (and their probes) under
    torch.profiler: device time by kernel and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussreg_tpu_torch.gs.fine_registration import fine_register

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fine_register(ref, src, torch.eye(4), cams, num_steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, f"fine_register, {steps} steps and their probes", wall_ms, top)


def profile_pair(cfg, model, pair, dev, top: int = 15):
    """One registration under torch.profiler: device time by kernel name
    (the heaviest `top`) and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussreg_tpu_torch import api

    rp, rf, sp, sf, _ = pair
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.coarse_register_clouds(cfg, model, rp, rf, sp, sf, seed=0, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, "one pair", wall_ms, top)


def report_profile(prof, what, wall_ms, top):
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    count = lambda *words: sum(e.count for e in events
                               if any(w in e.key.lower() for w in words))
    for e in events:  # every sort kernel, by name
        if "sort" in e.key.lower():
            log(f"profile:   sort kernel {e.count:5d}x  {e.key[:110]}")
    log(f"profile: {what}, wall {wall_ms:.1f} ms (profiled), device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device kernels "
        f"({count('radixsort', 'radix_sort')} radix-sort and {count('searchsorted')} "
        "searchsorted launches)")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def rot_err(t, gt):
    """Degrees between the rotations of two (4, 4) similarity transforms."""
    import numpy as np

    rot = lambda m: m[:3, :3] / np.linalg.norm(m[0, :3])
    cos = (np.trace(rot(np.asarray(t)).T @ rot(np.asarray(gt))) - 1) / 2
    return math.degrees(math.acos(np.clip(cos, -1, 1)))


def write_scene_plys(directory, cfg, seed):
    """Two 3DGS .ply models of one synthetic scene pair (opaque gaussians
    at the cloud points, SH DC colour from the point colours)."""
    import numpy as np
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.gs.ply import GaussianModel, save_gaussians
    from gaussreg_tpu_torch.gs.sh import rgb_to_sh

    rp, rf, sp, sf, m = random_pair(cfg, seed, normalize_volume=False)
    paths = []
    for name, pts, feats in (("ref.ply", rp, rf), ("src.ply", sp, sf)):
        n = pts.shape[0]
        g = GaussianModel(
            xyz=pts.astype(np.float32),
            f_dc=rgb_to_sh(feats[:, 1:4] / 255.0)[:, :, None].astype(np.float32),
            f_rest=np.zeros((n, 3, 15), np.float32),
            opacity=np.full((n, 1), 3.0, np.float32),
            scales=np.full((n, 3), -4.0, np.float32),
            rots=np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
        )
        path = os.path.join(directory, name)
        save_gaussians(path, g)
        paths.append(path)
    return paths, m


# P2's limits against its plain version on the card: kernel and plain
# version compute the same alpha (the exponent's products and sums rounded
# alike, alpha's accurate exp, the accurate log1p) and differ by the order
# of the prefix and colour sums and by the kernel's transmittance exp
# (ex2.approx, a few ulp of T): 1e-5; B's bf16 rounding of lg may land on
# the other neighbour where the two log1p differ in the last bit: 5e-4 (one
# bf16 step of one lg moves its pixel's later weights by up to 2^-8 |lg|).
# Should exp differ in the last bit, a raw within an ulp of 1/255 flips its
# pair and moves a pixel by up to 1/255 of a colour: at most
# MAX_FLIPPED_PIXELS such pixels, none past 4e-3. Against core A (as the JAX
# probe prints it): C and D within 1e-4 (another rounding of the same
# prefix), B within 1e-2 (bf16 keeps 8 bits of each lg: the prefix is off by
# up to 2^-9 of sum |lg|, and the colour by that share of itself, |ln T| <=
# ~6 here).
P2_LIMITS = {"A": 1e-5, "B": 5e-4, "C": 1e-5, "D": 1e-5}
P2_AGAINST_A = {"B": 1e-2, "C": 1e-4, "D": 1e-4}


def compare_cores(out, ref, core):
    """P2: kend equal; rgb and T within P2_LIMITS[core] of the plain
    version, but for at most MAX_FLIPPED_PIXELS alpha-cut flips. Returns
    the max abs difference."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(out[:, 5], ref[:, 5]):
        raise AssertionError(f"probe_composite_{core}: kend differs from its plain version")
    diff = (out[:, :5] - ref[:, :5]).abs()
    over = ~(diff <= P2_LIMITS[core]).all(dim=1)  # a NaN is over
    flipped = int(over.sum())
    worst = diff.max().item()
    if flipped > MAX_FLIPPED_PIXELS or not worst <= 4e-3:
        raise AssertionError(f"probe_composite_{core}: {flipped} pixels past "
                             f"{P2_LIMITS[core]}, worst {worst}")
    return worst


def probe_phase(dev, kernels):
    """9. The two TPU probes' twins at the probes' shapes: P1 (G=4096, K=128,
    C=8; `onehot` is a direct two-lanes-per-row gather since the card's
    matrix unit has no place in a gather, its plain version the one-hot
    product) and P2 (make_blocks(300, 7)), each variant launched once with the
    counts zeroed just before and read just after; then each held against
    its plain version (P1 bit for bit, and equal to table[idx]; P2 by
    compare_cores, and B-D against A), timed by a slope over graph-replayed
    launches with inputs perturbed per repetition (P1 beside
    torch.index_select), and bounded. P2's bound (`p2.bound`) is the largest
    of the f32 operations at their peak, the transcendentals at
    p2.MUFU_PER_SM_CLOCK results per SM and clock at the card's clock, and
    the bytes; the line names the one that sets it and prints all three."""
    import torch
    from gaussreg_tpu_torch.ops import _cuda
    from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2
    from gaussreg_tpu_torch.tools import probe_vmem_gather as p1
    from gaussreg_tpu_torch.utils.timing import slope

    table, idx = p1.make_inputs(0, device=dev)
    blocks_np, starts_np, _ = p2.make_blocks()
    blocks, starts = torch.from_numpy(blocks_np).to(dev), torch.from_numpy(starts_np).to(dev)
    tiles = starts.numel() - 1
    _cuda.reset_launch_counts()
    gathered = {v: p1.gather(v, table, idx) for v in p1.PLAIN}
    composited = {c: p2.run_fwd(blocks, starts, c, tiles) for c in p2.CORES}
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    names = [f"probe_gather_{v}" for v in p1.PLAIN] + [f"probe_composite_{c}" for c in p2.CORES]
    log(f"probes: P1 at G={p1.G} K={p1.K} C={p1.C}, P2 at {tiles} tiles x "
        f"{blocks.shape[0] // tiles} blocks; launches { {n: counts[n] for n in names} }")
    if any(counts[n] != 1 for n in names):
        raise AssertionError("a probe kernel was not launched once by the probes' run")

    # P1
    ref = table[idx.long()]
    inputs = [p1.make_inputs(1 + i, device=dev) for i in range(64)]
    at = lambda fn: (lambda i: fn(*inputs[i % len(inputs)]))
    t_lib = slope(at(lambda t, i: torch.index_select(t, 0, i)), 8, 40) * 1e3
    b_ms, b_by = bound(p1.gather_bytes(table, idx), 0.0, "f32")
    for v, line in zip(p1.PLAIN, (25, 44, 69)):
        out = gathered[v]
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(p1.PLAIN[v](table, idx), ref)):
            raise AssertionError(f"probe_gather_{v} differs from table[idx]")
        t_k = slope(at(lambda t, i, v=v: p1.gather(v, t, i)), 8, 40) * 1e3
        t_p = slope(at(p1.PLAIN[v]), 8, 40) * 1e3
        log(f"probe_gather_{v}: equal to table[idx] bit for bit, kernel {t_k:.5f} ms, plain "
            f"{t_p:.5f} ms, torch.index_select {t_lib:.5f} ms, bound {b_ms:.6f} ms ({b_by})")
        kernels.append({
            "name": f"probe_gather_{v}", "route": "cuda",
            "source": "gaussreg_tpu_torch/csrc/probe_gather.cu",
            "replaces": f"tools/probe_vmem_gather.py:{line}",
            "launches": counts[f"probe_gather_{v}"], "max_abs_err": (out - ref).abs().max().item(),
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_lib,
        })
    p1_ms = {e["name"]: e["ms"] for e in kernels[-len(p1.PLAIN):]}
    staging = p1_ms["probe_gather_shared"] - p1_ms["probe_gather_onehot"]
    kernels[-len(p1.PLAIN) + list(p1.PLAIN).index("shared")]["staging_ms"] = staging
    log(f"probe_gather_shared (kernel2, the table staged across a cluster of "
        f"{p1.CLUSTER_BLOCKS} blocks) {p1_ms['probe_gather_shared']:.5f} ms beside "
        f"probe_gather_onehot (kernel3, a direct gather) {p1_ms['probe_gather_onehot']:.5f} ms "
        f"and torch.index_select {t_lib:.5f} ms: the staging's share {staging:.5f} ms")

    # P2
    mismatches = p2.log1p_mismatches(dev)
    log(f"probe_composite: the kernels' branch-free log1p against log1pf at every f32 alpha "
        f"in [0, 0.99]: {mismatches} differ")
    if mismatches:
        raise AssertionError("probe_composite: the kernels' log1p differs from log1pf")
    clock_mhz = p2.sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    copies = p2.perturbed(blocks, 16)
    for c in p2.CORES:
        out = composited[c]
        err = compare_cores(out, p2.composite_plain(blocks, starts, c, tiles), c)
        vs_a = (out[:, :5] - composited["A"][:, :5]).abs().max().item()
        if c in P2_AGAINST_A and not vs_a <= P2_AGAINST_A[c]:
            raise AssertionError(f"probe_composite_{c}: {vs_a} from core A")
        t_k = slope(lambda i, c=c: p2.run_fwd(copies[i], starts, c, tiles)) * 1e3
        t_p = cuda_ms(lambda c=c: p2.composite_plain(blocks, starts, c, tiles), reps=2)
        kend = out[:, 5, 0]
        pp = p2.pair_pixels(out, starts)
        b_ms, b_of, parts = p2.bound(out, starts, blocks.shape[0], c, sms, clock_mhz)
        log(f"probe_composite_{c}: kend mean {kend.mean().item():.2f} ({int(kend.sum())} chunks "
            f"walked, {int((kend < blocks.shape[0] // tiles).sum())} tiles left early), "
            f"err vs plain {err:.3e}, "
            f"vs A {vs_a:.3e}; kernel {t_k:.4f} ms ({t_k * 1e6 / blocks.shape[0]:.0f} ns/blk, "
            f"a cluster of {p2.CLUSTER} blocks per tile), plain {t_p:.3f} ms, bound {b_ms:.4f} ms "
            f"by {b_of} ({pp / 1e6:.1f} M pair-pixels: x {p2.OPS_PER_PAIR_PIXEL[c]:.0f} f32 "
            f"operations {parts['f32 operations']:.4f} ms; x "
            f"{p2.TRANSCENDENTALS_PER_PAIR_PIXEL[c]} transcendentals at "
            f"{p2.MUFU_PER_SM_CLOCK} MUFU results per SM and clock, {sms} SMs at "
            f"{clock_mhz:.0f} MHz, {parts['transcendentals']:.4f} ms; bytes "
            f"{parts['bytes']:.4f} ms), {100 * b_ms / t_k:.1f}% of the bound")
        kernels.append({
            "name": f"probe_composite_{c}", "route": "cuda",
            "source": "gaussreg_tpu_torch/csrc/probe_composite.cu",
            "replaces": "tools/probe_kernels_r5.py:189",
            "launches": counts[f"probe_composite_{c}"], "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
            "bound_by": "bytes" if b_of == "bytes" else "operations", "bound_of": b_of,
            "library_ms": None,
        })
    del copies


def snapshot_path(snapshot, ref_ply, src_ply, dev, per_pair):
    """The path `demo --torch_snapshot` takes, run in this process:
    load_for_inference (the reference's neighbour limits, 89 slots at level
    0, past the 48 of K2's 64-row blocks) and register_gs_pair, with the
    launch counts zeroed just before and read just after (per_pair each).
    Then every K2 call of that run is replayed, held against its plain
    version within 4e-3 of its max and timed, as in phase 4. Returns the
    counts."""
    import numpy as np
    import torch
    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.engine.torch_import import load_for_inference
    from gaussreg_tpu_torch.models import kpconv as kpconv_mod
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.ops import _cuda, kpconv_kernel

    cfg = make_cfg()
    cfg, model, report = load_for_inference(snapshot, cfg, create_model(cfg, dev))
    _cuda.reset_launch_counts()
    with Capture(kpconv_mod, "kpconv_fused_apply") as cap:
        res = api.register_gs_pair(ref_ply, src_ply, model, cfg, fine=False, device=dev)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    tr = np.asarray(res["transform"])
    if tr.shape != (4, 4) or not np.isfinite(tr).all():
        raise AssertionError(f"the snapshot path gave the transform {tr}")
    for name, n in per_pair.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {counts[name]} launches on the snapshot path, "
                                 f"expected {n}")
    widths = [args[0].shape[2] for args, _ in cap.calls]
    if max(widths) <= 48:
        raise AssertionError(f"the snapshot path's K2 calls took H = {widths}: none past 48")
    rows, tot = measure("kpconv_fused_apply (snapshot path)", cap.calls,
                        kpconv_kernel.kpconv_fused_apply, kpconv_kernel.reference_apply,
                        within_bf16_step, kpconv_einsums, kpconv_cost, "bf16")
    for row in rows:
        log(row)
    b_ms, b_by = bound(tot["bytes"], tot["ops"], "bf16")
    log(f"snapshot path: load_for_inference (per_layer_kernel_geometry="
        f"{report['per_layer_kernel_geometry']}, neighbour limits "
        f"{tuple(cfg.capacity.neighbor_limits)}) + register_gs_pair; launches "
        f"{ {n: counts[n] for n in per_pair} }; kpconv_fused_apply {len(widths)} calls, "
        f"{sum(h > 48 for h in widths)} past 48 slots, max err vs plain {tot['err']:.3e}, "
        f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, library "
        f"{tot['library_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return counts


def cli_phase(dev, per_pair):
    """10. The CLIs as a user runs them, each in its own process:
    `python -m gaussreg_tpu_torch.tools.demo` on the two .ply files of phase
    3 with the trained checkpoint (the transform within 5 degrees of the
    known rotation), again with --torch_snapshot on a saved
    fake_reference_state_dict() (exit 0, a finite transform), then
    `python -m gaussreg_tpu_torch.tools.fuse` on the written transform (the
    fused .ply reads back, finite, with between N and 2N gaussians). The
    snapshot's path also runs in this process (`snapshot_path`): launches
    counted and K2 held against its plain version at that path's shapes."""
    import numpy as np
    import torch
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.engine.torch_import import fake_reference_state_dict
    from gaussreg_tpu_torch.gs.ply import load_gaussians

    def cli(module, *argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"gaussreg_tpu_torch.tools.{module}", *argv],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{module} exited with {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        (ref_ply, src_ply), gt = write_scene_plys(tmp, make_cfg(), 20_000_100)
        out_dir = os.path.join(tmp, "demo")
        dt = cli("demo", "--ref", ref_ply, "--src", src_ply, "--weights", CKPT,
                 "--output_dir", out_dir)
        names = ("point_cloud_src_org.ply", "point_cloud_ref.ply", "point_cloud_src.ply",
                 "estimated_transform.npz")
        if not all(os.path.exists(os.path.join(out_dir, n)) for n in names):
            raise AssertionError(f"demo wrote {sorted(os.listdir(out_dir))}")
        npz = os.path.join(out_dir, "estimated_transform.npz")
        tr = np.load(npz)["estimated_transform"]
        if tr.shape != (4, 4) or not np.isfinite(tr).all():
            raise AssertionError(f"demo wrote the transform {tr}")
        err = rot_err(tr, gt)
        log(f"cli: demo in {dt:.2f} s (its own process), RRE vs GT {err:.3f} deg")
        if not err < 5.0:
            raise AssertionError(f"demo rotation error {err} deg")

        snapshot = os.path.join(tmp, "snapshot.pth.tar")
        torch.save({"model": {k: torch.from_numpy(v)
                              for k, v in fake_reference_state_dict().items()}}, snapshot)
        out2 = os.path.join(tmp, "demo_snapshot")
        dt = cli("demo", "--ref", ref_ply, "--src", src_ply, "--torch_snapshot", snapshot,
                 "--output_dir", out2)
        tr2 = np.load(os.path.join(out2, "estimated_transform.npz"))["estimated_transform"]
        if tr2.shape != (4, 4) or not np.isfinite(tr2).all():
            raise AssertionError(f"demo --torch_snapshot wrote the transform {tr2}")
        log(f"cli: demo --torch_snapshot (random reference weights) in {dt:.2f} s, a finite "
            "transform")
        snapshot_path(snapshot, ref_ply, src_ply, dev, per_pair)

        fused_ply = os.path.join(tmp, "fused.ply")
        dt = cli("fuse", "--input1", ref_ply, "--input2", src_ply, "--transform_path", npz,
                 "--output", fused_ply)
        fused = load_gaussians(fused_ply)
        n_in = min(load_gaussians(ref_ply).num_gaussians, load_gaussians(src_ply).num_gaussians)
    fields = (fused.xyz, fused.f_dc, fused.f_rest, fused.opacity, fused.scales, fused.rots)
    log(f"cli: fuse in {dt:.2f} s wrote {fused.num_gaussians} gaussians from 2 x ~{n_in}")
    if not (all(np.isfinite(f).all() for f in fields) and n_in <= fused.num_gaussians <= 2 * n_in):
        raise AssertionError(f"fuse wrote {fused.num_gaussians} gaussians from 2 x {n_in}")


TRAIN_STEPS = 30
TRAIN_LR = 3e-4


def train_phase(dev):
    """11. training at full width. (a) make_cfg() on one synthetic pair,
    random_pair(cfg, 0, num_points=20000) (overfit_gate's default), its
    pyramid built once; parameters drawn as the JAX init draws them
    (reset_parameters) from a seeded generator; TRAIN_STEPS steps of
    make_train_step with make_optimizer (Adam at 3e-4, weight decay 1e-6).
    Every step's grad_finite must be 1, the mean loss of the last 5 steps
    under that of the first 5, every parameter moved (the kernel points by
    weight decay), and the launch counts, zeroed after the pyramid, 14 K2
    launches per step and no other. (b) one more step under torch.profiler:
    device busy share, K2's forward ms (its kernel's device events) and
    its backward's (record_function spans around `reference_vjp`), the
    step's heaviest device ops. (c) save_checkpoint, then load_checkpoint
    (parameters and optimizer state) into a new model: the eval step's
    transform bit for bit the trained model's, and every optimizer leaf
    equal. (d) one train step at make_tiny_cfg() on the card and on the CPU
    from the same weights and the same Gumbel noise: the losses within 5e-4
    of themselves (3x the CPU's own sensitivity, 1.6e-4 of the losses when
    every weight moves by 1e-6 of itself; tests/test_torch_port_train.py),
    every gradient finite."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import Pyramid, make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from gaussreg_tpu_torch.engine.trainer import (
        create_train_state,
        make_eval_step,
        make_optimizer,
        make_train_step,
        pair_generator,
    )
    from gaussreg_tpu_torch.models import registration as reg_mod
    from gaussreg_tpu_torch.models.losses import overall_loss
    from gaussreg_tpu_torch.models.matching import sample_gt_node_correspondences_from_gumbel
    from gaussreg_tpu_torch.ops import _cuda
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    cfg = make_cfg()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, lr=TRAIN_LR))
    t0 = time.perf_counter()
    pair = random_pair(cfg, 0, num_points=20000)
    batch = make_pair_batch(cfg, *pair, device=dev)
    torch.cuda.synchronize()
    log(f"train: pair random_pair(cfg, 0, num_points=20000) and its pyramid in "
        f"{time.perf_counter() - t0:.2f} s")
    model = reg_mod.create_model(cfg, dev)
    tx = make_optimizer(cfg, steps_per_epoch=TRAIN_STEPS)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), tx, device=dev)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    step = make_train_step(model, cfg, tx)

    # (a) the steps, launches counted
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors still alive
    _cuda.reset_launch_counts()
    hist = []
    t_all = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t_step = time.perf_counter()
        state, m = step(state, [batch], [pair_generator(dev, 1, i, 0)])
        m = {k: float(v) for k, v in m.items()}  # the host reads the metrics: a sync
        m["seconds"] = time.perf_counter() - t_step
        hist.append(m)
        if (i + 1) % 5 == 0:
            log(f"train: step {i + 1}: loss {m['loss']:.5f} c_loss {m['c_loss']:.5f} f_loss "
                f"{m['f_loss']:.5f} PIR {m['PIR']:.3f} grad_finite {m['grad_finite']:.0f} "
                f"vox_overflow {m['vox_overflow']:.0f} {m['seconds']:.3f} s/step; "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    wall = time.perf_counter() - t_all
    counts = _cuda.launch_counts()
    secs = [h["seconds"] for h in hist]
    first, last = (float(np.mean([h["loss"] for h in hist[sl]])) for sl in
                   (slice(0, 5), slice(-5, None)))
    still = [k for k, v in state.params.items() if torch.equal(v.detach(), start[k])]
    log(f"train: {TRAIN_STEPS} steps in {wall:.3f} s, {np.median(secs):.4f} s/step median "
        f"(steps 2-{TRAIN_STEPS}: {np.mean(secs[1:]):.4f} mean); mean loss first 5 {first:.5f}, "
        f"last 5 {last:.5f}; peak torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before the steps; parameters not moved {still}; "
        f"launches {counts}")
    if not all(h["grad_finite"] == 1.0 for h in hist):
        raise AssertionError(f"train: non-finite gradients: {[h['grad_finite'] for h in hist]}")
    if not last < first:
        raise AssertionError(f"train: mean loss of the last 5 steps {last} not under the first "
                             f"5's {first}")
    if still:
        raise AssertionError(f"train: parameters that did not move: {still}")
    want = {name: (14 * TRAIN_STEPS if name == "kpconv_fused_apply" else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")

    # (b) one step under torch.profiler; the profiler does not tie the
    # kernel that K2's ctypes wrapper launches to the span around it, so
    # K2's forward is read by its kernel's name and the backward (torch
    # ops) by its spans
    orig_vjp = kk.reference_vjp

    def vjp_span(*a, **kw):
        with record_function("k2_backward"):
            return orig_vjp(*a, **kw)

    with Swap(kk, "reference_vjp", vjp_span):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            state, m = step(state, [batch], [pair_generator(dev, 1, TRAIN_STEPS, 0)])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_prof) * 1e3
    fwd = [e for e in prof.key_averages() if "kpconv_fused_kernel" in e.key
           and str(getattr(e, "device_type", "")).endswith("CUDA")]
    fwd_ms = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in fwd) / 1e3
    fwd_n = sum(e.count for e in fwd)
    # the CPU-side spans' device time: that of the kernels launched inside
    # them (the span's GPU-side annotation also covers the gaps between them)
    bwd = [e for e in prof.key_averages() if e.key == "k2_backward"
           and str(getattr(e, "device_type", "")).endswith("CPU")]
    bwd_ms = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                 for e in bwd) / 1e3
    bwd_n = sum(e.count for e in bwd)
    log(f"train profile: K2 forward {fwd_ms:.3f} ms device over {fwd_n} kernels, K2 backward "
        f"(reference_vjp) {bwd_ms:.3f} ms device over {bwd_n} spans, per step")
    report_profile(prof, "one train step", wall_ms, 15)
    if fwd_n != 14 or bwd_n != 14 or not bwd_ms > 0:
        raise AssertionError(f"train profile: {fwd_n} K2 forward kernels, {bwd_n} backward spans "
                             f"of {bwd_ms} ms")

    # (c) checkpoint round trip
    eval_step = make_eval_step(model, cfg)
    est, met = eval_step(batch, torch.Generator(device=dev).manual_seed(5))
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, "train", state.params, state.opt_state,
                               {"step": state.step})
        model2 = reg_mod.create_model(cfg, dev)
        template = tx.init({k: torch.zeros_like(v) for k, v in state.params.items()})
        params2, opt2 = load_checkpoint(path, template)
        model2.load_state_dict(params2)
        size = os.path.getsize(path)
    est2, _ = make_eval_step(model2, cfg)(batch, torch.Generator(device=dev).manual_seed(5))
    def leaves(st):
        if isinstance(st, tuple):
            return [t for x in st for t in leaves(x)]
        return list(st.values()) if isinstance(st, dict) else [st]

    opt_equal = all((torch.equal(a, b) if torch.is_tensor(a) else a == b)
                    for a, b in zip(leaves(state.opt_state), leaves(opt2)))
    log(f"train checkpoint: {size} bytes; eval step before and after the round trip: RRE "
        f"{float(met['RRE']):.4f} deg, RR {float(met['RR']):.0f}, PIR {float(met['PIR']):.3f}, "
        f"transform equal {torch.equal(est, est2)}, optimizer state equal {opt_equal}")
    if not (torch.equal(est, est2) and opt_equal):
        raise AssertionError("train checkpoint: the round trip changed the model or the optimizer")

    # (d) card against CPU at make_tiny_cfg()
    tiny = make_tiny_cfg()
    tb = make_pair_batch(tiny, *random_pair(tiny, 20_000_300, num_points=500), device="cpu")
    to = lambda f, d: tuple(t.to(d) for t in f) if isinstance(f, tuple) else f.to(d)
    tb_dev = tb._replace(pyramid=Pyramid(*[to(f, dev) for f in tb.pyramid]),
                         features=tb.features.to(dev), transform=tb.transform.to(dev))
    m_cpu = reg_mod.create_model(tiny, "cpu")
    m_cpu.reset_parameters(torch.Generator().manual_seed(0))
    m_dev = copy.deepcopy(m_cpu).to(dev)
    nc = tb.pyramid.points[-1].shape[1]
    gumbel = torch.from_numpy(np.random.default_rng(0).gumbel(size=(nc, nc)).astype(np.float32))

    def one(model, b):
        g = gumbel.to(b.transform.device)
        with Swap(reg_mod, "sample_gt_node_correspondences",
                  lambda gen, *a: sample_gt_node_correspondences_from_gumbel(g, *a)):
            out = model(b, None, train=True, with_transform=False)
        losses = overall_loss(tiny, out, b.transform)
        losses["loss"].backward()
        bad = [n for n, p in model.named_parameters()
               if p.requires_grad and (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
        return {k: float(v.detach()) for k, v in losses.items()}, bad

    before = kk.KERNEL.launches
    l_dev, bad_dev = one(m_dev, tb_dev)
    launched = kk.KERNEL.launches - before
    l_cpu, bad_cpu = one(m_cpu, tb)
    rel = {k: abs(l_dev[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    log(f"train card vs CPU (make_tiny_cfg, one step, same weights and Gumbel noise): card "
        f"{l_dev}, CPU {l_cpu}, relative differences {rel}; K2 launches on the card {launched}")
    if bad_dev or bad_cpu or launched != 14 or max(rel.values()) > 5e-4:
        raise AssertionError(f"train card vs CPU: {rel}, no or non-finite gradient for "
                             f"{bad_dev + bad_cpu}, {launched} K2 launches")
    return {"s_per_step": float(np.median(secs)), "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}


TRAIN_LOG_LINE = re.compile(r"epoch (\d+) it (\d+)/(\d+): (.*), prep ([\d.]+)s proc ([\d.]+)s")
EPOCH_LINE = re.compile(r"epoch (\d+) trained: prep ([\d.]+)s proc ([\d.]+)s per step; the "
                        r"prefetch thread built a batch in ([\d.]+)s")


def read_train_log(path):
    """The trainval log's per-step metrics ({epoch, it, metrics...}) and its
    per-epoch timings (epoch -> prep, proc, build seconds)."""
    steps, epochs = [], {}
    with open(path) as f:
        for line in f:
            m = TRAIN_LOG_LINE.search(line)
            if m:
                metrics = dict(kv.split(": ") for kv in m.group(4).split(", "))
                steps.append({"epoch": int(m.group(1)), "it": int(m.group(2)),
                              "prep_mean": float(m.group(5)), "proc_mean": float(m.group(6)),
                              **{k: float(v) for k, v in metrics.items()}})
            m = EPOCH_LINE.search(line)
            if m:
                epochs[int(m.group(1))] = tuple(float(x) for x in m.group(2, 3, 4))
    return steps, epochs


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_tool(module, *argv, timeout=900):
    """`python -m gaussreg_tpu_torch.tools.<module> argv` in its own process;
    fails on a non-zero exit. Returns (seconds, stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"gaussreg_tpu_torch.tools.{module}", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited with {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    return time.perf_counter() - t0, proc.stdout


def check_train_log(what, path, want_steps, snapshot_step):
    import numpy as np

    """Every logged step finite with grad_finite 1, `want_steps` of them, and
    the snapshot's step; logs the per-epoch prep/proc/build means and each
    step's seconds (from the log's running means, logged every step: to
    ~1 ms)."""
    steps, epochs = read_train_log(path)
    bad = [s for s in steps if s["grad_finite"] != 1.0 or not math.isfinite(s["loss"])]
    for e, (prep, proc, build) in sorted(epochs.items()):
        ep = [s for s in steps if s["epoch"] == e]
        each = [s["it"] * s["proc_mean"] - (s["it"] - 1) * prev["proc_mean"]
                for prev, s in zip([{"proc_mean": 0.0}] + ep, ep)]
        later = f", median of steps 2-{len(ep)} {float(np.median(each[1:])):.4f} s" \
            if len(each) > 1 else ""
        log(f"{what}: epoch {e}: {len(ep)} steps, prep {prep:.4f} s (the wait for the next "
            f"batch), proc {proc:.4f} s/step, the prefetch thread built a batch in {build:.4f} s; "
            f"steps {[round(t, 3) for t in each]} s{later}")
    with open(os.path.join(os.path.dirname(path), "snapshot.json")) as f:
        meta = json.load(f)
    log(f"{what}: {len(steps)} steps logged, loss {steps[0]['loss']:.4f} -> "
        f"{steps[-1]['loss']:.4f}; snapshot {meta}")
    if len(steps) != want_steps or bad or meta["step"] != snapshot_step:
        raise AssertionError(f"{what}: {len(steps)} steps (want {want_steps}), not finite or "
                             f"skipped {bad}, snapshot {meta} (want step {snapshot_step})")


def write_scannet_tree(root, cfg, seeds):
    """A fake ScanNet-GSReg tree in the reference's layout: per subset two
    scenes from write_scene_plys (B = A's scene under a known similarity
    m), train.pkl with m as the pair's rotation and translation, test.pkl
    and test_transformations.npz with identity frame transforms and m as
    the GT. Returns {test scene: m}."""
    import pickle

    import numpy as np

    metas, gts = {"train": [], "test": []}, {}
    seeds = iter(seeds)
    for subset in ("train", "test"):
        for k in range(2):
            scene = f"scene{k:04d}_00"
            with tempfile.TemporaryDirectory() as tmp:
                (ref_ply, src_ply), m = write_scene_plys(tmp, cfg, next(seeds))
                rel = {}
                for tag, ply in (("A", ref_ply), ("B", src_ply)):
                    rel[tag] = f"{subset}/{scene}/{tag}/output/point_cloud/iteration_10000"
                    os.makedirs(os.path.join(root, rel[tag]))
                    os.replace(ply, os.path.join(root, rel[tag], "point_cloud.ply"))
            metas[subset].append({
                "scene_name": scene, "frag_id0": 0, "frag_id1": 1, "overlap": 0.8,
                "pcd0": f"{rel['A']}/point_cloud.ply", "pcd1": f"{rel['B']}/point_cloud.ply",
                "rotation": m[:3, :3].copy(), "translation": m[:3, 3].copy(),
            })
            if subset == "test":
                gts[scene] = m
    for subset, meta in metas.items():
        with open(os.path.join(root, f"{subset}.pkl"), "wb") as f:
            pickle.dump(meta, f)
    eye = {s: np.eye(4, dtype=np.float32) for s in gts}
    np.savez(os.path.join(root, "test_transformations.npz"), transformations={
        "ref_transformations_list": eye, "src_transformations_list": dict(eye),
        "gt_transformations_list": gts,
    })
    return gts


def cli_train_eval_phase(dev, per_pair):
    """12. train and evaluate through the CLIs. (a) `trainval --synthetic`
    at make_cfg() on 8 pool pairs with 4 validation pairs, --distributed at
    world 1 on NCCL (explicit coordinator), one epoch, then `--resume
    --max_epoch 2` in a new process: 16 logged steps, every grad_finite 1,
    finite losses, the snapshot at step 16; per epoch the prep (wait),
    proc (step) and the prefetch thread's build seconds (epoch 2 replays
    the batch cache). (b) `ddp_check` with 2 gloo ranks on this card at
    make_tiny_cfg() (pairs 0 and 1, 2 steps): the ranks bit-equal after 2
    steps, their step-1 metrics equal to a 1-rank run's in this process;
    the all-reduce's ms. (c) a fake ScanNet-GSReg tree (`write_scannet_tree`):
    `trainval --data_root` for one epoch at make_cfg() with augmentation
    (every step finite), then `eval_scannet --weights` (the trained
    checkpoint) in this process with the launch counts zeroed before and
    read after (per scene 13 K1, 14 K2, 1 fused K3), every scene under 5
    degrees RRE; then `--fine --fine_steps 20` on one scene: a finite
    transform, K4-K6 launched. (d) `eval_synthetic` on phase 2's 8
    held-out pairs: recall_RMSE<0.2 = 1.0."""
    import contextlib
    import io

    import numpy as np
    import torch
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.ops import _cuda
    from gaussreg_tpu_torch.tools import ddp_check, eval_scannet, eval_synthetic

    cfg = make_cfg()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) synthetic training with a resume, NCCL at world 1
        out = os.path.join(tmp, "synthetic")
        common = ["--synthetic", "--synthetic_pairs", "8", "--val_pairs", "4", "--log_steps", "1",
                  "--output_dir", out, "--distributed", "--num_processes", "1",
                  "--process_id", "0"]
        dt1, _ = run_tool("trainval", *common, "--coordinator", f"localhost:{free_port()}",
                          "--max_epoch", "1")
        dt2, _ = run_tool("trainval", *common, "--coordinator", f"localhost:{free_port()}",
                          "--max_epoch", "2", "--resume")
        log(f"trainval: epoch 1 in {dt1:.2f} s, the resumed epoch 2 in {dt2:.2f} s "
            "(each its own process, NCCL at world 1)")
        with open(os.path.join(out, "train.log")) as f:
            if f.read().count("devices=1 global_batch=1") != 2:
                raise AssertionError("trainval: the log does not read devices=1 twice")
        check_train_log("trainval", os.path.join(out, "train.log"), 16, 16)

        # (b) two gloo ranks on this card against one process
        runs = {}
        for world in (2, 1):
            d = os.path.join(tmp, f"ddp{world}")
            argv = ["--world", str(world), "--steps", "2", "--output_dir", d, "--backend", "gloo"]
            if ddp_check.main(argv) != 0:
                raise AssertionError(f"ddp_check --world {world} failed")
            runs[world] = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(world)]
        r0, r1 = runs[2]
        unequal = [k for k in r0 if k.split(":")[1:2] in (["param"], ["grad"], ["metric"])
                   and not np.array_equal(r0[k], r1[k])]
        metrics = sorted(k for k in r0 if k.startswith("step1:metric:"))
        off = {k: (float(r0[k]), float(runs[1][0][k])) for k in metrics
               if float(r0[k]) != float(runs[1][0][k])}
        reduce_ms = [float(r0[f"step{s}:allreduce_ms"]) for s in (1, 2)]
        step_s = [float(r0[f"step{s}:seconds"]) for s in (1, 2)]
        log(f"ddp_check: 2 gloo ranks on one card, make_tiny_cfg(), 2 steps: leaves unequal "
            f"between the ranks {unequal}; step-1 metrics against 1 rank, unequal {off}; "
            f"gradient all-reduce {reduce_ms[0]:.3f}, {reduce_ms[1]:.3f} ms; step "
            f"{step_s[0]:.3f}, {step_s[1]:.3f} s (rank 0); 1 rank: step "
            f"{float(runs[1][0]['step2:seconds']):.3f} s")
        if unequal or off or int(r0["skipped"]) or int(r0["step"]) != 2:
            raise AssertionError(f"ddp_check: ranks unequal {unequal}, step 1 against one rank "
                                 f"{off}, skipped {int(r0['skipped'])}")

        # (c) the ScanNet-GSReg path
        root = os.path.join(tmp, "scannet")
        gts = write_scannet_tree(root, cfg, range(20_000_200, 20_000_204))
        out = os.path.join(tmp, "scannet_run")
        dt, _ = run_tool("trainval", "--data_root", root, "--max_epoch", "1", "--log_steps", "1",
                         "--output_dir", out)
        log(f"trainval --data_root: one epoch (2 train pairs, augmented; 2 test pairs "
            f"validated) in {dt:.2f} s")
        check_train_log("trainval --data_root", os.path.join(out, "train.log"), 2, 2)

        def evaluate(*extra):
            est_dir = os.path.join(tmp, "eval")
            _cuda.reset_launch_counts()
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = eval_scannet.main(["--scannet_path", root, "--weights", CKPT,
                                        "--output_path", est_dir, *extra])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            est = np.load(os.path.join(est_dir, "estimated_transform.npz"),
                          allow_pickle=True)["estimated_transform_list"].item()
            if rc != 0 or "rse < 0.2:" not in text.getvalue():
                raise AssertionError(f"eval_scannet {extra}: rc {rc}\n{text.getvalue()[-2000:]}")
            return est, counts, dt, text.getvalue()

        est, counts, dt, text = evaluate()
        errs = {s: rot_err(t, gts[s]) for s, t in est.items()}
        log(f"eval_scannet: {len(est)} scenes in {dt:.3f} s ({dt / len(est):.3f} s/scene, "
            f"host loading included); RRE {errs}; launches {counts}; printout "
            f"{text.strip().splitlines()[-9:]}")
        want = {name: n * len(gts) for name, n in per_pair.items()}
        if set(est) != set(gts) or not all(e < 5.0 for e in errs.values()) or \
                any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"eval_scannet: RRE {errs}, launches {counts}, want {want}")

        est, counts, dt, _ = evaluate("--fine", "--fine_steps", "20", "--limit_scenes", "1")
        (scene, t), = est.items()
        log(f"eval_scannet --fine --fine_steps 20: 1 scene in {dt:.3f} s, RRE "
            f"{rot_err(t, gts[scene]):.3f} deg; launches {counts}")
        if not np.isfinite(t).all() or not all(counts[k] > 0 for k in (
                "rasterize_forward", "rasterize_backward", "segment_accumulate")):
            raise AssertionError(f"eval_scannet --fine: {t}, launches {counts}")

        # (d) eval_synthetic on phase 2's held-out pairs
        transcript = os.path.join(tmp, "eval_transcript.json")
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = eval_synthetic.main(["--weights", CKPT, "--pairs", "8", "--output", transcript])
        dt = time.perf_counter() - t0
        with open(transcript) as f:
            summary = json.load(f)["summary"]
        log(f"eval_synthetic: 8 pairs in {dt:.3f} s; {summary}")
        if rc != 0 or summary["num_pairs"] != 8 or summary["recall_RMSE<0.2"] != 1.0:
            raise AssertionError(f"eval_synthetic: rc {rc}, {summary}")


def accumulate_generic_cost(rows, gid, num_out):
    """K6's own signature: the rows (64 B each) and ids read once, the
    (num_out, 16) output written once; one f32 add per row and channel
    whose id lies in the table."""
    live = float(((gid >= 0) & (gid < num_out)).sum())
    return (rows.shape[0] * (64 + 4) + num_out * 64, live * 16,
            f"R={rows.shape[0]} num_out={num_out}")


# phase 13(b2): K3 past k = 128, on the widest pyramid call's rows and the
# search's first block (the first k past the lane queues of 8), and
# knn_search's k (past the 200 KiB of chunk winners the card once refused)
BIG_KS = (129, 700)
PYRAMID_REPEATS = 10  # turns of the fused pyramid, in place and through the old route
KNN_K = 2048


def radius_search_plain():
    """The brute-force radius search with K3's plain version in place of the
    kernel (same device, same distances)."""
    from gaussreg_tpu_torch.ops import neighbors as nb
    from gaussreg_tpu_torch.ops import select_k

    def run(*args, **kw):
        with Swap(nb, "select_min_k", select_k.select_min_k_plain):
            return nb.radius_search(*args, **kw)

    return run


def compare_sharded(rec, out, grads, tol_rgb=5e-4, tol_depth=2e-3, tol_grad=2e-3):
    """render_sharded's gathered image and gradients (one rank's record)
    against render's: rgb and T within 5e-4, depth within 2e-3, gradients
    within 2e-3 of each gradient's max (the JAX package's limits for its
    render_sharded). A pixel where the slice's shifted screen coordinates
    round otherwise may cross the 1/255 alpha cut: at most 0.1 % of the
    pixels may exceed the limit, none by more than 1/255 of a colour (or of
    the depth range). Returns the max errors and the pixels past the limit."""
    import numpy as np

    errs, npix = {}, out.rgb.shape[0] * out.rgb.shape[1]
    errs["pixels_equal"] = all(
        np.array_equal(rec[k], getattr(out, k).detach().cpu().numpy())
        for k in ("rgb", "depth", "transmittance"))
    for key, want, tol in (("rgb", out.rgb, tol_rgb), ("depth", out.depth, tol_depth),
                           ("transmittance", out.transmittance, tol_rgb)):
        want = want.detach().cpu().numpy()
        diff = np.abs(rec[key] - want)
        per_pixel = diff.reshape(npix, -1).max(axis=1)
        over = int((per_pixel > tol).sum())
        cap = (1 / 255 + tol) * (np.abs(want).max() if key == "depth" else 1.0)
        errs[key] = (float(diff.max()), over)
        if over > 1e-3 * npix or diff.max() > cap:
            raise AssertionError(f"render_sharded {key}: max err {diff.max()}, {over} pixels "
                                 f"past {tol}")
    for name, g in grads.items():
        g = g.cpu().numpy()
        scale = np.abs(g).max() + 1e-6
        err = float(np.abs(rec[f"grad:{name}"] - g).max() / scale)
        errs[f"grad:{name}"] = err
        if not err <= tol_grad:
            raise AssertionError(f"render_sharded gradient {name}: {err} of its max > {tol_grad}")
    return errs


# render_sharded's comparison with render: a per-gaussian tile cap that
# drops no pair of the fine scene's first view (at the default 16 both drop
# pairs there, and different ones: the slices cap each slice's part of a
# bbox, the JAX package's per-slice cap accounting)
SHARDED_MAX_TILES = 64


def library_phase(cfg, dev, pair, fine_ref, cams):
    """13. the library surface beyond the main path, at full width.
    (a) `make_pair_batch_eager` (the pyramid op by op, so that a route can
    be swapped in) on one held-out pair with every grid search
    through the legacy select_kernel="pallas" branch (K3's generic entry
    over each query's window distances; launch counts zeroed before and read
    after: 13 launches of the select_min_k route, no other K3 route, no
    window_select_idx; `k3_routes_run` prints each call's route), its pyramid
    equal to the fused route's index for index; both pyramids timed (host
    clock, a device sync, second of two runs); the 13 captured K3 calls held
    against the plain version and timed beside torch.topk and their bound.
    The fused route is run with K1 in place and through the old route (the
    gather, then the gathered entry), equal index for index: once each to
    warm, then PYRAMID_REPEATS turns alternating which route runs first,
    each run timed and its peak torch.cuda.max_memory_allocated read (reset
    before, less what was held before); the medians are kept. Then
    `make_pair_batch`, the build as one replayed CUDA graph, on the same
    pair: equal to the in-place build bit for bit, and PYRAMID_REPEATS runs
    timed the same way.
    (b) the brute-force radius_search at N = M = 30 720 (level 0 of that
    pair's reference cloud at the level-0 radius, limit 35) through K3's
    select_min_k_wide route (30 launches of 1024 query rows), equal to the
    same search with K3's plain version on the card; the search timed; its
    30 K3 calls held and timed as in (a). (b2) K3 past k = 128 (the
    filter or the radix select, as select_k.route names them): on the
    widest pyramid call's rows (61 440 x 2 304) at each k of
    BIG_KS, on the search's first block (1 024 x 30 720) at k = 129, and
    knn_search at k = KNN_K on the same level-0 points (its 30 blocks of
    1 024 query rows; launch counts zeroed before and read after), equal
    to the same search with K3's plain version on the card; each call
    launched once more with the counts read around it (`k3_routes_run`),
    held and timed as in (a). (c) K6's
    own signature (`segment_accumulate`: the counting-sort entry, four
    kernels and a memset per launch) on one fine
    step's gradient rows and compacted ids per view, equal bit for bit to
    segment_accumulate_plain on the host, timed beside its plain version on
    the card and index_add_ (into zeros, as the plain version) by graph
    slopes (entry and index_add_ in turns, twice; the kernels line's `ms`
    and `library_ms`) and by CUDA events (mean of 20, twice; `events_ms`);
    then, through the same entry, one id holding ~10 % of the first view's
    rows (the rest random) and every row on one id, so that the long-run
    paths (a block's shared-memory sort; its row-order walk of the ids)
    launch: each equal bit for bit to the plain version and across two
    calls, and timed. (d) a make_cfg()-width
    KPConvFPN forward on that pair's pyramid at kernel_size 20 and 36
    (seeded flax-distributed weights): 14 einsum-route calls and no K2
    launch each, finite outputs of the expected shapes, timed. (e)
    render_sharded with 2 gloo ranks on this card
    (tools.render_sharded_check) on the fine scene's reference model, one
    640x480 view, 32x32 tiles, SH degree 3, a tile cap that drops no pair
    (SHARDED_MAX_TILES), forward and backward, against render in this
    process (`compare_sharded`); K4/K5/K6 launches, forward
    and backward ms and the gradient all-reduce's ms per rank.
    Returns the seven kernel entries."""
    import functools

    import numpy as np
    import torch
    from gaussreg_tpu_torch.data import pipeline as pipeline_mod
    from gaussreg_tpu_torch.gs import fine_registration as fine_mod
    from gaussreg_tpu_torch.gs.rasterizer import accumulate
    from gaussreg_tpu_torch.gs.rasterizer import kernels as raster_mod
    from gaussreg_tpu_torch.gs.rasterizer.render import render
    from gaussreg_tpu_torch.models import kpconv as kpconv_mod
    from gaussreg_tpu_torch.models.backbone import KPConvFPN
    from gaussreg_tpu_torch.ops import _cuda, fused_select, kpconv_kernel, select_k
    from gaussreg_tpu_torch.ops import neighbors as nb
    from gaussreg_tpu_torch.tools import render_sharded_check as rsc

    entries = []
    rp, rf, sp, sf, m = pair

    # (a) the pyramid through the pallas branch, built op by op (each route
    # is swapped in for the call)
    def batch(kern):
        search = functools.partial(nb.grid_radius_search, select_kernel=kern)
        with Swap(pipeline_mod, "grid_radius_search", search):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = pipeline_mod.make_pair_batch_eager(cfg, rp, rf, sp, sf, m, device=dev)
            torch.cuda.synchronize()
            return b, (time.perf_counter() - t0) * 1e3

    def old_route(q, lsle, wrow, px, py, pz, pidx, limit, nruns, wspan):
        return fused_select.window_select_idx(
            *gathered_args(q, lsle, wrow, px, py, pz, pidx, limit, nruns, wspan))

    def fused_run(route):
        """The fused pyramid with K1 in place or through the old route: its
        ms and the peak memory allocated across it above what was held
        before, in bytes."""
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with Swap(nb, "window_select_runs", old_route if route == "old route"
                  else nb.window_select_runs):
            b, t = batch("fused")
        return b, t, torch.cuda.max_memory_allocated() - held

    # both routes warm, then PYRAMID_REPEATS turns, which runs first alternating
    routes = ("in place", "old route")
    runs = {route: fused_run(route) for route in routes}
    times = {route: [] for route in routes}
    peaks = {route: 0 for route in routes}
    for turn in range(PYRAMID_REPEATS):
        for route in routes if turn % 2 == 0 else routes[::-1]:
            runs[route] = fused_run(route)
            times[route].append(runs[route][1])
            peaks[route] = max(peaks[route], runs[route][2])
    t_fused, t_old = (statistics.median(times[route]) for route in routes)
    peak_fused, peak_old = (peaks[route] for route in routes)
    fused, old = runs["in place"][0], runs["old route"][0]
    del runs
    graph_times = []
    for _ in range(PYRAMID_REPEATS + 1):  # the first may be the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed = pipeline_mod.make_pair_batch(cfg, rp, rf, sp, sf, m, device=dev)
        torch.cuda.synchronize()
        graph_times.append((time.perf_counter() - t0) * 1e3)
    t_graph = statistics.median(graph_times[1:])
    flat = lambda b: [t for f in (*b.pyramid, b.features) for t in (f if isinstance(f, tuple)
                                                                  else (f,))]
    if not all(torch.equal(a, b) for a, b in zip(flat(graphed), flat(fused))):
        raise AssertionError("make_pair_batch's graph differs from the build op by op")
    log(f"pyramid as one CUDA graph (make_pair_batch): equal to the build op by op bit for bit; "
        f"median {t_graph:.3f} ms of {graph_times[1:]} (host clock, device synced, warm)")
    del graphed
    for route in routes:
        log(f"pyramid (13 grid searches, one make_cfg() pair), fused route, K1 {route}: median "
            f"{statistics.median(times[route]):.3f} ms of {times[route]} (host clock, device "
            f"synced, make_pair_batch_eager, warm, {PYRAMID_REPEATS} turns alternating which route "
            f"runs first); torch.cuda.max_memory_allocated across a run at most "
            f"{peaks[route] / 2**30:.3f} GiB above what was held before it")
    for field in ("neighbors", "subsampling", "upsampling"):
        for lvl, (a, b) in enumerate(zip(getattr(fused.pyramid, field),
                                         getattr(old.pyramid, field))):
            if not torch.equal(a, b):
                raise AssertionError(f"pyramid {field}[{lvl}]: K1 in place differs from the old "
                                     f"route in {(a != b).sum().item()} entries")
    del old
    wins = sum(a < b for a, b in zip(times["in place"], times["old route"]))
    log(f"pyramid: K1 in place equal to the old route index for index; peak "
        f"{peak_fused / 2**30:.3f} GiB against {peak_old / 2**30:.3f} GiB "
        f"({(peak_old - peak_fused) / 2**30:.3f} GiB less), median {t_fused:.3f} ms against "
        f"{t_old:.3f} ms, in place faster in {wins} of {PYRAMID_REPEATS} turns")
    batch("pallas")
    _cuda.reset_launch_counts()
    with Capture(nb, "select_min_k") as c3:
        pallas, t_pallas = batch("pallas")
    counts = _cuda.launch_counts()
    pallas_launches = counts["select_min_k"]
    for field in ("neighbors", "subsampling", "upsampling"):
        for lvl, (a, b) in enumerate(zip(getattr(fused.pyramid, field),
                                         getattr(pallas.pyramid, field))):
            if not torch.equal(a, b):
                raise AssertionError(f"pyramid {field}[{lvl}]: the pallas route differs from "
                                     f"the fused route in {(a != b).sum().item()} entries")
    if int(fused.pyramid.search_overflow) != int(pallas.pyramid.search_overflow):
        raise AssertionError("the two routes count another search overflow")
    log(f"pyramid (13 grid searches, one make_cfg() pair): pallas route (K3 select_min_k) "
        f"equal to the fused route (K1) index for index; {t_pallas:.3f} ms against "
        f"{t_fused:.3f} ms (host clock, device synced, make_pair_batch_eager); launches {counts}")
    if (pallas_launches != 13 or counts["window_select_idx"] != 0
            or any(counts[r] for r in select_k.ROUTES if r != "select_min_k")):
        raise AssertionError(f"the pallas pyramid launched {counts}")
    k3_routes_run(c3.calls, "the pallas pyramid")
    rows, tot = measure("select_min_k (pallas pyramid)", c3.calls, select_k.select_min_k,
                        select_k.select_min_k_plain, exact, select_topk, select_cost, "f32",
                        plain_reps=2)
    widest = max((args for args, _ in c3.calls), key=lambda a: a[0].numel())[0]
    del c3
    for row in rows:
        log(row)
    entry = kernel_entry("select_min_k:pallas_pyramid", "gaussreg_tpu_torch/csrc/select_k.cu",
                         "gaussreg_tpu/ops/select_k.py:88", pallas_launches, tot, "f32")
    entry["pyramid_ms"] = {"pallas": t_pallas, "fused": t_fused, "fused_old_route": t_old,
                           "graph": t_graph,
                           "fused_turns": times["in place"],
                           "fused_old_route_turns": times["old route"]}
    entry["pyramid_peak_bytes"] = {"fused": peak_fused, "fused_old_route": peak_old}
    entries.append(entry)
    del pallas

    # (b) the brute-force search at level-0 width: K3's wide mode
    pts, msk = fused.pyramid.points[0][0], fused.pyramid.masks[0][0]
    radius, limit = cfg.backbone.init_radius, cfg.capacity.neighbor_limits[0]
    args = (pts, pts, msk, msk, radius, limit)
    _cuda.reset_launch_counts()
    with Capture(nb, "select_min_k") as cw:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = nb.radius_search(*args)
        torch.cuda.synchronize()
        t_search = (time.perf_counter() - t0) * 1e3
    counts = _cuda.launch_counts()
    wide_launches = counts["select_min_k_wide"]
    want = radius_search_plain()(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"radius_search through the wide mode differs from its plain "
                             f"version in {(got != want).sum().item()} entries")
    t_search2 = cuda_ms(lambda: nb.radius_search(*args), reps=3)
    t_search_plain = cuda_ms(lambda: radius_search_plain()(*args), reps=2)
    found = float((got < pts.shape[0]).float().sum(dim=1).mean())
    log(f"radius_search N = M = {pts.shape[0]} (r={radius}, limit {limit}): wide-mode launches "
        f"{wide_launches}, equal to its plain version; {t_search:.3f} ms (host clock), "
        f"{t_search2:.3f} ms (events, mean of 3), with the plain selection {t_search_plain:.3f} "
        f"ms; {found:.2f} neighbours per query")
    if (wide_launches != -(-pts.shape[0] // 1024)
            or any(counts[r] for r in select_k.ROUTES if r != "select_min_k_wide")):
        raise AssertionError(f"radius_search launched {counts}")
    k3_routes_run(cw.calls, "radius_search")
    rows, tot = measure("select_min_k_wide", cw.calls, select_k.select_min_k,
                        select_k.select_min_k_plain, exact, select_topk, select_cost, "f32",
                        plain_reps=2)
    block = cw.calls[0][0][0]
    del cw
    log(rows[0])
    log(f"select_min_k_wide: {len(rows)} calls, shapes as above")
    entry = kernel_entry("select_min_k_wide", "gaussreg_tpu_torch/csrc/select_k.cu",
                         "gaussreg_tpu/ops/select_k.py:88", wide_launches, tot, "f32")
    entry["radius_search_ms"] = t_search2
    entries.append(entry)
    del fused

    # (b2) K3 past k = 128: the widest pyramid call's rows, the search's
    # first block, and knn_search on the same points
    big = [(f"widest_k{kk}", [((widest, kk), {})]) for kk in BIG_KS]
    big.append(("block_k129", [((block, 129), {})]))
    _cuda.reset_launch_counts()
    with Capture(nb, "select_min_k") as ck:
        got = nb.knn_search(pts, pts, msk, msk, KNN_K)
    counts = _cuda.launch_counts()
    with Swap(nb, "select_min_k", select_k.select_min_k_plain):
        want = nb.knn_search(pts, pts, msk, msk, KNN_K)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"knn_search at k = {KNN_K} differs from its plain version in "
                             f"{(got[0] != want[0]).sum().item()} entries")
    log(f"knn_search N = M = {pts.shape[0]}, k = {KNN_K}: equal to its plain version; "
        f"launches {counts}")
    if sum(counts[r] for r in select_k.ROUTES) != -(-pts.shape[0] // 1024):
        raise AssertionError(f"knn_search launched {counts}")
    big.append((f"knn_k{KNN_K}", ck.calls))
    del ck, got, want
    for what, calls in big:
        launches = k3_routes_run(calls, what)
        name = select_k.route(calls[0][0][0].shape[1], calls[0][0][1], calls[0][0][0].shape[0])
        rows, tot = measure(f"{name}:{what}", calls, select_k.select_min_k,
                            select_k.select_min_k_plain, exact, select_topk, select_cost, "f32",
                            plain_reps=2)
        log(rows[0])
        entries.append(kernel_entry(f"{name}:{what}", "gaussreg_tpu_torch/csrc/select_k.cu",
                                    "gaussreg_tpu/ops/select_k.py:88", launches[name], tot, "f32"))
    del widest, block, big

    # (c) K6's own signature on one fine step's rows
    with Capture(raster_mod, "rasterize_backward") as c5, \
            Capture(raster_mod, "accumulate_pairs") as c6:
        fine_mod.fine_register(fine_ref, fine_ref, torch.eye(4), cams, num_steps=1)
    torch.cuda.synchronize()
    nv = len(cams)
    calls = []
    for (a5, _), (a6, _) in zip(c5.calls[-nv:], c6.calls[-nv:]):
        sorted_gid, bwd_blocks = a5[1], a5[5]
        grad_rows, _, _, starts, offs, _, num_out = a6
        ids = raster_mod.compacted_gids(sorted_gid, starts, offs, bwd_blocks, drop_id=num_out)
        calls.append(((grad_rows, ids.to(torch.int32), num_out), {}))
    del c5, c6
    _cuda.reset_launch_counts()
    for (rows_, ids, num_out), _ in calls:
        out = accumulate.segment_accumulate(rows_, ids, num_out)
        if not torch.equal(out.cpu(), accumulate.segment_accumulate_plain(rows_.cpu(), ids.cpu(),
                                                                          num_out)):
            raise AssertionError("segment_accumulate differs from its plain version")
    generic_launches = _cuda.launch_counts()["segment_accumulate_generic"]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err=0.0, bytes=0.0, ops=0.0)
    events = dict(kernel=0.0, library=0.0)
    for (rows_, ids, num_out), _ in calls:
        idx = torch.where((ids >= 0) & (ids < num_out), ids, num_out).long()
        index_add = lambda: torch.zeros((num_out + 1, 16), device=dev).index_add_(0, idx, rows_)
        entry_fn = lambda: accumulate.segment_accumulate(rows_, ids, num_out)
        e_k = (cuda_ms(entry_fn, reps=20, warmup=3) + cuda_ms(entry_fn, reps=20, warmup=3)) / 2
        e_l = (cuda_ms(index_add, reps=20, warmup=3) + cuda_ms(index_add, reps=20, warmup=3)) / 2
        t_k, t_l = graph_ms(entry_fn), graph_ms(index_add)
        t_k2, t_l2 = graph_ms(entry_fn), graph_ms(index_add)  # in turns: entry, library, twice
        t_k, t_l = (t_k + t_k2) / 2, (t_l + t_l2) / 2
        t_p = cuda_ms(lambda: accumulate.segment_accumulate_plain(rows_, ids, num_out), reps=5)
        nbytes, ops, shape = accumulate_generic_cost(rows_, ids, num_out)
        log(f"segment_accumulate_generic {shape}: equal; graph slope: kernel={t_k:.4f}ms "
            f"index_add_={t_l:.4f}ms ({t_k / t_l:.2f}x); events (mean of 20, twice): "
            f"kernel={e_k:.4f}ms index_add_={e_l:.4f}ms ({e_k / e_l:.2f}x); plain={t_p:.4f}ms "
            f"bound={bound(nbytes, ops, 'f32')[0]:.4f}ms")
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bytes", nbytes),
                       ("ops", ops)):
            tot[key] += v
        events["kernel"] += e_k
        events["library"] += e_l
    if generic_launches != nv:
        raise AssertionError(f"segment_accumulate launched {generic_launches} times for {nv}")
    # runs past the register path: one id holding ~10 % of a view's rows
    # (the rest random), and every row on one id
    rows_, ids, num_out = calls[0][0]
    rng = np.random.default_rng(13)
    heavy = rng.integers(0, num_out, size=ids.numel())
    heavy[rng.random(ids.numel()) < 0.1] = num_out // 2
    one = np.full(ids.numel(), num_out // 3)
    for what, gid_np in (("one id holding ~10 % of the rows", heavy), ("every row on one id", one)):
        gid = torch.from_numpy(gid_np.astype(np.int32)).to(dev)
        before = accumulate.GENERIC_KERNEL.launches
        out = accumulate.segment_accumulate(rows_, gid, num_out)
        again = accumulate.segment_accumulate(rows_, gid, num_out)
        torch.cuda.synchronize()
        longest = int(torch.bincount(gid).max())
        if accumulate.GENERIC_KERNEL.launches != before + 2 or not torch.equal(out, again) or \
                not torch.equal(out.cpu(), accumulate.segment_accumulate_plain(
                    rows_.cpu(), gid.cpu(), num_out)):
            raise AssertionError(f"segment_accumulate, {what}: differs from its plain version "
                                 f"or between two calls")
        t_e = cuda_ms(lambda: accumulate.segment_accumulate(rows_, gid, num_out), reps=3)
        log(f"segment_accumulate_generic, {what} (longest run {longest}): equal to its plain "
            f"version and across two calls, bit for bit; {t_e:.4f} ms (events, mean of 3)")
    del calls
    entry = kernel_entry("segment_accumulate_generic",
                         "gaussreg_tpu_torch/csrc/segment_accumulate.cu",
                         "gaussreg_tpu/gs/rasterizer/accumulate.py:131", generic_launches, tot,
                         "f32")
    entry["events_ms"] = events
    log(f"segment_accumulate_generic by events: kernel {events['kernel']:.4f} ms, index_add_ "
        f"{events['library']:.4f} ms")
    entries.append(entry)

    # (d) KPConv past 16 kernel points at full width
    b = pipeline_mod.make_pair_batch(cfg, rp, rf, sp, sf, m, device=dev)
    bc = cfg.backbone
    for k in (20, 36):
        model = KPConvFPN(b.features.shape[-1], bc.output_dim, bc.init_dim, k, bc.init_radius,
                          bc.init_sigma, bc.group_norm)
        model.reset_parameters(torch.Generator().manual_seed(k))
        model = model.to(dev)
        with torch.no_grad():
            model(b.features, b.pyramid)  # warm-up
            einsum, k2 = kpconv_mod.EinsumRoute.calls, kpconv_kernel.KERNEL.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats_f, feats_c = model(b.features, b.pyramid)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
        calls_e = kpconv_mod.EinsumRoute.calls - einsum
        k2_launches = kpconv_kernel.KERNEL.launches - k2
        shapes = (tuple(feats_f.shape), tuple(feats_c.shape))
        finite = bool(torch.isfinite(feats_f).all() and torch.isfinite(feats_c).all())
        log(f"KPConvFPN kernel_size {k} at make_cfg() width: forward {dt:.3f} ms; einsum-route "
            f"calls {calls_e}, K2 launches {k2_launches}; outputs {shapes}, finite {finite}")
        if calls_e != 14 or k2_launches != 0 or not finite or shapes != (
                (2, cfg.capacity.levels[1], bc.output_dim), (2, cfg.capacity.levels[4],
                                                             bc.init_dim * 32)):
            raise AssertionError(f"KPConvFPN kernel_size {k}: {calls_e} einsum calls, "
                                 f"{k2_launches} K2 launches, {shapes}, finite {finite}")
        del model, feats_f, feats_c
    del b

    # (e) render_sharded: 2 gloo ranks on this card
    arrays = [np.asarray(getattr(fine_ref, f).cpu().numpy(), np.float32)
              for f in ("means", "scales", "quats", "opacities", "sh_coeffs")]
    cam = cams[0]
    with tempfile.TemporaryDirectory() as tmp:
        rsc.write_scene(os.path.join(tmp, "scene.npz"), *arrays, cam)
        t0 = time.perf_counter()
        rc = rsc.main(["--scene", os.path.join(tmp, "scene.npz"), "--world", "2", "--backend",
                       "gloo", "--output_dir", tmp, "--tile", str(FINE_TILE),
                       "--max_tiles_per_gaussian", str(SHARDED_MAX_TILES)])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError("render_sharded_check failed")
        recs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
    params = [torch.as_tensor(a, device=dev).requires_grad_(True) for a in arrays]
    w2c = cam.w2c.to(dev).clone().requires_grad_(True)
    out = render(*params, cam._replace(w2c=w2c), tile_h=FINE_TILE, tile_w=FINE_TILE,
                 max_tiles_per_gaussian=SHARDED_MAX_TILES)
    if int(out.overflow) or any(int(rec["overflow"]) for rec in recs):
        raise AssertionError(f"render_sharded comparison: pairs dropped by the tile cap "
                             f"({int(out.overflow)} by render, {int(recs[0]['overflow'])} by the "
                             f"slices); raise SHARDED_MAX_TILES")
    loss = (torch.sum(out.rgb * rsc.loss_weights(cam.height, cam.width, dev))
            + 0.3 * torch.sum(out.transmittance))
    loss.backward()
    grads = dict(zip(rsc.PARAMS + ("w2c",), [p.grad for p in params] + [w2c.grad]))
    errs = compare_sharded(recs[0], out, grads)
    for key in ("rgb", "depth", "transmittance", *[f"grad:{n}" for n in grads]):
        if not np.array_equal(recs[0][key], recs[1][key]):
            raise AssertionError(f"render_sharded: the ranks disagree on {key}")
    kinds = ("rasterize_forward", "rasterize_backward", "segment_accumulate")
    for r, rec in enumerate(recs):
        launches = {k: int(rec[f"launches:{k}"]) for k in kinds}
        log(f"render_sharded rank {r} (rows {tuple(int(x) for x in rec['rows'])}): launches "
            f"{launches}, forward {float(rec['fwd_ms']):.3f} ms, backward "
            f"{float(rec['bwd_ms']):.3f} ms, gradient all-reduce "
            f"({int(rec['gradient_floats'])} floats, gloo) {float(rec['allreduce_ms']):.3f} ms; "
            f"pairs {int(rec['num_pairs'])} (render: {int(out.num_pairs)}), overflow "
            f"{int(rec['overflow'])}")
        if not all(v >= 1 for v in launches.values()):
            raise AssertionError(f"render_sharded rank {r} did not launch K4-K6: {launches}")
    log(f"render_sharded: 2 gloo ranks, {arrays[0].shape[0]} gaussians, one {cam.width}x"
        f"{cam.height} view, against render: max errors {errs}; the two processes took "
        f"{dt:.2f} s")
    return entries


# phase 14: the JAX test's hard-tier gate (tests/test_trained_checkpoint.py:
# 72-116) and the JAX transcript it is read beside
HARD_PAIRS, HARD_MIN_OK, HARD_MAX_RRE, HARD_MAX_RMSE = 8, 6, 5.0, 0.1
HARD_TRANSCRIPT = os.path.join(ROOT, "checkpoints", "eval_transcript_hard.json")
PYRAMID_SEARCHES = 13  # K1 launches per pyramid: 5 self, 4 subsampling, 4 upsampling


def first_call():
    """A Capture `record` that keeps the first call's arguments only."""
    seen = []

    def record(args, kwargs):
        seen.append(1)
        return (args, kwargs) if len(seen) == 1 else None

    return record


def diagnostics_phase(cfg, model, dev):
    """14. the hard-tier gate and the diagnostic tools' twins. (a) The JAX
    test's hard-tier gate with the trained checkpoint: random_pair(cfg,
    20_000_000 + i, tier="hard") for i < 8 through make_eval_step, RANSAC
    drawn from a generator seeded seed % 97 (the JAX test's PRNGKey(seed %
    97)); at least 6 pairs with RR = 1, every success with RRE < 5 deg and
    RMSE < 0.1; each pair logged beside the JAX transcript's row. (b)
    `calibrate_neighbors.calibrate` on 2 synthetic samples (4 clouds, K1 at
    limit 128 and a 5-row level-0 window), (c) `probe_overflow.probe_pair`
    on 2 seeds, (d) `diagnose_eval.diagnose` on one pair, (e)
    `diagnose_hard_failures` on its three seeds at window_rows0 2, 3 and 4;
    launch counts zeroed before each and read after: 13 K1 per pyramid,
    and in (d) 14 K2 and one fused K3. The first K1 call of (b) (level 0,
    limit 128) and of (e) at window_rows0 = 4 (limit 35, a 4-row window)
    are held against window_select_runs_plain index for index and timed as
    in phase 4 (`k1_phase`). Returns their two {"kernels"} entries."""
    import numpy as np
    import torch

    from gaussreg_tpu_torch.data import pipeline as pipeline_mod
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.trainer import make_eval_step
    from gaussreg_tpu_torch.ops import _cuda
    from gaussreg_tpu_torch.ops import neighbors as neighbors_mod
    from gaussreg_tpu_torch.tools import (
        calibrate_neighbors,
        diagnose_eval,
        diagnose_hard_failures,
        probe_overflow,
    )

    t_phase = time.perf_counter()
    with open(HARD_TRANSCRIPT) as f:
        transcript = json.load(f)
    jax_rows = {r["seed"]: r for r in transcript["pairs"]}

    # (a) the hard-tier gate
    eval_step = make_eval_step(model, cfg)
    rows = []
    for i in range(HARD_PAIRS):
        seed = 20_000_000 + i
        batch = make_pair_batch(cfg, *random_pair(cfg, seed, tier="hard"), device=dev)
        _, met = eval_step(batch, torch.Generator(device=dev).manual_seed(seed % 97))
        met = {k: float(v) for k, v in met.items()}
        rows.append(met)
        j = jax_rows[seed]
        log(f"hard {seed}: RR={met['RR']:.0f} RRE={met['RRE']:.4f}deg RMSE={met['RMSE']:.5f} "
            f"RTE={met['RTE']:.5f} RSE={met['RSE']:.5f} PIR={met['PIR']:.3f} "
            f"vox_overflow={met['vox_overflow']:.0f}; JAX transcript RR={j['RR']:.0f} "
            f"RRE={j['RRE']:.4f}deg RMSE={j['RMSE']:.5f}")
    ok = [r for r in rows if r["RR"] == 1.0]
    jax_ok = sum(jax_rows[20_000_000 + i]["RR"] == 1.0 for i in range(HARD_PAIRS))
    gate = (len(ok) >= HARD_MIN_OK and all(r["RRE"] < HARD_MAX_RRE for r in ok)
            and all(r["RMSE"] < HARD_MAX_RMSE for r in ok))
    log(f"hard tier: {len(ok)}/{HARD_PAIRS} registered (gate >= {HARD_MIN_OK}, successes RRE < "
        f"{HARD_MAX_RRE} deg and RMSE < {HARD_MAX_RMSE}: max RRE "
        f"{max([r['RRE'] for r in ok], default=float('nan')):.4f}, max RMSE "
        f"{max([r['RMSE'] for r in ok], default=float('nan')):.5f}); JAX transcript "
        f"{jax_ok}/{HARD_PAIRS} on these seeds, recall_RMSE<0.2 "
        f"{transcript['summary']['recall_RMSE<0.2']:.3f} over its "
        f"{transcript['summary']['num_pairs']} pairs")
    if not gate:
        raise AssertionError(f"the hard-tier gate failed: {rows}")

    def counted(what, fn, expect):
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        log(f"{what}: {dt:.3f} s, launches {counts}")
        for name, n in expect.items():
            if counts[name] != n:
                raise AssertionError(f"{what}: {counts[name]} {name} launches, expected {n}")
        return result, counts

    # (b) twin 1: calibrate_neighbors on 2 synthetic samples
    rec_128 = first_call()
    with Capture(neighbors_mod, "window_select_runs", record=rec_128) as cap_128:
        (limits, hists), c_cal = counted(
            "calibrate_neighbors (2 samples, 4 clouds)",
            lambda: calibrate_neighbors.calibrate(
                cfg, calibrate_neighbors.synthetic_clouds(cfg, 2), 0.8, dev),
            {"window_select_idx": 4 * PYRAMID_SEARCHES})
    limit_m = calibrate_neighbors.measure_limits(cfg)[0]
    log(f"calibrate_neighbors: limits {limits} at the measuring limit {limit_m} "
        f"(config {list(cfg.capacity.neighbor_limits)}); level-0 points at the limit: "
        f"{int(hists[0][-1])} of {int(hists[0].sum())}")
    if not (hists.sum(axis=1) > 0).all() or not all(0 < x <= limit_m for x in limits):
        raise AssertionError(f"calibrate_neighbors: limits {limits}, hists {hists.sum(axis=1)}")

    # (c) twin 2: probe_overflow on 2 seeds
    for seed in (12345, 0):
        (overflow, results), _ = counted(
            f"probe_overflow seed {seed}",
            lambda: probe_overflow.probe_pair(cfg, seed, quiet=True, device=dev),
            {"window_select_idx": PYRAMID_SEARCHES})
        worst = min(results, key=lambda r: r[1])
        log(f"probe_overflow seed {seed}: search_overflow={overflow}, {len(results)} lists, "
            f"worst recall {worst[1]:.4f} ({worst[0]}, {worst[2]}/{worst[3]} missing)")
        if len(results) != 18 or not all(0.0 <= r[1] <= 1.0 for r in results):
            raise AssertionError(f"probe_overflow seed {seed}: {results}")

    # (d) twin 3: diagnose_eval on one pair
    batch = make_pair_batch(cfg, *random_pair(cfg, 10_000_000), device=dev)
    res, _ = counted(
        "diagnose_eval seed 10000000",
        lambda: diagnose_eval.diagnose(model, cfg, batch,
                                       torch.Generator(device=dev).manual_seed(3)),
        {"window_select_idx": 0, "kpconv_fused_apply": 14, "kth_largest_rows_cols": 1})
    for line in diagnose_eval.report(res, cfg):
        log(f"diagnose_eval: {line}")
    if not (all(np.isfinite(v) for v in res.values()) and res["proposals"] > 0):
        raise AssertionError(f"diagnose_eval: {res}")

    # (e) twin 4: diagnose_hard_failures, its 3 seeds at window_rows0 2, 3, 4
    rec_wr4 = first_call()

    def hard_failures():
        out = []
        for wr in diagnose_hard_failures.WINDOW_ROWS:
            wcfg = diagnose_hard_failures.with_window_rows0(cfg, wr)
            for seed in diagnose_hard_failures.SEEDS:
                if wr == 4:
                    # built op by op, so that K1's first call is there to capture
                    eager = pipeline_mod.make_pair_batch_eager
                    with Swap(pipeline_mod, "make_pair_batch", eager), \
                            Capture(neighbors_mod, "window_select_runs", record=rec_wr4) as c:
                        met = diagnose_hard_failures.diagnose_seed(model, wcfg, seed, dev)
                    cap_wr4.extend(c.calls)
                else:
                    met = diagnose_hard_failures.diagnose_seed(model, wcfg, seed, dev)
                out.append({"seed": seed, "window_rows0": wr, **met})
        return out

    cap_wr4 = []
    runs = len(diagnose_hard_failures.WINDOW_ROWS) * len(diagnose_hard_failures.SEEDS)
    hard_rows, c_hard = counted("diagnose_hard_failures (3 seeds x window_rows0 2, 3, 4)",
                                hard_failures, {"window_select_idx": runs * PYRAMID_SEARCHES})
    for row in hard_rows:
        log(f"diagnose_hard_failures: {json.dumps(row)}")
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"diagnose_hard_failures: {row}")

    # K1 at limit 128 and at window_rows0 = 4, held and timed as in phase 4
    entries = []
    for name, calls, launches in (
        ("window_select_idx:limit128", cap_128.calls, c_cal["window_select_idx"]),
        ("window_select_idx:window_rows0_4", cap_wr4, c_hard["window_select_idx"]),
    ):
        entries.append(k1_phase(name, [c for c in calls if c is not None], launches))
    log(f"diagnostics phase: {time.perf_counter() - t_phase:.2f} s")
    return entries


def main_path_pairs(cfg, model, pairs, dev):
    """2. each held-out pair through api.coarse_register_clouds, its metrics
    against the known transform; one line per pair."""
    import torch
    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.models.metrics import evaluate_registration

    results = []
    for i, (seed, (rp, rf, sp, sf, m)) in enumerate(pairs):
        t_pair = time.perf_counter()
        out = api.coarse_register_clouds(cfg, model, rp, rf, sp, sf, seed=i, device=dev,
                                         transform=m)
        b = out["batch"]
        met = evaluate_registration(cfg, b.transform, out["estimated_transform"],
                                    b.pyramid.points[0][1], b.pyramid.masks[0][1])
        met = {k: float(v) for k, v in met.items()}
        torch.cuda.synchronize()
        met["seconds"] = time.perf_counter() - t_pair
        met["search_overflow"] = int(b.pyramid.search_overflow)
        results.append(met)
        log(f"pair {seed}: RR={met['RR']:.0f} RRE={met['RRE']:.4f}deg RTE={met['RTE']:.5f} "
            f"RSE={met['RSE']:.5f} RMSE={met['RMSE']:.5f} overflow={met['search_overflow']} "
            f"seconds={met['seconds']:.3f}")
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pairs", type=int, default=8, help="held-out pairs to register")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from gaussreg_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the gaussreg_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2
    if not os.path.exists(CKPT):
        print(f"chip_smoke: no checkpoint at {CKPT}", file=sys.stderr)
        return 2

    import numpy as np
    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.data import pipeline as pipeline_mod
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.gs import fine_registration as fine_mod
    from gaussreg_tpu_torch.gs.fusion import transform_gaussians
    from gaussreg_tpu_torch.gs.ply import load_gaussians, save_gaussians
    from gaussreg_tpu_torch.gs.rasterizer import kernels as raster_mod
    from gaussreg_tpu_torch.models import kpconv as kpconv_mod
    from gaussreg_tpu_torch.models import matching as matching_mod
    from gaussreg_tpu_torch.models.metrics import isotropic_transform_error
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.ops import fused_select, kpconv_kernel, select_k
    from gaussreg_tpu_torch.ops import neighbors as neighbors_mod

    # 1. build (the path's kernels and the probes' of phase 9)
    from gaussreg_tpu_torch.tools import probe_kernels_r5, probe_vmem_gather  # noqa: F401

    build_s = _cuda.build_all()
    log(f"build: nvcc {build_s:.2f} s for {len(_cuda.KERNELS)} kernels (parallel)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    cfg = make_cfg()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = create_model(cfg, dev)
    model.load_state_dict(load_checkpoint(CKPT))
    log(f"checkpoint: loaded in {time.perf_counter() - t0:.2f} s")

    # 2. main path: held-out pairs, launches counted
    pairs = []
    for i in range(args.pairs):
        seed = 20_000_000 + i
        t_data = time.perf_counter()
        pairs.append((seed, random_pair(cfg, seed)))
        log(f"data: pair {seed} generated on the host in {time.perf_counter() - t_data:.2f} s")
    per_pair = {"window_select_idx": 13, "kpconv_fused_apply": 14, "kth_largest_rows_cols": 1,
                **{route: 0 for route in select_k.ROUTES}}
    _cuda.reset_launch_counts()
    results = []
    t_all = time.perf_counter()
    # K1 reads the windows in place: no gather, and no CUDA tensor reaches a
    # plain version
    with Capture(fused_select, "gather_windows") as c_gather, \
            Capture(fused_select, "window_select_plain") as c_plain:
        results = main_path_pairs(cfg, model, pairs, dev)
    if c_gather.calls or c_plain.calls:
        raise AssertionError(f"the main path gathered K1's windows {len(c_gather.calls)} times "
                             f"and ran its plain version {len(c_plain.calls)} times")
    wall = time.perf_counter() - t_all
    counts = _cuda.launch_counts()
    log(f"main path: {len(pairs)} pairs in {wall:.3f} s; launches {counts}; K1 windows "
        f"gathered 0 times")
    for name, n in per_pair.items():
        if counts[name] != n * len(pairs):
            raise AssertionError(f"{name}: {counts[name]} launches, expected {n} per pair")
    if not all(r["RR"] == 1.0 and r["RRE"] < 5.0 for r in results):
        raise AssertionError(f"registration failed on a held-out pair: {results}")
    main_counts = dict(counts)

    # 3. the .ply entry point
    with tempfile.TemporaryDirectory() as tmp:
        (ref_ply, src_ply), gt = write_scene_plys(tmp, cfg, 20_000_100)
        _cuda.reset_launch_counts()
        t_ply = time.perf_counter()
        res = api.register_gs_pair(ref_ply, src_ply, model, cfg, fine=False, device=dev)
        t_ply = time.perf_counter() - t_ply
        counts = _cuda.launch_counts()
    tr = np.asarray(res["transform"])
    if tr.shape != (4, 4) or not np.isfinite(tr).all():
        raise AssertionError(f"register_gs_pair gave {tr}")
    for name, n in per_pair.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {counts[name]} launches on the .ply path, expected {n}")
    ply_err = rot_err(tr, gt)
    log(f"ply: register_gs_pair in {t_ply:.3f} s, launches {counts}, "
        f"inliers={res['ransac_inliers']}, rotation error vs GT {ply_err:.3f} deg")
    if not ply_err < 5.0:
        raise AssertionError(f"register_gs_pair rotation error {ply_err} deg")

    # 4. kernels against their plain versions, on one pair's captured calls
    seed, (rp, rf, sp, sf, m) = pairs[-1]
    # the pyramid built op by op: a graph's replay makes no Python call to capture
    with Swap(api, "make_pair_batch", pipeline_mod.make_pair_batch_eager), \
            Capture(neighbors_mod, "window_select_runs") as c1, \
            Capture(kpconv_mod, "kpconv_fused_apply") as c2, \
            Capture(matching_mod, "kth_largest_rows_cols") as c3:
        api.coarse_register_clouds(cfg, model, rp, rf, sp, sf, seed=0, device=dev)
    torch.cuda.synchronize()
    kernels = [k1_phase("window_select_idx", c1.calls, main_counts["window_select_idx"])]
    rows, tot = measure("kpconv_fused_apply", c2.calls, kpconv_kernel.kpconv_fused_apply,
                        kpconv_kernel.reference_apply, within_bf16_step, kpconv_einsums,
                        kpconv_cost, "bf16")
    for row in rows:
        log(row)
    log(f"kpconv_fused_apply: {len(c2.calls)} calls per pair")
    kernels.append(kernel_entry("kpconv_fused_apply", "gaussreg_tpu_torch/csrc/kpconv_fused.cu",
                                "gaussreg_tpu/ops/kpconv_kernel.py:97",
                                main_counts["kpconv_fused_apply"], tot, "bf16"))
    kernels += k3_phase(c3.calls, main_counts)
    kernels[1]["backward_ms"] = k2_backward_phase(c2.calls, dev)
    profile_pair(cfg, model, pairs[-1][1], dev)

    # 6. fine registration at full width, launches counted
    n_fine, steps = FINE_GAUSSIANS, FINE_STEPS
    t_scene = time.perf_counter()
    ref_g, src_g, gt_fine = make_fine_scene(n_fine, 0, dev)
    cams = fine_mod.default_cameras(ref_g.means.cpu().numpy(), num_views=FINE_VIEWS)
    torch.cuda.synchronize()
    log(f"fine: scene of {n_fine} gaussians made in {time.perf_counter() - t_scene:.2f} s; "
        f"{len(cams)} views of {cams[0].width}x{cams[0].height}")
    start_err = [float(e) for e in isotropic_transform_error(gt_fine, torch.eye(4, device=dev))]
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    with Capture(fine_mod, "render",
                 record=lambda a, kw: kw.get("max_tiles_per_gaussian")) as render_mts:
        t_fine = time.perf_counter()
        fine_out = fine_mod.fine_register(ref_g, src_g, torch.eye(4), cams, num_steps=steps)
        torch.cuda.synchronize()
        t_fine = time.perf_counter() - t_fine
    fine_counts = _cuda.launch_counts()
    log(f"fine: torch.cuda.max_memory_allocated() after the fine call "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    losses = fine_out.losses.cpu().numpy()
    end_err = [float(e) for e in isotropic_transform_error(gt_fine, fine_out.transform)]
    chosen_mt = render_mts.calls[-1]
    log(f"fine: fine_register {steps} steps x {len(cams)} views in {t_fine:.3f} s "
        f"({t_fine / steps * 1e3:.1f} ms per step, probes included); loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; RRE {start_err[0]:.4f} -> {end_err[0]:.4f} deg, RTE "
        f"{start_err[1]:.5f} -> {end_err[1]:.5f}, RSE {start_err[2]:.5f} -> {end_err[2]:.5f}; "
        f"overflow={int(fine_out.overflow)}, max_tiles_per_gaussian={chosen_mt}; "
        f"launches {fine_counts}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fine_register losses {losses[0]} -> {losses[-1]}")
    if not all(e < s0 for e, s0 in zip(end_err, start_err)):
        raise AssertionError(f"fine_register did not improve: {start_err} -> {end_err}")
    per_step = steps * len(cams)
    if not (fine_counts["rasterize_backward"] == per_step
            and fine_counts["segment_accumulate"] == per_step
            and fine_counts["rasterize_forward"] >= per_step + len(cams)):
        raise AssertionError(f"fine_register launches {fine_counts}, expected {per_step} "
                             "backward and accumulate launches and more forward ones")

    # 7. the fine entry point on .ply files, then fusion
    def fine_entry_point(what, ref_ply, src_ply, gt):
        _cuda.reset_launch_counts()
        t_ply = time.perf_counter()
        res = api.register_gs_pair(ref_ply, src_ply, model, cfg, fine=True, fine_steps=20,
                                   device=dev)
        t_ply = time.perf_counter() - t_ply
        counts = _cuda.launch_counts()
        tr = np.asarray(res["transform"])
        if tr.shape != (4, 4) or not np.isfinite(tr).all():
            raise AssertionError(f"register_gs_pair(fine=True) gave {tr}")
        errs = rot_err(res["coarse_transform"], gt), rot_err(tr, gt)
        log(f"ply fine ({what}): register_gs_pair(fine=True, 20 steps) in {t_ply:.3f} s, "
            f"launches {counts}, rotation error vs GT {errs[0]:.3f} (coarse) -> {errs[1]:.3f} deg, "
            f"loss {res['fine_losses'][0]:.6f} -> {res['fine_losses'][-1]:.6f}")
        if not all(counts[k] > 0 for k in ("rasterize_forward", "rasterize_backward",
                                           "segment_accumulate")):
            raise AssertionError(f"the fine entry point did not launch K4-K6: {counts}")
        return tr, errs

    with tempfile.TemporaryDirectory() as tmp:
        (ref_ply, src_ply), gt = write_scene_plys(tmp, cfg, 20_000_100)
        # two samplings of one scene that overlap in part: the photometric
        # optimum need not be the known transform, so only the 5-degree gate
        tr, errs = fine_entry_point("two samplings", ref_ply, src_ply, gt)
        if not errs[1] < 5.0:
            raise AssertionError(f"register_gs_pair(fine=True) rotation error {errs[1]} deg")
        # the reference model itself under the inverse transform: here the
        # refinement has an exact optimum and must not leave it
        copy_ply = os.path.join(tmp, "copy.ply")
        save_gaussians(copy_ply, transform_gaussians(load_gaussians(ref_ply),
                                                     np.linalg.inv(gt), device=dev))
        _, errs = fine_entry_point("exact copy", ref_ply, copy_ply, gt)
        if not errs[1] < max(errs[0], 0.1):
            raise AssertionError(f"fine registration of an exact copy: {errs[0]} -> {errs[1]} deg")

        npz, fused_ply = os.path.join(tmp, "t.npz"), os.path.join(tmp, "fused.ply")
        np.savez(npz, estimated_transform=tr)
        api.gaussian_fuse(ref_ply, src_ply, npz, fused_ply, device=dev)
        fused = load_gaussians(fused_ply)
        n_in = min(load_gaussians(ref_ply).num_gaussians, load_gaussians(src_ply).num_gaussians)
    log(f"fuse: gaussian_fuse wrote {fused.num_gaussians} gaussians from 2 x ~{n_in}")
    fields = (fused.xyz, fused.f_dc, fused.f_rest, fused.opacity, fused.scales, fused.rots)
    if not (all(np.isfinite(f).all() for f in fields) and n_in <= fused.num_gaussians <= 2 * n_in):
        raise AssertionError(f"gaussian_fuse wrote {fused.num_gaussians} gaussians from 2 x {n_in}")

    # 8. K4-K6 against their plain versions on one full-width step's calls
    with Capture(raster_mod, "rasterize_forward") as c4, \
            Capture(raster_mod, "rasterize_backward") as c5, \
            Capture(raster_mod, "accumulate_pairs") as c6, \
            Capture(raster_mod, "slot_positions") as c_tab:
        fine_mod.fine_register(ref_g, src_g, torch.eye(4), cams, num_steps=1)
    torch.cuda.synchronize()
    nv = len(cams)  # the step's renders are the last calls; the probes come before
    if len(c_tab.calls) != nv:
        raise AssertionError(f"{len(c_tab.calls)} pair tables built for one step of {nv} "
                             "views: one per backward, none for the probes and targets")
    report_imbalance(c4.calls[-nv:])
    ntiles = c4.calls[-1][0][2].shape[0] - 1  # starts has num_tiles + 1 entries
    launch_shape = {
        "rasterize_forward": (f"{ntiles} tiles x a cluster of "
                              f"{raster_mod.forward_cluster_size(FINE_TILE * FINE_TILE)} blocks"),
        "rasterize_backward": "one block per compacted chunk, "
                              + ", ".join(f"{a[5]} blocks ({int(a[3][-1])} live)"
                                          for a, _ in c5.calls[-nv:]),
    }
    for name, calls, kernel, plain, compare, library, cost, src, replaces in (
        ("rasterize_forward", c4.calls[-nv:], raster_mod.rasterize_forward,
         raster_mod.rasterize_forward_plain, compare_forward, None, forward_cost,
         "gaussreg_tpu_torch/csrc/rasterize_fwd.cu", "gaussreg_tpu/gs/rasterizer/kernels.py:395"),
        ("rasterize_backward", c5.calls[-nv:], raster_mod.rasterize_backward,
         raster_mod.rasterize_backward_plain, compare_backward, None, backward_cost,
         "gaussreg_tpu_torch/csrc/rasterize_bwd.cu", "gaussreg_tpu/gs/rasterizer/kernels.py:442"),
        ("segment_accumulate", None, None, None, None, None, None,
         "gaussreg_tpu_torch/csrc/segment_accumulate.cu",
         "gaussreg_tpu/gs/rasterizer/accumulate.py:131"),
    ):
        with torch.no_grad():  # the captured gdata is a leaf of the step's graph
            if name == "segment_accumulate":
                rows, tot = measure_accumulate(c5.calls[-nv:], c6.calls[-nv:], c_tab.calls)
            else:
                rows, tot = measure(name, calls, kernel, plain, compare, library, cost, "f32",
                                    plain_reps=2)
        for row in rows:
            log(row)
        b_ms, b_by = bound(tot["bytes"], tot["ops"], "f32")
        lib_txt = "none" if tot["library_ms"] is None else f"{tot['library_ms']:.3f} ms"
        cp_txt = ""
        if name in launch_shape:
            cp_ms = critical_path_ms(calls, K4_OPS_PER_PAIR_PIXEL if name == "rasterize_forward"
                                     else K5_OPS_PER_PAIR_PIXEL)
            cp_txt = f", critical-path bound {cp_ms:.3f} ms; launched as {launch_shape[name]}"
        log(f"{name}: {nv} calls per step, kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, library {lib_txt}, bound {b_ms:.3f} ms ({b_by}){cp_txt}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": fine_counts[name], "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tot["library_ms"],
        })
        if name == "segment_accumulate":
            # `ms` is what the path pays: the table build plus the launch
            kernels[-1]["launch_ms"] = tot["launch_ms"]
            kernels[-1]["table_ms"] = tot["table_ms"]
            log(f"{name}: per step the table {tot['table_ms']:.3f} ms + the accumulation "
                f"{tot['launch_ms']:.3f} ms; index_add_ {tot['library_ms']:.3f} ms")
    profile_backward(src_g, cams)
    profile_fine_steps(ref_g, src_g, cams)

    # 9. the probes' twins; 10. the CLIs
    probe_phase(dev, kernels)
    cli_phase(dev, per_pair)

    # 11. training at full width
    train = train_phase(dev)
    kernels[1]["train_forward_ms_per_step"] = train["fwd_ms"]
    kernels[1]["train_backward_ms_per_step"] = train["bwd_ms"]

    # 12. train and evaluate through the CLIs
    cli_train_eval_phase(dev, per_pair)

    # 13. the library surface beyond the main path
    kernels += library_phase(cfg, dev, pairs[-1][1], ref_g, cams[:1])

    # 14. the hard-tier gate and the diagnostic tools' twins
    kernels += diagnostics_phase(cfg, model, dev)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
