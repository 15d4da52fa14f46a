#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (gaussreg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, needs one CUDA card

Phases, each of which fails the run (non-zero exit, no result line):

1. build: nvcc compiles every csrc/*.cu kernel (one process per source, in
   parallel) into gaussreg_tpu_torch/_build/.
2. main path: the trained checkpoint (checkpoints/synthetic_coarse.msgpack)
   at make_cfg() width registers the 8 held-out synthetic pairs
   random_pair(cfg, 20_000_000 + i) through api.coarse_register_clouds;
   every pair must have RR = 1 (RMSE < 0.2) and RRE < 5 degrees. Kernel
   launch counts are zeroed just before and read just after: 13 window
   selections (K1), 14 KPConv aggregations (K2) and 2 k-min selections
   (K3) per pair.
3. .ply entry point: api.register_gs_pair(fine=False) on two .ply files of
   one synthetic scene written by the port's gs/ply.py writer (counts
   zeroed and read around it too); the transform must be finite and its
   rotation within 5 degrees of the known one.
4. kernels: every K1/K2/K3 call of one pair's forward is replayed on its
   captured inputs; the kernel is held against its plain PyTorch version
   (K1 and K3 index-for-index and value-for-value; K2 within 4e-3 of the
   plain output's max, the size of one bf16 rounding step of a weighted
   sum) and timed (CUDA events, mean of 5 after a warm-up, inputs left in
   L2 as the forward leaves them) beside the plain version, one PyTorch
   library call for the same function, and the least time the card could
   take (bytes at 3.35 TB/s or operations at the inputs' peak rate).
5. profile: one pair under torch.profiler, device time by kernel and the
   device's busy share of the wall time.

Prints the build seconds, the card's name and power limit, a line per
pair, a line per kernel call, the profile, a {"kernels": [...]} JSON line,
and as the last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Capture:
    """Record the arguments of a function looked up as a module attribute
    (the caller's import), for one forward pass."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def measure(name, calls, kernel, plain, compare, library, cost, kind):
    """Replay each captured call: hold the kernel against its plain version
    (`compare` raises on a mismatch and returns the max abs error), time
    kernel, plain version and library call, and bound the call's work.
    Returns the per-call lines and the per-pair totals."""
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err=0.0, bytes=0.0, ops=0.0)
    for args, kw in calls:
        err = compare(kernel(*args, **kw), plain(*args, **kw))
        lib = library(*args, **kw)
        t_k = cuda_ms(lambda: kernel(*args, **kw))
        t_p = cuda_ms(lambda: plain(*args, **kw))
        t_l = cuda_ms(lib)
        nbytes, ops, shape = cost(*args, **kw)
        b_ms, _ = bound(nbytes, ops, kind)
        rows.append(f"{name} {shape}: err={err:.3e} kernel={t_k:.4f}ms plain={t_p:.4f}ms "
                    f"library={t_l:.4f}ms bound={b_ms:.4f}ms")
        tot["err"] = max(tot["err"], err)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bytes", nbytes), ("ops", ops)):
            tot[key] += v
    return rows, tot


def exact(a, b):
    """K1/K3: values and indices must be equal."""
    import torch

    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError(f"kernel differs from its plain version in "
                             f"{(a[1] != b[1]).sum().item()} indices")
    return 0.0


def within_bf16_step(a, b):
    """K2: within 4e-3 of the plain output's max (one bf16 rounding step)."""
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    if not err <= 4e-3 * scale:
        raise AssertionError(f"kpconv_fused_apply err {err} > 4e-3 * {scale}")
    return err


def window_select_topk(q, lsle, wx, wy, wz, widx, limit, nruns, wspan):
    import torch
    from gaussreg_tpu_torch.ops import fused_select as fs

    masked = torch.where(fs.window_valid(lsle, nruns, wspan), fs.window_d2(q, wx, wy, wz),
                         torch.finfo(torch.float32).max)
    return lambda: torch.topk(masked, limit, dim=1, largest=False)


def window_select_cost(q, lsle, wx, wy, wz, widx, limit, nruns, wspan):
    p, w = wx.shape
    nbytes = p * (q.shape[1] * 4 + 2 * nruns * 4 + 4 * w * 4 + limit * 8)
    return nbytes, 8.0 * p * w, f"P={p} W={w} limit={limit}"


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
    r, w = x.shape
    return r * w * 4 + r * k * 8, float(r * w * k), f"R={r} W={w} k={k}"


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

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    log(f"profile: one pair, wall {wall_ms:.1f} ms (profiled), device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device kernels")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


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
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.models import kpconv as kpconv_mod
    from gaussreg_tpu_torch.models import matching as matching_mod
    from gaussreg_tpu_torch.models.metrics import evaluate_registration
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.ops import fused_select, kpconv_kernel, select_k
    from gaussreg_tpu_torch.ops import neighbors as neighbors_mod

    # 1. build
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
    per_pair = {"window_select_idx": 13, "kpconv_fused_apply": 14, "select_min_k": 2}
    _cuda.reset_launch_counts()
    results = []
    t_all = time.perf_counter()
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
    wall = time.perf_counter() - t_all
    counts = _cuda.launch_counts()
    log(f"main path: {len(pairs)} pairs in {wall:.3f} s; launches {counts}")
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
    r_est = tr[:3, :3] / np.linalg.norm(tr[0, :3])
    r_gt = gt[:3, :3] / np.linalg.norm(gt[0, :3])
    rot_err = math.degrees(math.acos(np.clip((np.trace(r_est.T @ r_gt) - 1) / 2, -1, 1)))
    log(f"ply: register_gs_pair in {t_ply:.3f} s, launches {counts}, "
        f"inliers={res['ransac_inliers']}, rotation error vs GT {rot_err:.3f} deg")
    if not rot_err < 5.0:
        raise AssertionError(f"register_gs_pair rotation error {rot_err} deg")

    # 4. kernels against their plain versions, on one pair's captured calls
    seed, (rp, rf, sp, sf, m) = pairs[-1]
    with Capture(neighbors_mod, "window_select_idx") as c1, \
            Capture(kpconv_mod, "kpconv_fused_apply") as c2, \
            Capture(matching_mod, "select_min_k") as c3:
        api.coarse_register_clouds(cfg, model, rp, rf, sp, sf, seed=0, device=dev)
    torch.cuda.synchronize()
    kernels = []
    for name, calls, kernel, plain, compare, library, cost, kind, src, replaces in (
        ("window_select_idx", c1.calls, fused_select.window_select_idx,
         fused_select.window_select_plain, exact, window_select_topk, window_select_cost, "f32",
         "gaussreg_tpu_torch/csrc/window_select.cu", "gaussreg_tpu/ops/fused_select.py:145"),
        ("kpconv_fused_apply", c2.calls, kpconv_kernel.kpconv_fused_apply,
         kpconv_kernel.reference_apply, within_bf16_step, kpconv_einsums, kpconv_cost, "bf16",
         "gaussreg_tpu_torch/csrc/kpconv_fused.cu", "gaussreg_tpu/ops/kpconv_kernel.py:97"),
        ("select_min_k", c3.calls, select_k.select_min_k, select_k.select_min_k_plain, exact,
         select_topk, select_cost, "f32",
         "gaussreg_tpu_torch/csrc/select_k.cu", "gaussreg_tpu/ops/select_k.py:88"),
    ):
        rows, tot = measure(name, calls, kernel, plain, compare, library, cost, kind)
        for row in rows:
            log(row)
        b_ms, b_by = bound(tot["bytes"], tot["ops"], kind)
        log(f"{name}: {len(calls)} calls per pair, kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by})")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_counts[name], "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tot["library_ms"],
        })
    profile_pair(cfg, model, pairs[-1][1], dev)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
