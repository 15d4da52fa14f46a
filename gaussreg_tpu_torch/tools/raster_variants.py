"""Time the rasterizer kernels K4 (csrc/rasterize_fwd.cu) and K5
(csrc/rasterize_bwd.cu) and variants of them on the calls of one
full-width fine-registration step, on one CUDA card. Run from the
repository root (it takes the scene from chip_smoke.py):

    python -m gaussreg_tpu_torch.tools.raster_variants [--reps 20] [--rounds 3] [--fine]

The step is chip_smoke.py's: 200 000 gaussians, 4 views of 640x480, 32x32
tiles; its four differentiated forward and four backward calls are
captured and replayed. Each variant is the kernel's source built with
other values of its RASTER_* switches or with one expression replaced
(one nvcc process per build, all started together), or the shipped build
launched with another cluster:

- K4 `shipped` (a cluster of 8 blocks of 128 pixels per tile, the
  exponents of eight pairs taken together, cp.async prefetch of the next
  chunk), `cluster1`, `cluster2`, `cluster4` (1, 2 or 4 blocks per tile),
  `ilp1`, `ilp4`, `ilp16` (the exponents of 1, 4 or 16 pairs at a time);
- K5 `shipped` (one block per compacted chunk, the pixel sums by
  recursive halving, registers capped for three resident blocks per SM,
  d_alpha's quotient by the approximate `__fdividef`), `ieee_div` (that
  quotient by IEEE division), `min_blocks2`, `min_blocks4` (registers
  capped for two or four).

Every K4 variant computes the same bits as `shipped` (planes, kend and the
chunk-start state of the walked chunks: checked); K5's variants are held
within 1e-5 of each channel's max of `shipped`, and whether they equal it
bit for bit is printed. A call's time is the mean of --reps launches (CUDA
events) after warm-ups, the variants taken in turns for --rounds rounds;
the median round is kept and summed over the four views.

With --fine it also runs chip_smoke.py's fine call (fine_register, 100
steps) with K5 as `shipped` (twice), as `ieee_div`, and as `shipped` with
the last bit of every nonzero gradient-row entry flipped at random (two
seeds): how far the result moves under differences of rounding size.

Prints a line per variant and fine call, the card's name and power limit,
and all of it as one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from gaussreg_tpu_torch.gs.rasterizer import kernels
from gaussreg_tpu_torch.ops import _cuda

FWD = {  # name -> (nvcc switches, cluster)
    "shipped": ([], 8),
    "cluster1": ([], 1),
    "cluster2": ([], 2),
    "cluster4": ([], 4),
    "ilp1": (["-DRASTER_FWD_ILP=1"], 8),
    "ilp4": (["-DRASTER_FWD_ILP=4"], 8),
    "ilp16": (["-DRASTER_FWD_ILP=16"], 8),
}
EXACT_DIV = ("__fdividef(c[i] - u, one_m)", "(c[i] - u) / one_m")
BWD = {  # name -> (nvcc switches, source edits (old, new))
    "shipped": ([], []),
    "ieee_div": ([], [EXACT_DIV]),
    "min_blocks2": (["-DRASTER_BWD_MIN_BLOCKS=2"], []),
    "min_blocks4": (["-DRASTER_BWD_MIN_BLOCKS=4"], []),
}


def _source(out_dir: str, src: str, edits) -> str:
    """The kernel's source, or a copy of it with `edits` applied."""
    path = os.path.join(_cuda.CSRC, src)
    if not edits:
        return path
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: expected one {old!r}")
        text = text.replace(old, new)
    path = os.path.join(out_dir, f"edited_{len(os.listdir(out_dir))}_{src}")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(out_dir: str):
    """nvcc every distinct build in parallel; returns (fwd, bwd) name -> C
    entry point."""
    jobs = {}
    for kind, src, table in (
            ("fwd", "rasterize_fwd.cu", {n: (f, []) for n, (f, _) in FWD.items()}),
            ("bwd", "rasterize_bwd.cu", BWD)):
        for name, (flags, edits) in table.items():
            key = (kind, " ".join(flags), repr(edits))
            if key in jobs:
                continue
            path = os.path.join(out_dir, f"{kind}_{len(jobs)}.so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", _cuda.CSRC, "-o", path,
                   _source(out_dir, src, edits)]
            jobs[key] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT))
    libs = {}
    for key, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log.decode(errors='replace')}")
        libs[key] = ctypes.CDLL(path)
    fwd, bwd = {}, {}
    for name, (flags, _) in FWD.items():
        fn = libs[("fwd", " ".join(flags), repr([]))].gaussreg_rasterize_fwd
        fn.restype, fn.argtypes = ctypes.c_int, kernels.FWD_KERNEL.argtypes + [ctypes.c_void_p]
        fwd[name] = fn
    for name, (flags, edits) in BWD.items():
        fn = libs[("bwd", " ".join(flags), repr(edits))].gaussreg_rasterize_bwd
        fn.restype, fn.argtypes = ctypes.c_int, kernels.BWD_KERNEL.argtypes + [ctypes.c_void_p]
        bwd[name] = fn
    return fwd, bwd


def launch_fwd(fn, cluster, args):
    gdata, sorted_gid, starts, height, width, tile_h, tile_w = args
    nty, ntx = height // tile_h, width // tile_w
    dev = gdata.device
    planes = torch.empty((5, height, width), device=dev)
    kend = torch.empty((nty * ntx,), dtype=torch.int32, device=dev)
    state = torch.empty((kernels.state_slots(sorted_gid.shape[0] // kernels.CHUNK, nty * ntx),
                         5, tile_h * tile_w), device=dev)
    rc = fn(gdata.data_ptr(), sorted_gid.data_ptr(), starts.data_ptr(), planes.data_ptr(),
            kend.data_ptr(), state.data_ptr(), sorted_gid.shape[0], ntx, nty, tile_w, tile_h,
            cluster, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rasterize_fwd variant: launch failed with error {rc}")
    return planes, kend, state


def launch_bwd(fn, args):
    gdata, sorted_gid, starts, offs, ct, bwd_blocks, height, width, tile_h, tile_w, state = args
    grad = torch.zeros((bwd_blocks * kernels.CHUNK, kernels.NCHAN), device=gdata.device)
    rc = fn(gdata.data_ptr(), sorted_gid.data_ptr(), starts.data_ptr(), offs.data_ptr(),
            ct.data_ptr(), state.data_ptr(), grad.data_ptr(), bwd_blocks, sorted_gid.shape[0],
            width // tile_w, height // tile_h, tile_w, tile_h,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rasterize_bwd variant: launch failed with error {rc}")
    return grad


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_step():
    """The four differentiated forward calls and four backward calls of one
    fine step at chip_smoke.py's width."""
    import chip_smoke
    from gaussreg_tpu_torch.gs import fine_registration as fine_mod

    ref, src, _ = chip_smoke.make_fine_scene(chip_smoke.FINE_GAUSSIANS, 0, "cuda")
    cams = fine_mod.default_cameras(ref.means.cpu().numpy(), num_views=chip_smoke.FINE_VIEWS)
    with chip_smoke.Capture(kernels, "rasterize_forward") as c4, \
            chip_smoke.Capture(kernels, "rasterize_backward") as c5:
        fine_mod.fine_register(ref, src, torch.eye(4), cams, num_steps=1)
    torch.cuda.synchronize()
    fwd = [a for a, kw in c4.calls if kw.get("save_state")]
    bwd = [tuple(a) for a, _ in c5.calls]
    return fwd, bwd


def ulp_noise(seed: int):
    """kernels.rasterize_backward with the last bit of every nonzero entry
    of its rows flipped at random (a seeded generator on the card)."""
    inner = kernels.rasterize_backward
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def perturbed(*args, **kwargs):
        rows = inner(*args, **kwargs)
        flip = torch.randint(0, 2, rows.shape, generator=gen, device=rows.device,
                             dtype=torch.int32) * (rows != 0)
        return (rows.view(torch.int32) ^ flip).view(torch.float32)

    return perturbed


def fine_calls(bwd_fns) -> dict:
    """chip_smoke.py's fine call with K5 swapped or its rows perturbed:
    name -> final loss and RRE, RTE, RSE (start values under `start`)."""
    import chip_smoke
    from gaussreg_tpu_torch.gs import fine_registration as fine_mod
    from gaussreg_tpu_torch.models.metrics import isotropic_transform_error

    ref, src, gt = chip_smoke.make_fine_scene(chip_smoke.FINE_GAUSSIANS, 0, "cuda")
    cams = fine_mod.default_cameras(ref.means.cpu().numpy(), num_views=chip_smoke.FINE_VIEWS)
    eye = torch.eye(4, device="cuda")
    out = {"start": [float(e) for e in isotropic_transform_error(gt, eye)]}
    runs = [("shipped", "shipped", None), ("shipped_again", "shipped", None),
            ("ieee_div", "ieee_div", None), ("ulp_noise0", "shipped", 0),
            ("ulp_noise1", "shipped", 1)]
    loaded, backward = kernels.BWD_KERNEL._load(), kernels.rasterize_backward
    try:
        for name, build_name, seed in runs:
            kernels.BWD_KERNEL._fn = bwd_fns[build_name]
            kernels.rasterize_backward = backward if seed is None else ulp_noise(seed)
            res = fine_mod.fine_register(ref, src, torch.eye(4), cams,
                                         num_steps=chip_smoke.FINE_STEPS)
            errs = [float(e) for e in isotropic_transform_error(gt, res.transform)]
            out[name] = [float(res.losses[-1])] + errs
            print(f"fine call, K5 {name}: loss {out[name][0]:.6f}; RRE {errs[0]:.4f} deg, "
                  f"RTE {errs[1]:.5f}, RSE {errs[2]:.5f}; overflow {int(res.overflow)}")
    finally:
        kernels.BWD_KERNEL._fn, kernels.rasterize_backward = loaded, backward
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--fine", action="store_true",
                        help="also run the fine call with K5's variants and perturbations")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("raster_variants: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        fwd_fns, bwd_fns = build(tmp)
        fwd_calls, bwd_calls = capture_step()
        with torch.no_grad():
            # every K4 variant gives the shipped bits
            for call in fwd_calls:
                ref = launch_fwd(fwd_fns["shipped"], 8, call)
                slots = kernels.written_state_slots(call[2], ref[1], call[1].shape[0])
                for name, (_, cluster) in FWD.items():
                    out = launch_fwd(fwd_fns[name], cluster, call)
                    if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
                            and torch.equal(out[2][slots], ref[2][slots])):
                        raise AssertionError(f"K4 variant {name} differs from shipped")
            bwd_equal = {name: True for name in BWD}
            for call in bwd_calls:
                ref = launch_bwd(bwd_fns["shipped"], call)
                scale = ref.abs().amax(dim=0).clamp_min(1e-30)
                for name in BWD:
                    out = launch_bwd(bwd_fns[name], call)
                    rel = ((out - ref).abs() / scale).max().item()
                    if rel > 1e-5:
                        raise AssertionError(f"K5 variant {name} differs from shipped by {rel}")
                    bwd_equal[name] &= torch.equal(out, ref)
            print(f"K5 variants equal to shipped bit for bit: {bwd_equal}")
            times = {f"fwd_{n}": [] for n in FWD} | {f"bwd_{n}": [] for n in BWD}
            for _ in range(args.rounds):
                for name, (_, cluster) in FWD.items():
                    times[f"fwd_{name}"].append(sum(
                        event_ms(lambda: launch_fwd(fwd_fns[name], cluster, c), args.reps)
                        for c in fwd_calls))
                for name in BWD:
                    times[f"bwd_{name}"].append(sum(
                        event_ms(lambda: launch_bwd(bwd_fns[name], c), args.reps)
                        for c in bwd_calls))
        result = {k: statistics.median(v) for k, v in times.items()}
        for k, v in result.items():
            print(f"{k}: {v:.4f} ms per step ({len(fwd_calls)} views; rounds "
                  f"{', '.join(f'{x:.4f}' for x in times[k])})")
        fine = fine_calls(bwd_fns) if args.fine else None
    print(smi)
    print(json.dumps({"ms_per_step": result, "views": len(fwd_calls), "card": smi,
                      "bwd_equal": bwd_equal, "fine": fine}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
