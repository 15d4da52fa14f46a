"""Time the fused KPConv kernel (csrc/kpconv_fused.cu) and variants of it
at the 14 backbone shapes of one make_cfg() pair, on one CUDA card.

    python -m gaussreg_tpu_torch.tools.kpconv_variants [--reps 20] [--rounds 3]

Each variant is the same source built with other values of its KPCONV_*
switches (one nvcc process per variant, all started together):

- shipped: the kernel as the port builds it;
- no_halve: the D tile never halved for more blocks (shipped: halved once
  where the grid of one block per SM then still fits in one wave);
- s1x0: stage 1's tensor-core products dropped (its copies stay);
- s2x0 / s2x2: stage 2 dropped, or its products done twice.

shipped and no_halve compute the kernel's function and are held
within 4e-3 of the plain output's max (one bf16 step); s1x0, s2x0 and s2x2
do not, and only their times mean anything: how much of a call each stage
takes. Inputs are random (from --seed) at each shape; a call's time is the
mean of --reps launches (CUDA events) after warm-ups, the variants taken in
turns for --rounds rounds, and the median round is kept. Also timed: the
torch.einsum pair the kernel replaces. The bound is the larger of the bytes
(inputs once, output once) at 3.35 TB/s and the bf16 products at 989
TFLOP/s, as in chip_smoke.py.

Prints a line per shape, totals per variant, the card's name and power
limit, and all of it as one JSON object on the last line.
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

from gaussreg_tpu_torch.ops import _cuda
from gaussreg_tpu_torch.ops.kpconv_kernel import reference_apply

# (R, H, C, D) of the 14 calls of one pair (both clouds' rows), as
# chip_smoke.py prints them; K = 15 kernel points
SHAPES = [
    (61440, 35, 4, 64), (61440, 35, 32, 32), (32768, 35, 32, 32), (32768, 28, 64, 64),
    (32768, 28, 64, 64), (12800, 28, 64, 64), (12800, 30, 128, 128), (12800, 30, 128, 128),
    (3584, 30, 128, 128), (3584, 31, 256, 256), (3584, 31, 256, 256), (1024, 31, 256, 256),
    (1024, 29, 512, 512), (1024, 29, 512, 512),
]
K = 15
VARIANTS = {
    "shipped": [],
    "no_halve": ["-DKPCONV_HALVE_NT=0"],
    "s1x0": ["-DKPCONV_STAGE1_REPS=0"],
    "s2x0": ["-DKPCONV_STAGE2_REPS=0"],
    "s2x2": ["-DKPCONV_STAGE2_REPS=2"],
}
EXACT = ("shipped", "no_halve")  # variants that compute the function


def build(out_dir: str):
    """nvcc every variant in parallel; returns name -> C entry point."""
    src = os.path.join(_cuda.CSRC, "kpconv_fused.cu")
    jobs = {}
    for name, flags in VARIANTS.items():
        path = os.path.join(out_dir, f"kpconv_{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", path, src]
        jobs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    fns = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
        fn = ctypes.CDLL(path).gaussreg_kpconv_fused
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kpconv_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(tmp)
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        rows, totals = [], {n: 0.0 for n in [*VARIANTS, "einsum", "bound"]}
        for r, h, c, d in SHAPES:
            nf = torch.randn(r, h, c, device=dev, generator=gen).to(torch.bfloat16)
            infl = torch.rand(r, h, K, device=dev, generator=gen).to(torch.bfloat16)
            w = torch.randn(K, c, d, device=dev, generator=gen).to(torch.bfloat16)
            out = torch.empty(r, d, device=dev)
            ptrs = (nf.data_ptr(), infl.data_ptr(), w.data_ptr(), out.data_ptr())

            def call(fn):
                rc = fn(*ptrs, r, h, K, c, d, stream)
                if rc:
                    raise RuntimeError(f"launch failed with error {rc} at {(r, h, c, d)}")

            ref = reference_apply(nf, infl, w.float())
            for name in EXACT:
                call(fns[name])
                err = (out - ref).abs().max().item()
                if not err <= 4e-3 * ref.abs().max().item():
                    raise AssertionError(f"{name} at {(r, h, c, d)}: err {err}")
            einsum = lambda: torch.einsum("mkc,kcd->md", torch.einsum("mhk,mhc->mkc", infl, nf), w)
            runs = {n: [] for n in [*VARIANTS, "einsum"]}
            for _ in range(args.rounds):
                for name, fn in fns.items():
                    runs[name].append(event_ms(lambda: call(fn), args.reps))
                runs["einsum"].append(event_ms(einsum, args.reps))
            ms = {n: statistics.median(v) for n, v in runs.items()}
            nbytes = r * h * c * 2 + r * h * K * 2 + K * c * d * 2 + r * d * 4
            flops = 2.0 * r * h * K * c + 2.0 * r * K * c * d
            ms["bound"] = max(nbytes / 3.35e12, flops / 989e12) * 1e3
            for n, v in ms.items():
                totals[n] += v
            rows.append({"R": r, "H": h, "C": c, "D": d, **ms})
            print(f"R={r} H={h} C={c} D={d}: " + " ".join(f"{n}={v:.4f}" for n, v in ms.items()),
                  flush=True)
    print("totals (ms per pair): " + " ".join(f"{n}={v:.4f}" for n, v in totals.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    result = {"card": smi, "reps": args.reps, "rounds": args.rounds, "shapes": rows,
              "totals": totals}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
