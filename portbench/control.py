"""The control of a cell's comparison: the plain reference computed in the
nearest precision below the configuration's (TF32 for float32 with TF32 off)
and put in the program's place, judged by the same numbers as the program.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--faults <name> ...]

Prints one line per seed, `control <cell> seed <n> {name: value, ...}`, and
a last JSON line with every seed's numbers. With --faults, the program
itself runs the seed's compared calls once for each named fault of
portbench/faults.py planted in it (`fault <cell> seed <n> <fault> {...}`).
Not part of a benchmark run; its readings set the upper ends of the limits
(PERF.md)."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None)
    args = ap.parse_args(argv)
    from portbench import run, spec

    run._environment(spec.PKG)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    out = {}
    for seed in args.seeds:
        runner = cell.runner().Runner(cell, seed, "cuda")
        if args.faults is not None:
            runner.setup()
            out[seed] = runner.faults(args.faults)
            for name, nums in out[seed].items():
                print(f"fault {args.workload} seed {seed} {name} {json.dumps(nums)}", flush=True)
            continue
        nums = runner.control()
        out[seed] = nums
        print(f"control {args.workload} seed {seed} {json.dumps(nums)}", flush=True)
    print(json.dumps({"workload": args.workload,
                      "faults" if args.faults is not None else "control": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
