"""Fuse two 3DGS models given an estimated transform with the port (port of
tools/fuse.py; reference gs_fusion.py:264-278).

    python -m gaussreg_tpu_torch.tools.fuse --root_path scene_dir \\
        --transform_path demo_outputs/estimated_transform.npz
    # or explicit paths:
    python -m gaussreg_tpu_torch.tools.fuse --input1 A.ply --input2 B.ply \\
        --transform_path t.npz --output fused.ply [--device cuda]

With --root_path, the models are A/ and B/output/point_cloud/
iteration_30000/point_cloud.ply under it and the fused model goes to
fuse/output/point_cloud/iteration_30000/point_cloud.ply (A's cameras.json
and cfg_args copied beside it), as the JAX CLI lays them out. Runs on CUDA
unless --device cpu is given; without a card the default raises.
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Fusion script parameters")
    parser.add_argument("--root_path", type=str, default=None)
    parser.add_argument(
        "--transform_path", type=str, default="demo_outputs/estimated_transform.npz"
    )
    parser.add_argument("--input1", type=str, default=None)
    parser.add_argument("--input2", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)

    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.gs.fusion import gaussian_fuse

    dev = resolve_device(args.device)
    if args.root_path:
        root = args.root_path
        input1 = os.path.join(root, "A/output/point_cloud/iteration_30000/point_cloud.ply")
        input2 = os.path.join(root, "B/output/point_cloud/iteration_30000/point_cloud.ply")
        out_dir = os.path.join(root, "fuse/output/point_cloud/iteration_30000")
        os.makedirs(out_dir, exist_ok=True)
        for name in ("cameras.json", "cfg_args"):
            src = os.path.join(root, "A/output", name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(root, "fuse/output", name))
        output = os.path.join(out_dir, "point_cloud.ply")
    else:
        input1, input2, output = args.input1, args.input2, args.output
        if not (input1 and input2 and output):
            parser.error("--input1/--input2/--output required (or --root_path)")

    gaussian_fuse(input1, input2, args.transform_path, output, device=dev)
    print(f"fused model written to {output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
