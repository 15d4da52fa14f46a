"""Register two 3DGS models with the port and write the estimated transform
(port of tools/demo.py; reference: experiments/
geotransformer.gaussian_splatting.indoor/demo.py:21-183).

    python -m gaussreg_tpu_torch.tools.demo --ref A/point_cloud.ply \\
        --src B/point_cloud.ply --weights checkpoints/synthetic_coarse.msgpack \\
        --output_dir demo_outputs [--fine] [--device cuda]

Weights come from a JAX package checkpoint (--weights, msgpack) or from the
reference's released PyTorch snapshot (--torch_snapshot, converted by
engine/torch_import.py); with neither, the model keeps its initial values.
Writes point_cloud_src_org.ply, point_cloud_ref.ply, point_cloud_src.ply and
estimated_transform.npz (key `estimated_transform`) into --output_dir, as
the JAX CLI does. Runs on CUDA unless --device cpu is given: without a
card, the default raises instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ref", required=True, help="reference GS .ply")
    parser.add_argument("--src", required=True, help="source GS .ply")
    parser.add_argument("--weights", default=None, help="model checkpoint (.msgpack)")
    parser.add_argument(
        "--torch_snapshot", default=None,
        help="reference .pth.tar checkpoint (released weights), converted "
        "via engine/torch_import",
    )
    parser.add_argument("--output_dir", default="demo_outputs")
    parser.add_argument("--point_limit", type=int, default=30000)
    parser.add_argument("--fine", action="store_true", help="render-and-compare refinement")
    parser.add_argument("--fine_steps", type=int, default=100)
    parser.add_argument(
        "--cameras_json", default=None,
        help="3DGS cameras.json with real viewpoints for --fine "
        "(default: auto-detected next to --ref)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from gaussreg_tpu_torch.api import register_gs_pair, write_demo_outputs
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model

    dev = resolve_device(args.device)
    cfg = make_cfg()
    model = create_model(cfg, dev)
    if args.weights:
        model.load_state_dict(load_checkpoint(args.weights))
    if args.torch_snapshot:
        from gaussreg_tpu_torch.engine.torch_import import load_for_inference

        cfg, model, report = load_for_inference(args.torch_snapshot, cfg, model)
        print(
            f"torch import: {report['converted']} tensors, "
            f"per_layer_geometry={report['per_layer_kernel_geometry']}"
        )

    result = register_gs_pair(
        args.ref,
        args.src,
        model,
        cfg,
        point_limit=args.point_limit,
        fine=args.fine,
        fine_steps=args.fine_steps,
        cameras_json=args.cameras_json,
        device=dev,
    )
    paths = write_demo_outputs(args.output_dir, result)
    print(f"estimated transform (src -> ref):\n{result['transform']}")
    print(f"RANSAC inliers: {result['ransac_inliers']}")
    for p in paths:
        print(f"saved {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
