"""ScanNet-GSReg test-split evaluation (port of tools/eval_scannet.py, with
the same flags and printout, plus --cpu).

reference: experiments/geotransformer.gaussian_splatting.indoor/test.py:120-216.
Per scene: load the A/B GS plys with their frame alignment, normalize,
coarse registration, un-normalize; then RRE/RTE/RSE against the GT and the
threshold recalls. --fine refines each estimate by render-and-compare in
the raw ply frames, from the scene's cameras.json or from orbit views.

    python -m gaussreg_tpu_torch.tools.eval_scannet --scannet_path /path/to/ScanNet-GSReg \\
        --weights snapshot.msgpack --output_path eval_out [--fine] [--cpu]

Writes <output_path>/estimated_transform.npz (key estimated_transform_list:
a dict scene -> 4x4). Runs on CUDA unless --cpu is given: without a card
the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scannet_path", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument(
        "--torch_snapshot", default=None,
        help="reference .pth.tar checkpoint (released weights); converted "
        "via engine/torch_import and evaluated with per-layer KPConv "
        "geometry when the checkpoint requires it",
    )
    parser.add_argument("--output_path", default="eval_outputs")
    parser.add_argument("--num_sample", type=int, default=30000)
    parser.add_argument(
        "--fine", action="store_true",
        help="refine each coarse estimate by render-and-compare using the "
        "scene's real cameras.json viewpoints",
    )
    parser.add_argument("--fine_steps", type=int, default=100)
    parser.add_argument("--fine_views", type=int, default=4)
    parser.add_argument("--max_fine_gaussians", type=int, default=200000)
    parser.add_argument("--limit_scenes", type=int, default=None)
    parser.add_argument(
        "--tiny", action="store_true",
        help="tiny capacities (CPU integration tests of the pkl/npz path)",
    )
    parser.add_argument(
        "--tiny_capacities", action="store_true",
        help="full reference network dims with tiny pyramid capacities: "
        "the released-weights path at small point counts",
    )
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    import torch

    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.config import CapacityConfig, make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.gs.extract import (
        adjust_point_cloud_volume,
        load_point_cloud_from_gs_ply,
    )
    from gaussreg_tpu_torch.models.metrics import (
        isotropic_transform_error,
        unnormalize_transform,
    )
    from gaussreg_tpu_torch.models.registration import create_model

    if args.fine:
        from gaussreg_tpu_torch.gs.cameras import find_cameras_json, load_cameras_json
        from gaussreg_tpu_torch.gs.fine_registration import (
            default_cameras,
            fine_register,
            to_device_gaussians,
        )

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    if args.tiny_capacities:
        cfg = dataclasses.replace(
            cfg,
            capacity=CapacityConfig(
                levels=(1024, 512, 256, 96, 48),
                neighbor_limits=(24, 16, 16, 16, 16),
                max_correspondences=256,
                max_patch_correspondences=32,
            ),
            ransac=dataclasses.replace(cfg.ransac, num_iterations_test=256),
        )
    model = create_model(cfg, dev)
    if args.weights:
        model.load_state_dict(load_checkpoint(args.weights))
    else:
        # no weights: the JAX CLI's model.init draw, from a seeded generator
        model.reset_parameters(torch.Generator().manual_seed(0))
    if args.torch_snapshot:
        from gaussreg_tpu_torch.engine.torch_import import load_for_inference

        cfg, model, report = load_for_inference(args.torch_snapshot, cfg, model)
        print(
            f"torch import: {report['converted']} tensors, "
            f"{len(report['missing'])} missing, "
            f"per_layer_geometry={report['per_layer_kernel_geometry']}"
        )

    scene_list = np.load(
        os.path.join(args.scannet_path, "test_transformations.npz"), allow_pickle=True
    )["transformations"].item()
    gt_list = scene_list["gt_transformations_list"]
    ref_list = scene_list["ref_transformations_list"]
    src_list = scene_list["src_transformations_list"]

    rre_list, rte_list, rse_list = [], [], []
    estimated = {}
    scenes = list(gt_list)
    if args.limit_scenes:
        scenes = scenes[: args.limit_scenes]

    for idx, scene in enumerate(scenes):
        scene_path = os.path.join(args.scannet_path, "test", str(scene))
        ref_ply = os.path.join(scene_path, "A/output/point_cloud/iteration_10000/point_cloud.ply")
        src_ply = os.path.join(scene_path, "B/output/point_cloud/iteration_10000/point_cloud.ply")
        ref = load_point_cloud_from_gs_ply(
            ref_ply, args.num_sample, transformation=ref_list[scene], return_model=args.fine
        )
        src = load_point_cloud_from_gs_ply(
            src_ply, args.num_sample, transformation=src_list[scene], return_model=args.fine
        )
        ref_points, ref_feats = ref[:2]
        src_points, src_feats = src[:2]
        gt = gt_list[scene]
        ref_n, src_n, _, _, ref_scale, src_scale, ref_center, src_center = (
            adjust_point_cloud_volume(
                ref_points, src_points, gt[:3, :3].copy(), gt[:3, 3].copy(),
                min_adjust_volume=30.0, apply_translation=True,
            )
        )
        out = api.coarse_register_clouds(cfg, model, ref_n, ref_feats, src_n, src_feats,
                                         seed=idx, device=dev)
        est = unnormalize_transform(
            out["estimated_transform"].cpu().numpy(),
            ref_scale, src_scale, ref_center, src_center,
        )

        if args.fine:
            # render-and-compare refinement in the RAW ply frames, where the
            # cameras.json poses live: est maps the frame-aligned clouds, so
            # raw_B -> raw_A is inv(ref_T) @ est @ src_T
            ref_t44 = np.eye(4, dtype=np.float64)
            ref_t44[:3, :4] = np.asarray(ref_list[scene])[:3, :4]
            src_t44 = np.eye(4, dtype=np.float64)
            src_t44[:3, :4] = np.asarray(src_list[scene])[:3, :4]
            t_raw = np.linalg.inv(ref_t44) @ est.astype(np.float64) @ src_t44
            ref_g = to_device_gaussians(ref[2], args.max_fine_gaussians, device=dev)
            src_g = to_device_gaussians(src[2], args.max_fine_gaussians, device=dev)
            del ref, src  # the host models
            cams_path = find_cameras_json(ref_ply)
            if cams_path is not None:
                cams = load_cameras_json(cams_path, max_cameras=args.fine_views, max_size=640)
            else:
                cams = default_cameras(ref_g.means.cpu().numpy(), num_views=args.fine_views)
            fine_out = fine_register(ref_g, src_g, t_raw.astype(np.float32), cams,
                                     num_steps=args.fine_steps)
            t_fine = fine_out.transform.cpu().numpy().astype(np.float64)
            est = (ref_t44 @ t_fine @ np.linalg.inv(src_t44)).astype(np.float32)

        estimated[str(scene)] = est

        # metrics against the ORIGINAL-frame gt (reference test.py:196-198)
        gt44 = np.eye(4, dtype=np.float32)
        gt44[:3, :3] = gt[:3, :3]
        gt44[:3, 3] = gt[:3, 3]
        rre, rte, rse = (float(e) for e in isotropic_transform_error(
            torch.from_numpy(gt44), torch.from_numpy(np.asarray(est, np.float32))))
        rre_list.append(rre)
        rte_list.append(rte)
        rse_list.append(rse)
        print(f"[{idx + 1}/{len(scenes)}] {scene}: RRE {rre:.2f} RTE {rte:.3f} RSE {rse:.3f}",
              flush=True)

    os.makedirs(args.output_path, exist_ok=True)
    np.savez(os.path.join(args.output_path, "estimated_transform.npz"),
             estimated_transform_list=estimated)
    rre = np.array(rre_list)
    rte = np.array(rte_list)
    rse = np.array(rse_list)
    # threshold recall printout (reference test.py:204-212)
    print("rre_avg:", rre.mean())
    print("rte_avg:", rte.mean())
    print("rse_avg:", rse.mean())
    print("rre < 5:", (rre < 5).mean())
    print("rre < 10:", (rre < 10).mean())
    print("rte < 0.1:", (rte < 0.1).mean())
    print("rte < 0.2:", (rte < 0.2).mean())
    print("rse < 0.1:", (rse < 0.1).mean())
    print("rse < 0.2:", (rse < 0.2).mean())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
