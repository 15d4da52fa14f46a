"""Offline neighbor-limit calibration (port of tools/calibrate_neighbors.py,
with the same flags and lines, plus --tiny and --cpu).

reference: geotransformer/utils/data.py:192-217
(calibrate_neighbors_stack_mode): build per-level neighbor-count histograms
over sample clouds and pick the `keep_ratio`-quantile caps. The published
limits [89, 30, 43, 49, 49] (reference test.py:129) come from this
procedure; this tool recomputes them for new data so that
CapacityConfig.neighbor_limits can be updated.

    python -m gaussreg_tpu_torch.tools.calibrate_neighbors \\
        [--data_root ROOT | --synthetic] [--samples 20] [--keep_ratio 0.8] \\
        [--tiny] [--cpu]

Every pyramid is built on the device at the generous measuring limit
(min(ceil(4/3 pi (base_radius + 1)^3), 128) slots per level) and
build_pyramid's default level-0 window of 5 rows, as the JAX tool builds
it, so on a card each of its radius searches is a window selection at that
limit. Runs on CUDA unless --cpu is given: without a card the default
raises.
"""

from __future__ import annotations

import argparse
from typing import Iterable, List, Tuple

import numpy as np


def measure_limits(cfg) -> Tuple[int, ...]:
    """The per-level caps while measuring (reference data.py:196)."""
    hist_n = int(np.ceil(4 / 3 * np.pi * (cfg.backbone.base_radius + 1) ** 3))
    return tuple([min(hist_n, 128)] * cfg.backbone.num_stages)


def synthetic_clouds(cfg, samples: int):
    """Both clouds of the synthetic pairs random_pair(cfg, i), i < samples."""
    from gaussreg_tpu_torch.data.synthetic import random_pair

    for i in range(samples):
        rp, rf, sp, sf, m = random_pair(cfg, i)
        yield rp
        yield sp


def scannet_clouds(cfg, data_root: str, samples: int):
    """Both clouds of the first `samples` items of a ScanNet-GSReg train split."""
    from gaussreg_tpu_torch.data.scannet import ScanNetGSRegDataset

    ds = ScanNetGSRegDataset(data_root, "train", point_limit=cfg.train.point_limit)
    for i in range(min(samples, len(ds))):
        item = ds[i]
        yield item["ref_points"]
        yield item["src_points"]


def calibrate(cfg, clouds: Iterable[np.ndarray], keep_ratio: float,
              device=None) -> Tuple[List[int], np.ndarray]:
    """Neighbor-count histograms of each level's self search over `clouds`
    (numpy (n, 3) each), at `measure_limits(cfg)`; returns (limits, hists)
    with limits[l] the smallest count that keeps `keep_ratio` of level l's
    points untruncated, hists (num_stages, limit + 1) int64."""
    import torch

    from gaussreg_tpu_torch.data.pipeline import build_pyramid, pad_cloud
    from gaussreg_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    num_stages = cfg.backbone.num_stages
    limits_m = measure_limits(cfg)
    hists = np.zeros((num_stages, limits_m[0] + 1), np.int64)
    for cloud in clouds:
        pts, _, mask = pad_cloud(cloud, cloud[:, :1], cfg.capacity.levels[0])
        pyr = build_pyramid(
            torch.from_numpy(pts)[None].to(dev),
            torch.from_numpy(mask)[None].to(dev),
            cfg.backbone.init_voxel_size,
            cfg.backbone.init_radius,
            cfg.capacity.levels,
            limits_m,
            num_stages,
        )
        for lvl in range(num_stages):
            nbr = pyr.neighbors[lvl][0].cpu().numpy()
            msk = pyr.masks[lvl][0].cpu().numpy()
            counts = (nbr < nbr.shape[0]).sum(axis=1)[msk]
            hists[lvl] += np.bincount(counts, minlength=limits_m[0] + 1)[: limits_m[0] + 1]

    limits = []
    for lvl in range(num_stages):
        cum = np.cumsum(hists[lvl])
        limits.append(int(np.searchsorted(cum, keep_ratio * cum[-1]) + 1))
    return limits, hists


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--keep_ratio", type=float, default=0.8)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny capacities (CPU smoke run of the tool itself)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    if args.synthetic or args.data_root is None:
        clouds = synthetic_clouds(cfg, args.samples)
    else:
        clouds = scannet_clouds(cfg, args.data_root, args.samples)
    limits, _ = calibrate(cfg, clouds, args.keep_ratio, dev)
    print("calibrated neighbor_limits:", limits)
    print("(update CapacityConfig.neighbor_limits with these)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
