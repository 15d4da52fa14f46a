"""ScanNet-GSReg dataset: host-side loading, augmentation and volume
normalization (port of gaussreg_tpu/data/scannet.py, on the port's
gs/extract.py).

reference: geotransformer/datasets/registration/ScanNet_GSReg/dataset.py:23-261.
Layout on disk (reference README.md:77-113):
    <root>/train.pkl, <root>/test.pkl              (metadata lists)
    <root>/{val,test}_transformations.npz           (ref/src/gt transform dicts)
    <root>/<subset>/<scene>/{A,B}/output/point_cloud/iteration_*/point_cloud.ply

Each item holds numpy arrays; padding and the pyramid are built on the
device by gaussreg_tpu_torch.data.pipeline.make_pair_batch.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict, List, Optional

import numpy as np

from gaussreg_tpu_torch.gs.extract import (
    adjust_point_cloud_volume,
    load_point_cloud_from_gs_ply,
)


def _random_rotation_np(rng: np.random.Generator, factor: float = 1.0) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis) + 1e-12
    angle = rng.uniform() * 2.0 * np.pi * factor
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def augment_pair(
    rng: np.random.Generator,
    ref_points: np.ndarray,
    src_points: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    aug_rotation: float = 1.0,
    aug_noise: float = 0.005,
):
    """Random per-cloud scale in [1, 4] (or its inverse), random rotation of
    one cloud, uniform noise (reference dataset.py:170-212)."""
    rot_aug = _random_rotation_np(rng, aug_rotation)
    scale = rng.uniform() * 3.0 + 1.0
    if rng.uniform() > 0.5:
        aug_scale = scale if rng.uniform() > 0.5 else 1.0 / scale
        src_points = src_points * aug_scale
        rotation = rotation / aug_scale
    if rng.uniform() > 0.5:
        aug_scale = scale if rng.uniform() > 0.5 else 1.0 / scale
        ref_points = ref_points * aug_scale
        rotation = rotation * aug_scale
        translation = translation * aug_scale
    if rng.uniform() > 0.5:
        ref_points = ref_points @ rot_aug.T
        rotation = rot_aug @ rotation
        translation = rot_aug @ translation
    else:
        src_points = src_points @ rot_aug.T
        rotation = rotation @ rot_aug.T
    ref_points = ref_points + (rng.uniform(size=ref_points.shape) - 0.5) * aug_noise
    src_points = src_points + (rng.uniform(size=src_points.shape) - 0.5) * aug_noise
    return (
        ref_points.astype(np.float32),
        src_points.astype(np.float32),
        rotation,
        translation,
    )


class ScanNetGSRegDataset:
    """reference dataset.py:23-261 (torch Dataset -> plain python class)."""

    def __init__(
        self,
        dataset_root: str,
        subset: str,
        point_limit: Optional[int] = 30000,
        use_augmentation: bool = False,
        augmentation_noise: float = 0.005,
        augmentation_rotation: float = 1.0,
        overlap_threshold: Optional[float] = None,
        seed: int = 0,
    ):
        self.dataset_root = dataset_root
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.aug_noise = augmentation_noise
        self.aug_rotation = augmentation_rotation
        self.rng = np.random.default_rng(seed)

        if subset != "train":
            tl = np.load(
                osp.join(dataset_root, f"{subset}_transformations.npz"),
                allow_pickle=True,
            )["transformations"].item()
            self.ref_transformations = tl["ref_transformations_list"]
            self.src_transformations = tl["src_transformations_list"]
            self.gt_transformations = tl["gt_transformations_list"]
        with open(osp.join(dataset_root, f"{subset}.pkl"), "rb") as f:
            self.metadata_list: List[Dict] = pickle.load(f)
        if overlap_threshold is not None:
            self.metadata_list = [
                x for x in self.metadata_list if x["overlap"] > overlap_threshold
            ]
        if subset != "train":
            self.metadata_list = [
                x
                for x in self.metadata_list
                if x["scene_name"] in self.gt_transformations
            ]

    def __len__(self) -> int:
        return len(self.metadata_list)

    def __getitem__(self, index: int) -> Dict:
        meta = self.metadata_list[index]
        item: Dict = {
            "scene_name": meta["scene_name"],
            "ref_frame": meta.get("frag_id0"),
            "src_frame": meta.get("frag_id1"),
            "overlap": meta.get("overlap"),
        }
        if self.subset == "train":
            rotation = meta["rotation"]
            translation = meta["translation"]
            view_rot = _random_rotation_np(self.rng, self.aug_rotation)
            ref_points, ref_feats = load_point_cloud_from_gs_ply(
                osp.join(self.dataset_root, meta["pcd0"]),
                self.point_limit,
                view_rotation=view_rot,
            )
            src_points, src_feats = load_point_cloud_from_gs_ply(
                osp.join(self.dataset_root, meta["pcd1"]),
                self.point_limit,
                view_rotation=_random_rotation_np(self.rng, self.aug_rotation),
            )
        else:
            scene = meta["scene_name"]
            gt = self.gt_transformations[scene]
            rotation = gt[:3, :3]
            translation = gt[:3, 3]
            ref_points, ref_feats = load_point_cloud_from_gs_ply(
                osp.join(self.dataset_root, meta["pcd0"]),
                self.point_limit,
                transformation=self.ref_transformations[scene],
            )
            src_points, src_feats = load_point_cloud_from_gs_ply(
                osp.join(self.dataset_root, meta["pcd1"]),
                self.point_limit,
                transformation=self.src_transformations[scene],
            )

        if self.use_augmentation:
            ref_points, src_points, rotation, translation = augment_pair(
                self.rng,
                ref_points,
                src_points,
                rotation,
                translation,
                self.aug_rotation,
                self.aug_noise,
            )

        (
            ref_points,
            src_points,
            rotation,
            translation,
            ref_scale,
            src_scale,
            ref_center,
            src_center,
        ) = adjust_point_cloud_volume(
            ref_points,
            src_points,
            rotation,
            translation,
            min_adjust_volume=10.0 if self.subset == "train" else 30.0,
            apply_translation=self.subset != "train",
        )

        transform = np.eye(4, dtype=np.float32)
        transform[:3, :3] = rotation
        transform[:3, 3] = translation

        item.update(
            ref_points=ref_points.astype(np.float32),
            src_points=src_points.astype(np.float32),
            ref_feats=ref_feats,
            src_feats=src_feats,
            transform=transform,
            ref_adjust_scale=ref_scale,
            src_adjust_scale=src_scale,
            ref_center=ref_center.astype(np.float32),
            src_center=src_center.astype(np.float32),
        )
        return item
