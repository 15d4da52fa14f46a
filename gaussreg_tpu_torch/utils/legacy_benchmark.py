"""Legacy 3DMatch-style trajectory benchmark utilities (host-side numpy).

Covers the classic Redwood/3DMatch evaluation protocol the reference keeps
around for fragment-pair registration benchmarks:
``gt.log`` / ``gt.info`` trajectory readers and writers, the
covariance-weighted relative-transform error, per-scene precision/recall,
and ground-truth information-matrix calibration
(reference: geotransformer/datasets/registration/ScanNet_GSReg/utils.py:15-228).

These are pure host utilities (file IO + small 4x4/6x6 algebra) — they never
touch the device, so numpy is the right tool. The port's copy of
gaussreg_tpu/utils/legacy_benchmark.py, on the port's own pointcloud.py.
Quaternion math is self-contained (the reference pulls in nibabel for one
mat2quat call).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from gaussreg_tpu_torch.utils.pointcloud import (
    apply_transform_np,
    get_nearest_neighbor,
)

# Fragment counts / display abbreviations for the canonical 3DMatch test
# scenes (reference utils.py:15-49). Kept as data so result tables match the
# published benchmark layout.
SCENE_NUM_FRAGMENTS: Dict[str, int] = {
    "7-scenes-redkitchen": 60,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 60,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 60,
    "sun3d-hotel_uc-scan3": 55,
    "sun3d-hotel_umd-maryland_hotel1": 57,
    "sun3d-hotel_umd-maryland_hotel3": 37,
    "sun3d-mit_76_studyroom-76-1studyroom2": 66,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 38,
}

SCENE_ABBREVIATIONS: Dict[str, str] = {
    "7-scenes-redkitchen": "Kitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1": "Home_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30": "Home_2",
    "sun3d-hotel_uc-scan3": "Hotel_1",
    "sun3d-hotel_umd-maryland_hotel1": "Hotel_2",
    "sun3d-hotel_umd-maryland_hotel3": "Hotel_3",
    "sun3d-mit_76_studyroom-76-1studyroom2": "Study",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": "MIT_Lab",
}


def get_num_fragments(scene_name: str) -> int:
    """reference utils.py:39-42."""
    if scene_name not in SCENE_NUM_FRAGMENTS:
        raise ValueError(f'Unsupported test scene name "{scene_name}".')
    return SCENE_NUM_FRAGMENTS[scene_name]


def get_scene_abbr(scene_name: str) -> str:
    """reference utils.py:45-49."""
    return SCENE_ABBREVIATIONS.get(scene_name, scene_name)


# ---------------------------------------------------------------------------
# Trajectory file formats (Redwood benchmark conventions)
# ---------------------------------------------------------------------------


def read_pose_file(path: str) -> np.ndarray:
    """One camera pose: header line + 4 rows of 4 floats
    (reference utils.py:52-62)."""
    rows = []
    with open(path) as f:
        for line in f.readlines()[1:]:
            rows.append([float(x) for x in line.split()])
    return np.asarray(rows, dtype=np.float64)


def read_log_file(path: str) -> List[dict]:
    """Trajectory ``.log``: blocks of 5 lines — ``id0 id1 num_fragments``
    then a 4x4 transform taking fragment id1 into id0's frame
    (reference utils.py:65-84)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    pairs = []
    for base in range(0, len(lines) - 4, 5):
        head = lines[base].split()
        transform = np.array(
            [lines[base + j].split() for j in range(1, 5)], dtype=np.float32
        )
        pairs.append(
            dict(
                test_pair=[int(head[0]), int(head[1])],
                num_fragments=int(head[2]),
                transform=transform,
            )
        )
    return pairs


def read_info_file(path: str) -> List[dict]:
    """Trajectory ``.info``: blocks of 7 lines — pair header then a 6x6
    information (inverse-covariance) matrix (reference utils.py:87-104)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    pairs = []
    for base in range(0, len(lines) - 6, 7):
        head = lines[base].split()
        cov = np.array(
            [lines[base + j].split() for j in range(1, 7)], dtype=np.float32
        )
        pairs.append(
            dict(
                test_pair=[int(head[0]), int(head[1])],
                num_fragments=int(head[2]),
                covariance=cov,
            )
        )
    return pairs


def write_log_file(path: str, pairs: List[dict]) -> None:
    """Inverse of :func:`read_log_file` (reference utils.py:107-118)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    out = []
    for pair in pairs:
        i0, i1 = pair["test_pair"]
        out.append(f"{i0}\t{i1}\t{pair['num_fragments']}\n")
        for row in np.asarray(pair["transform"]).tolist():
            out.append("\t".join(str(v) for v in row) + "\n")
    with open(path, "w") as f:
        f.writelines(out)


def get_gt_logs_and_infos(gt_root: str, num_fragments: int):
    """Load a scene's GT trajectory and index non-adjacent pairs
    (reference utils.py:121-133). Adjacent fragments (id1 <= id0+1) overlap
    by construction and are excluded from the benchmark."""
    gt_logs = read_log_file(os.path.join(gt_root, "gt.log"))
    gt_infos = read_info_file(os.path.join(gt_root, "gt.info"))
    gt_indices = -np.ones((num_fragments, num_fragments), dtype=np.int32)
    for i, log in enumerate(gt_logs):
        i0, i1 = log["test_pair"]
        if i1 > i0 + 1:
            gt_indices[i0, i1] = i
    return gt_indices, gt_logs, gt_infos


# ---------------------------------------------------------------------------
# Covariance-weighted transform error
# ---------------------------------------------------------------------------


def _mat2quat(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), numerically robust
    Shepperd branch selection. Self-contained replacement for the
    reference's nibabel.quaternions.mat2quat (utils.py:4,133)."""
    m = np.asarray(rot, dtype=np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q


def compute_transform_error(
    transform: np.ndarray, covariance: np.ndarray, estimated_transform: np.ndarray
) -> float:
    """Mahalanobis-style registration error: residual 6-vector
    [t, qx, qy, qz] of gt⁻¹·est weighted by the pair's information matrix,
    normalized by its [0,0] entry (reference utils.py:129-136).

    Equals the mean squared point-alignment error of the correspondences the
    info matrix was calibrated from, to first order in the pose residual."""
    rel = np.linalg.inv(np.asarray(transform, np.float64)) @ np.asarray(
        estimated_transform, np.float64
    )
    q = _mat2quat(rel[:3, :3])
    er = np.concatenate([rel[:3, 3], q[1:]])
    cov = np.asarray(covariance, np.float64)
    return float(er @ cov @ er / cov[0, 0])


def relative_rotation_translation_error(gt: np.ndarray, est: np.ndarray):
    """Classic (RRE degrees, RTE meters) pair used by this protocol
    (reference utils/registration.py:18-35 via utils.py:176)."""
    gt = np.asarray(gt, np.float64)
    est = np.asarray(est, np.float64)
    x = np.clip((np.trace(est[:3, :3].T @ gt[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    rre = float(np.degrees(np.arccos(x)))
    rte = float(np.linalg.norm(gt[:3, 3] - est[:3, 3]))
    return rre, rte


# ---------------------------------------------------------------------------
# Per-scene evaluation
# ---------------------------------------------------------------------------


def evaluate_registration_one_scene(
    gt_log_file: str,
    gt_info_file: str,
    result_file: str,
    positive_threshold: float = 0.2,
) -> dict:
    """Precision/recall of a predicted trajectory against GT for one scene
    (reference utils.py:139-195): a predicted non-adjacent pair is positive
    when its covariance-weighted error is <= threshold²; recall is over all
    GT non-adjacent pairs."""
    gt_logs = read_log_file(gt_log_file)
    gt_infos = read_info_file(gt_info_file)
    result_logs = read_log_file(result_file)

    num_fragments = gt_logs[0]["num_fragments"]
    gt_indices = -np.ones((num_fragments, num_fragments), dtype=np.int32)
    num_gt_pairs = 0
    for i, log in enumerate(gt_logs):
        i0, i1 = log["test_pair"]
        if i1 > i0 + 1:
            gt_indices[i0, i1] = i
            num_gt_pairs += 1

    errors = []
    rres: List[float] = []
    rtes: List[float] = []
    num_pos_pairs = 0
    num_pred_pairs = 0
    for result in result_logs:
        i0, i1 = result["test_pair"]
        if gt_indices[i0, i1] == -1:
            continue
        num_pred_pairs += 1
        gt_index = int(gt_indices[i0, i1])
        gt_pair = gt_infos[gt_index]["test_pair"]
        assert gt_pair[0] == i0 and gt_pair[1] == i1
        error = compute_transform_error(
            gt_logs[gt_index]["transform"],
            gt_infos[gt_index]["covariance"],
            result["transform"],
        )
        errors.append({"id0": i0, "id1": i1, "error": error})
        if error <= positive_threshold**2:
            num_pos_pairs += 1
            rre, rte = relative_rotation_translation_error(
                gt_logs[gt_index]["transform"], result["transform"]
            )
            rres.append(rre)
            rtes.append(rte)

    return {
        "precision": num_pos_pairs / num_pred_pairs if num_pred_pairs else 0.0,
        "recall": num_pos_pairs / num_gt_pairs if num_gt_pairs else 0.0,
        "mean_rre": float(np.mean(rres)) if rres else 0.0,
        "mean_rte": float(np.mean(rtes)) if rtes else 0.0,
        "median_rre": float(np.median(rres)) if rres else 0.0,
        "median_rte": float(np.median(rtes)) if rtes else 0.0,
        "num_pos_pairs": num_pos_pairs,
        "num_pred_pairs": num_pred_pairs,
        "num_gt_pairs": num_gt_pairs,
        "errors": errors,
    }


# ---------------------------------------------------------------------------
# GT calibration (overlap + information matrix)
# ---------------------------------------------------------------------------


def calibrate_ground_truth(
    ref_points: np.ndarray,
    src_points: np.ndarray,
    transform: np.ndarray,
    voxel_size: float = 0.006,
    max_correspondences: int = 5000,
    rng: Optional[np.random.Generator] = None,
):
    """Compute (overlap ratio, 6x6 information matrix) for a GT-aligned pair
    (reference utils.py:198-228, sans open3d: takes raw numpy clouds).

    The info matrix is Σ gᵀg over correspondence points, where g is the
    Jacobian of a point's position w.r.t. the [t, ω] pose perturbation —
    identity for translation and the skew-matrix columns for rotation."""
    rng = rng or np.random.default_rng(0)
    ref_points = np.asarray(ref_points, np.float64)
    src_points = apply_transform_np(np.asarray(src_points, np.float64), transform)

    # overlap = fraction of ref points with an aligned-src neighbor in range
    # (reference utils/registration.py:180-186)
    nn_d = get_nearest_neighbor(ref_points, src_points)
    overlap = float(np.mean(nn_d < voxel_size * 5))

    nn_distances, nn_indices = get_nearest_neighbor(
        ref_points, src_points, return_index=True
    )
    corr = src_points[nn_indices[nn_distances < voxel_size]]
    if corr.shape[0] > max_correspondences:
        corr = corr[rng.choice(corr.shape[0], max_correspondences, replace=False)]
    if corr.shape[0] == 0:
        return overlap, np.zeros((6, 6))
    n = corr.shape[0]
    g = np.zeros((n, 3, 6))
    g[:, :, :3] = np.eye(3)
    # d(p)/dω = -[p]× : columns of the negative skew matrix of p
    g[:, 0, 4] = corr[:, 2]
    g[:, 0, 5] = -corr[:, 1]
    g[:, 1, 3] = -corr[:, 2]
    g[:, 1, 5] = corr[:, 0]
    g[:, 2, 3] = corr[:, 1]
    g[:, 2, 4] = -corr[:, 0]
    info = np.einsum("nki,nkj->ij", g, g)
    return overlap, info
