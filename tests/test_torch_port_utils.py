"""The port's host utilities (gaussreg_tpu_torch/utils/{pointcloud,
legacy_benchmark,visualization}.py) against the JAX package's copies, on
small files: trajectory files written by one package are read back by the
other, and every number (recall, errors, calibration) and every written
file is equal. Both are numpy and scipy on the host, so the tolerance is
0."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from gaussreg_tpu.utils import legacy_benchmark as jlb
from gaussreg_tpu.utils import pointcloud as jpc
from gaussreg_tpu.utils import visualization as jvis
from gaussreg_tpu_torch.utils import legacy_benchmark as tlb
from gaussreg_tpu_torch.utils import pointcloud as tpc
from gaussreg_tpu_torch.utils import visualization as tvis


def _se3(rng):
    m = np.eye(4)
    m[:3, :3] = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
    m[:3, 3] = rng.normal(size=3)
    return m


def _write_info(path, pairs, covs):
    lines = []
    for (i0, i1, n), cov in zip(pairs, covs):
        lines.append(f"{i0}\t{i1}\t{n}\n")
        lines += [" ".join(f"{v:.9e}" for v in row) + "\n" for row in cov]
    path.write_text("".join(lines))


@pytest.mark.parametrize("writer,reader", [(jlb, tlb), (tlb, jlb)])
def test_trajectory_files_cross_read_and_recall_equal(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    n = 8
    pairs = [(i, j, n) for i in range(n) for j in range(i + 1, n)]
    gt = [dict(test_pair=[i, j], num_fragments=n, transform=_se3(rng)) for i, j, _ in pairs]
    covs = []
    for _ in pairs:
        a = rng.normal(size=(6, 6))
        covs.append(a @ a.T + 6 * np.eye(6))
    est = []
    for g in gt:  # near the truth, some far off
        t = np.array(g["transform"])
        t[:3, 3] += rng.normal(scale=0.02 if rng.uniform() < 0.7 else 1.0, size=3)
        est.append(dict(g, transform=t))
    writer.write_log_file(str(tmp_path / "gt.log"), gt)
    writer.write_log_file(str(tmp_path / "est.log"), est)
    _write_info(tmp_path / "gt.info", pairs, covs)

    for a, b in zip(reader.read_log_file(str(tmp_path / "gt.log")),
                    writer.read_log_file(str(tmp_path / "gt.log"))):
        assert a["test_pair"] == b["test_pair"] and a["num_fragments"] == b["num_fragments"]
        np.testing.assert_array_equal(a["transform"], b["transform"])
    for a, b in zip(reader.read_info_file(str(tmp_path / "gt.info")),
                    jlb.read_info_file(str(tmp_path / "gt.info"))):
        np.testing.assert_array_equal(a["covariance"], b["covariance"])
    ti, tl, tinf = reader.get_gt_logs_and_infos(str(tmp_path), n)
    ji, _, _ = writer.get_gt_logs_and_infos(str(tmp_path), n)
    np.testing.assert_array_equal(ti, ji)

    args = [str(tmp_path / f) for f in ("gt.log", "gt.info", "est.log")]
    got = reader.evaluate_registration_one_scene(*args)
    want = writer.evaluate_registration_one_scene(*args)
    assert 0.0 < want["recall"] < 1.0
    assert got == want


def test_transform_helpers_equal():
    rng = np.random.default_rng(1)
    for _ in range(5):
        gt, est = _se3(rng), _se3(rng)
        cov = np.eye(6) * rng.uniform(1, 10)
        assert tlb.compute_transform_error(gt, cov, est) == jlb.compute_transform_error(gt, cov, est)
        assert tlb.relative_rotation_translation_error(gt, est) == \
            jlb.relative_rotation_translation_error(gt, est)
        np.testing.assert_array_equal(tlb._mat2quat(gt[:3, :3]), jlb._mat2quat(gt[:3, :3]))
    assert tlb.get_num_fragments("sun3d-hotel_uc-scan3") == 55
    assert tlb.get_scene_abbr("7-scenes-redkitchen") == "Kitchen"


def test_calibration_equal():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2000, 3))
    t = _se3(rng)
    src = jpc.apply_transform_np(pts + rng.normal(scale=1e-3, size=pts.shape),
                                 np.linalg.inv(t))
    for voxel in (0.05, 0.2):
        got = tlb.calibrate_ground_truth(pts, src, t, voxel_size=voxel, max_correspondences=500,
                                         rng=np.random.default_rng(3))
        want = jlb.calibrate_ground_truth(pts, src, t, voxel_size=voxel,
                                          max_correspondences=500,
                                          rng=np.random.default_rng(3))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_pointcloud_helpers_equal():
    rng = np.random.default_rng(4)
    q = rng.uniform(size=(300, 3)).astype(np.float32)
    s = rng.uniform(size=(500, 3)).astype(np.float32)
    for ret in (False, True):
        got, want = tpc.get_nearest_neighbor(q, s, ret), jpc.get_nearest_neighbor(q, s, ret)
        for a, b in zip(got if ret else (got,), want if ret else (want,)):
            np.testing.assert_array_equal(a, b)
    t = _se3(rng).astype(np.float32)
    np.testing.assert_array_equal(tpc.apply_transform_np(q, t), jpc.apply_transform_np(q, t))
    np.testing.assert_array_equal(tpc.inverse_transform_np(t), jpc.inverse_transform_np(t))
    sim = t.copy()
    sim[:3, :3] *= 1.7
    for a, b in zip(tpc.get_rotation_translation_from_transform_w_scale(sim),
                    jpc.get_rotation_translation_from_transform_w_scale(sim)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpc.random_sample_rotation(0.5, np.random.default_rng(5)),
                                  jpc.random_sample_rotation(0.5, np.random.default_rng(5)))
    np.testing.assert_array_equal(tpc.random_sample_points(s, 100, np.random.default_rng(6)),
                                  jpc.random_sample_points(s, 100, np.random.default_rng(6)))
    scores = rng.uniform(size=500)
    np.testing.assert_array_equal(tpc.sample_keypoints_nms(s, scores, 40, 0.1),
                                  jpc.sample_keypoints_nms(s, scores, 40, 0.1))
    depth = rng.uniform(0, 3, size=(24, 32))
    depth[::5] = 0
    k = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    np.testing.assert_array_equal(tpc.depth_to_points(depth, k, 1.0, 2.5),
                                  jpc.depth_to_points(depth, k, 1.0, 2.5))
    np.testing.assert_array_equal(tpc.get_correspondences(s, q, t, 0.05),
                                  jpc.get_correspondences(s, q, t, 0.05))


def test_visualization_files_equal(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    other = rng.normal(size=(50, 3)).astype(np.float32)
    node = rng.integers(0, 6, size=50)
    valid = rng.uniform(size=50) > 0.3
    t = _se3(rng)
    for name, mod in (("j", jvis), ("t", tvis)):
        d = tmp_path / name
        d.mkdir()
        mod.write_point_cloud(str(d / "cloud.ply"), pts, rng.uniform(size=(50, 3)) * 0)
        mod.write_node_partition(str(d / "nodes.ply"), pts, node)
        mod.write_scored_cloud(str(d / "scored.ply"), pts, np.linspace(0, 3, 50))
        mod.write_correspondences_obj(str(d / "corr.obj"), pts, other, valid)
        mod.write_registration_result(str(d / "reg"), pts, other, t)
    for f in ("cloud.ply", "nodes.ply", "scored.ply", "corr.obj", "reg/ref.ply",
              "reg/src_aligned.ply"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f
