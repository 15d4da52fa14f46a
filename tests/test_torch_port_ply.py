"""The port's .ply reader: `load_gaussians` against the per-column read bit
for bit on every file layout it takes, and `api.register_gs_pair` reading
each file once a call (the counter `gs.ply_reads`) with the results of the
old sequence that read each file twice."""

import numpy as np
import pytest
import torch

from gaussreg_tpu_torch.gs.ply import (
    GaussianModel,
    load_gaussians,
    read_ply_vertex,
    save_gaussians,
    write_ply_vertex,
)
from gaussreg_tpu_torch.ops import _cuda

FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scales", "rots")


def _reads():
    return _cuda.launch_counts()["gs.ply_reads"]


def _model(n, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    return GaussianModel(
        xyz=rng.uniform(0, 3.0, size=(n, 3)).astype(np.float32) + np.float32(shift),
        f_dc=rng.normal(scale=0.3, size=(n, 3, 1)).astype(np.float32),
        f_rest=rng.normal(scale=0.02, size=(n, 3, 15)).astype(np.float32),
        opacity=np.full((n, 1), 2.5, np.float32),
        scales=rng.normal(-3.0, 0.2, size=(n, 3)).astype(np.float32),
        rots=rng.normal(size=(n, 4)).astype(np.float32),
    )


def _columns(g):
    """The model's columns as `save_gaussians` writes them, by name."""
    n = g.num_gaussians
    cols = {c: g.xyz[:, i] for i, c in enumerate("xyz")}
    cols.update({f"f_dc_{i}": g.f_dc[:, i, 0] for i in range(3)})
    rest = g.f_rest.reshape(n, 45)
    cols.update({f"f_rest_{i}": rest[:, i] for i in range(45)})
    cols["opacity"] = g.opacity[:, 0]
    cols.update({f"scale_{i}": g.scales[:, i] for i in range(3)})
    cols.update({f"rot_{i}": g.rots[:, i] for i in range(4)})
    return cols


def _write_shuffled(path, g):
    cols = _columns(g)
    order = np.random.default_rng(1).permutation(len(cols))
    names = list(cols)
    write_ply_vertex(path, {names[i]: cols[names[i]] for i in order})


def _write_extra_uchar(path, g):
    """3DGS's columns with a uchar `red` between the normals and f_dc."""
    cols = _columns(g)
    n = g.num_gaussians
    props = [(k, "<f4") for k in list(cols)[:3]] + [("red", "u1")]
    props += [(k, "<f4") for k in list(cols)[3:]]
    data = np.zeros(n, np.dtype(props))
    for k, v in cols.items():
        data[k] = v
    data["red"] = np.arange(n) % 251
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {'uchar' if d == 'u1' else 'float'} {k}" for k, d in props]
    with open(path, "wb") as f:
        f.write(("\n".join(header + ["end_header", ""])).encode("ascii"))
        f.write(data.tobytes())


def _write_ascii(path, g):
    cols = _columns(g)
    n = g.num_gaussians
    header = ["ply", "format ascii 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in cols]
    rows = np.stack(list(cols.values()), axis=1)
    with open(path, "w") as f:
        f.write("\n".join(header + ["end_header", ""]))
        for r in rows:
            f.write(" ".join(repr(float(x)) for x in r) + "\n")


def _per_column_load(path, max_sh_degree=3):
    """`load_gaussians` as one np.stack of (N,) columns a field."""
    v = read_ply_vertex(path)
    n = v["x"].shape[0]

    def numbered(prefix):
        return sorted((k for k in v if k.startswith(prefix)),
                      key=lambda s: int(s.split("_")[-1]))

    return GaussianModel(
        xyz=np.stack([v["x"], v["y"], v["z"]], axis=1),
        f_dc=np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1)[:, :, None],
        f_rest=np.stack([v[k] for k in numbered("f_rest_")], axis=1).reshape(
            n, 3, (max_sh_degree + 1) ** 2 - 1),
        opacity=v["opacity"][:, None],
        scales=np.stack([v[k] for k in numbered("scale_")], axis=1),
        rots=np.stack([v[k] for k in numbered("rot_")], axis=1),
    )


@pytest.mark.parametrize(
    "write", [save_gaussians, _write_shuffled, _write_extra_uchar, _write_ascii],
    ids=["3dgs", "shuffled", "extra_uchar", "ascii"])
def test_load_gaussians_equals_the_per_column_read(tmp_path, write):
    g = _model(257)
    g.f_rest[3, 1, 2] = np.float32(-0.0)
    g.f_rest[5, 2, 14] = np.float32(np.nan)
    path = str(tmp_path / "m.ply")
    write(path, g)

    before = _reads()
    got = load_gaussians(path)
    assert _reads() - before == 1
    want = _per_column_load(path)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.float32, name
        assert a.shape == b.shape, name
        assert a.flags["C_CONTIGUOUS"] and b.flags["C_CONTIGUOUS"], name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=name)
        np.testing.assert_array_equal(a.view(np.uint32),
                                      getattr(g, name).view(np.uint32), err_msg=name)

    for name in FIELDS:
        others = {k: getattr(got, k).copy() for k in FIELDS if k != name}
        getattr(got, name)[...] = 7.0
        for k, v in others.items():
            np.testing.assert_array_equal(getattr(got, k).view(np.uint32), v.view(np.uint32),
                                          err_msg=f"{name} -> {k}")


@pytest.mark.parametrize("write", [save_gaussians, _write_extra_uchar], ids=["3dgs", "extra_uchar"])
def test_truncated_vertex_data_raises(tmp_path, write):
    path = str(tmp_path / "m.ply")
    write(path, _model(64))
    with open(path, "rb+") as f:
        f.truncate(f.seek(0, 2) - 10)
    with pytest.raises(ValueError):
        load_gaussians(path)


@pytest.fixture(scope="module")
def gs_pair_files(tmp_path_factory):
    from gaussreg_tpu_torch.gs import cameras as tcameras
    from gaussreg_tpu_torch.gs import fine_registration as tfine

    root = tmp_path_factory.mktemp("pair")
    paths = []
    for i, (name, shift) in enumerate((("ref.ply", 0.0), ("src.ply", 0.05))):
        paths.append(str(root / name))
        save_gaussians(paths[-1], _model(1200, seed=i, shift=shift))
    cams = tfine.default_cameras(np.full((2, 3), 1.5) + [[-1.5], [1.5]], num_views=2,
                                 width=64, height=48)
    tcameras.save_cameras_json(str(root / "cameras.json"), cams)
    return paths


def _two_reads_a_call(ref_ply, src_ply, model, cfg, steps, max_gaussians, seed):
    """`register_gs_pair(fine=True)` as the old sequence of calls that read
    each file twice: the extraction, then `load_gaussians` for the fine load."""
    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.gs import cameras as tcameras
    from gaussreg_tpu_torch.gs import fine_registration as tfine
    from gaussreg_tpu_torch.gs.extract import (
        adjust_point_cloud_volume,
        load_point_cloud_from_gs_ply,
    )
    from gaussreg_tpu_torch.models.metrics import unnormalize_transform

    limit = cfg.train.point_limit
    ref_points, ref_feats = load_point_cloud_from_gs_ply(ref_ply, limit, seed=seed)
    src_points, src_feats = load_point_cloud_from_gs_ply(src_ply, limit, seed=seed + 1)
    ref_n, src_n, _, _, ref_scale, src_scale, ref_center, src_center = (
        adjust_point_cloud_volume(ref_points, src_points, np.eye(3), np.zeros(3),
                                  min_adjust_volume=30.0, apply_translation=True))
    out = api.coarse_register_clouds(cfg, model, ref_n, ref_feats, src_n, src_feats,
                                     seed=seed, device="cpu")
    coarse = unnormalize_transform(out["estimated_transform"].cpu().numpy(),
                                   ref_scale, src_scale, ref_center, src_center)
    ref_g = tfine.to_device_gaussians(load_gaussians(ref_ply), max_gaussians, device="cpu")
    src_g = tfine.to_device_gaussians(load_gaussians(src_ply), max_gaussians, device="cpu")
    cams = tcameras.load_cameras_json(tcameras.find_cameras_json(ref_ply), max_cameras=4,
                                      max_size=640)
    fine = tfine.fine_register(ref_g, src_g, coarse, cams, num_steps=steps)
    return coarse, fine.transform.cpu().numpy(), fine.losses.cpu().numpy()


def test_register_gs_pair_reads_each_file_once(gs_pair_files, monkeypatch):
    """With `fine` the call reads each file once, inside the extraction (the
    function the benchmark's front-end span wraps), and returns the old
    sequence's transforms and losses bit for bit; without `fine` it reads
    each file once too."""
    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.models.registration import create_model

    ref_ply, src_ply = gs_pair_files
    cfg = make_tiny_cfg()
    torch.manual_seed(0)
    model = create_model(cfg, "cpu")
    inside = []
    extract = api.load_point_cloud_from_gs_ply

    def counted(*args, **kwargs):
        before = _reads()
        out = extract(*args, **kwargs)
        inside.append(_reads() - before)
        return out

    monkeypatch.setattr(api, "load_point_cloud_from_gs_ply", counted)
    before = _reads()
    res = api.register_gs_pair(ref_ply, src_ply, model, cfg, fine=True, fine_steps=3,
                               max_fine_gaussians=1500, seed=5, device="cpu")
    assert _reads() - before == 2 and inside == [1, 1]

    coarse, transform, losses = _two_reads_a_call(ref_ply, src_ply, model, cfg, 3, 1500, 5)
    for got, want in ((res["coarse_transform"], coarse), (res["transform"], transform),
                      (res["fine_losses"], losses)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    before = _reads()
    res = api.register_gs_pair(ref_ply, src_ply, model, cfg, seed=5, device="cpu")
    assert _reads() - before == 2
    np.testing.assert_array_equal(res["transform"], coarse)
