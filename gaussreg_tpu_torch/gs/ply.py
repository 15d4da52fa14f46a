"""3D Gaussian Splatting .ply IO (pure numpy; no plyfile dependency). The
port's copy of gaussreg_tpu/gs/ply.py.

Reads/writes the standard 3DGS point_cloud.ply layout:
x y z nx ny nz f_dc_{0..2} f_rest_{0..44} opacity scale_{0..2} rot_{0..3}
(reference: gs_fusion.py:172-229 construct_list_of_attributes/load_ply/save_ply).

Only `binary_little_endian 1.0` and `ascii 1.0` formats with float32
properties are supported — that is what 3DGS emits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

_DTYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
    "short": np.int16,
    "ushort": np.uint16,
    "char": np.int8,
    "uchar": np.uint8,
    "int8": np.int8,
    "uint8": np.uint8,
}


def read_ply_vertex(path: str) -> Dict[str, np.ndarray]:
    """Parse the 'vertex' element of a PLY file into {property: (N,) array}."""
    with open(path, "rb") as f:
        header_lines: List[str] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            header_lines.append(line.decode("ascii", "replace").strip())
            if header_lines[-1] == "end_header":
                break

        if header_lines[0] != "ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype), ...])
        for ln in header_lines[1:]:
            parts = ln.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise ValueError(f"{path}: list properties unsupported")
                elements[-1][2].append((parts[2], _DTYPES[parts[1]]))

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, d) for p, d in props])
            if fmt == "binary_little_endian":
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            else:
                rows = np.loadtxt(
                    (f.readline() for _ in range(count)), dtype=np.float64, ndmin=2
                )
                data = np.zeros(count, dtype=dtype)
                for i, (p, d) in enumerate(props):
                    data[p] = rows[:, i].astype(d)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
        if not out:
            raise ValueError(f"{path}: no vertex element")
        return out


def write_ply_vertex(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write named float32 columns as a binary_little_endian PLY vertex
    element (column order = dict insertion order)."""
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    dtype = np.dtype([(name, np.float32) for name in names])
    data = np.zeros(n, dtype=dtype)
    for name in names:
        col = np.asarray(columns[name], dtype=np.float32).reshape(n)
        data[name] = col
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


@dataclasses.dataclass
class GaussianModel:
    """A 3DGS model as flat numpy arrays.

    xyz: (N, 3); f_dc: (N, 3, 1); f_rest: (N, 3, 15); opacity: (N, 1) logit;
    scales: (N, 3) log-scale; rots: (N, 4) wxyz quaternion (unnormalized).
    """

    xyz: np.ndarray
    f_dc: np.ndarray
    f_rest: np.ndarray
    opacity: np.ndarray
    scales: np.ndarray
    rots: np.ndarray

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    def sh_coeffs(self) -> np.ndarray:
        """(N, 3, 16) full SH coefficients (DC + rest)."""
        return np.concatenate([self.f_dc, self.f_rest], axis=2)


def load_gaussians(path: str, max_sh_degree: int = 3) -> GaussianModel:
    """reference: gs_fusion.py:195-229 (load_ply)."""
    v = read_ply_vertex(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    opacity = v["opacity"][:, None]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1)[:, :, None]
    num_rest = 3 * (max_sh_degree + 1) ** 2 - 3
    rest_names = sorted(
        (k for k in v if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    assert len(rest_names) == num_rest, (path, len(rest_names))
    f_rest = np.stack([v[k] for k in rest_names], axis=1).reshape(
        n, 3, (max_sh_degree + 1) ** 2 - 1
    )
    scale_names = sorted(
        (k for k in v if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    scales = np.stack([v[k] for k in scale_names], axis=1)
    rot_names = sorted(
        (k for k in v if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    rots = np.stack([v[k] for k in rot_names], axis=1)
    return GaussianModel(xyz, f_dc, f_rest, opacity, scales, rots)


def save_gaussians(path: str, g: GaussianModel) -> None:
    """reference: gs_fusion.py:172-193 (save_ply + attribute list)."""
    n = g.num_gaussians
    cols: Dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        cols[name] = g.xyz[:, i]
    for name in ("nx", "ny", "nz"):
        cols[name] = np.zeros(n, np.float32)
    f_dc = g.f_dc.reshape(n, 3)
    for i in range(3):
        cols[f"f_dc_{i}"] = f_dc[:, i]
    n_rest = g.f_rest.shape[1] * g.f_rest.shape[2]
    f_rest = g.f_rest.reshape(n, n_rest)  # explicit: reshape(n, -1) breaks at n == 0
    for i in range(n_rest):
        cols[f"f_rest_{i}"] = f_rest[:, i]
    cols["opacity"] = g.opacity.reshape(n)
    for i in range(g.scales.shape[1]):
        cols[f"scale_{i}"] = g.scales[:, i]
    for i in range(g.rots.shape[1]):
        cols[f"rot_{i}"] = g.rots[:, i]
    write_ply_vertex(path, cols)
