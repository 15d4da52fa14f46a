"""3DGS scene pairs for the fine cell: two reconstructions of one room at
a known similarity, written in 3D Gaussian Splatting's output layout.

The room follows the easy tier of the coarse traffic's pairs
(portbench/gen/synthetic.py): a floor, two walls, 4-8 boxes and spheres
with per-surface colours under two low-frequency colour fields, two views
of it split by a random plane so that a share of 0.65-0.9 is seen by both,
and the easy tier's similarity (scale 1-2.5, a uniform rotation, a
translation of 0.5 per axis). Each model is densified on its own to
`num_gaussians` gaussians, drawn independently for ref and src (two
reconstructions, not one model copied): 2 % floaters in the room's volume,
the rest on the surfaces seen by that view, each flattened along its
surface (two tangential scales of median 5 mm, a normal scale 5-20 % of the
smaller), opacities mostly near 1 with a low tail (18 %), and colour
bands that decay with the degree: the DC term from the surface's colour,
bands 1-3 a view-dependent part shared by each surface plus a share of
the gaussian's own. The src model is the room under the inverse of the
similarity: means, rotations and scales moved, the bands rotated.

`write_pair` writes <root>/<name>/point_cloud/iteration_30000/point_cloud.ply
for both models, ref's with a cameras.json of 16 interior viewpoints at
ScanNet's 1296x968 colour size (focal 1170 px) beside it, looking from
inside the room at its walls and floor."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from portbench.reference.fine import SH_C0, sh_basis

SCANNET_SIZE = (1296, 968)
SCANNET_FOCAL = 1170.0
NUM_CAMERAS = 16
FLOATERS = 0.02
SH_BAND_SCALE = (0.04, 0.02, 0.01)  # band 1-3 coefficient scales (decaying)
BANDS = np.repeat([0, 1, 2], [3, 5, 7])  # band - 1 of each of the 15 rest coefficients


class Room:
    """The room's surfaces, colours and view split, drawn from one seed."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.ext = rng.uniform(2.5, 3.5, size=2)
        self.h = rng.uniform(1.8, 2.6)
        ext, h = self.ext, self.h
        # (kind, params, colour, share of the surface points)
        self.surfaces = [
            ("plane", (np.zeros(3), np.array([ext[0], 0, 0]), np.array([0, 0, ext[1]])), 0.3),
            ("plane", (np.zeros(3), np.array([ext[0], 0, 0]), np.array([0, h, 0])), 0.15),
            ("plane", (np.zeros(3), np.array([0, 0, ext[1]]), np.array([0, h, 0])), 0.15),
        ]
        num_objects = int(rng.integers(4, 9))
        for _ in range(num_objects):
            centre = np.array([rng.uniform(0.3, ext[0] - 0.3), rng.uniform(0.1, h * 0.5),
                               rng.uniform(0.3, ext[1] - 0.3)])
            if rng.uniform() < 0.5:
                self.surfaces.append(("sphere", (centre, rng.uniform(0.1, 0.4)),
                                      0.4 / num_objects))
            else:
                self.surfaces.append(("box", (centre, rng.uniform(0.15, 0.6, 3)),
                                      0.4 / num_objects))
        self.colours = rng.uniform(40, 220, size=(len(self.surfaces), 3))
        self.views = rng.normal(size=(len(self.surfaces), 3, 15)) * np.asarray(
            SH_BAND_SCALE)[BANDS]
        self.fields = [(rng.normal(size=(3, 3)) * rng.uniform(1.0, 4.0),
                        rng.uniform(0, 2 * np.pi, size=3), rng.uniform(20.0, 45.0, size=3))
                       for _ in range(2)]
        overlap = rng.uniform(0.65, 0.9)
        axis = rng.normal(size=3)
        self.axis = axis / np.linalg.norm(axis)
        pts = self.sample(20000)[0]
        self.centre = pts.mean(0)
        proj = (pts - self.centre) @ self.axis
        lo, hi = np.quantile(proj, [0.02, 0.98])
        margin = (hi - lo) * (1.0 - overlap) * 0.5
        self.split = {"ref": (-np.inf, hi - margin), "src": (lo + margin, np.inf)}

    def sample(self, count: int):
        """`count` surface points: (points, unit normals, surface index)."""
        rng = self.rng
        shares = np.array([s[2] for s in self.surfaces])
        which = rng.choice(len(self.surfaces), size=count, p=shares / shares.sum())
        pts = np.empty((count, 3))
        nrm = np.empty((count, 3))
        for i, (kind, par, _) in enumerate(self.surfaces):
            sel = np.flatnonzero(which == i)
            n = sel.shape[0]
            if kind == "plane":
                o, u, v = par
                pts[sel] = o + rng.uniform(size=(n, 1)) * u + rng.uniform(size=(n, 1)) * v
                nrm[sel] = np.cross(u, v) / np.linalg.norm(np.cross(u, v))
            elif kind == "sphere":
                c, r = par
                d = rng.normal(size=(n, 3))
                d /= np.linalg.norm(d, axis=1, keepdims=True)
                pts[sel], nrm[sel] = c + r * d, d
            else:
                c, size = par
                face = rng.integers(0, 3, size=n)
                sign = rng.choice([-1.0, 1.0], size=n)
                p = rng.uniform(-0.5, 0.5, size=(n, 3)) * size
                p[np.arange(n), face] = 0.5 * sign * size[face]
                pts[sel] = c + p
                nrm[sel] = 0.0
                nrm[sel, face] = sign
        return pts, nrm, which

    def colour(self, pts: np.ndarray, which: np.ndarray) -> np.ndarray:
        c = self.colours[which]
        for k, phase, amp in self.fields:
            c = c + amp * np.sin(pts @ k.T * (2 * np.pi) + phase)
        return c

    def densify(self, view: str, count: int):
        """The gaussians of one reconstruction of `view`'s part of the room,
        in the room's frame: dict of means, normal-aligned rotations (3, 3),
        log scales, opacity logits, dc (rgb 0-255) and rest (3, 15)."""
        rng = self.rng
        lo, hi = self.split[view]
        n_float = int(round(count * FLOATERS))
        need = count - n_float
        chunks = []
        while need > 0:
            pts, nrm, which = self.sample(int(need * 1.6) + 1000)
            proj = (pts - self.centre) @ self.axis
            keep = np.flatnonzero((proj >= lo) & (proj <= hi))[:need]
            chunks.append((pts[keep], nrm[keep], which[keep]))
            need -= keep.shape[0]
        pts, nrm, which = (np.concatenate(c) for c in zip(*chunks))
        n = pts.shape[0]
        pts = pts + nrm * rng.normal(scale=0.002, size=(n, 1))
        # a tangent frame [t1, t2, n] with a random in-plane turn
        helper = np.where(np.abs(nrm[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
        t1 = np.cross(nrm, helper)
        t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
        t2 = np.cross(nrm, t1)
        ang = rng.uniform(0, np.pi, size=(n, 1))
        t1, t2 = np.cos(ang) * t1 + np.sin(ang) * t2, np.cos(ang) * t2 - np.sin(ang) * t1
        rot = np.stack([t1, t2, nrm], axis=2)
        tang = rng.normal(np.log(0.005), 0.5, size=(n, 2))
        normal = np.min(tang, axis=1, keepdims=True) + np.log(rng.uniform(0.05, 0.2, (n, 1)))
        scales = np.concatenate([tang, normal], axis=1)
        solid = rng.uniform(size=n) < 0.82
        opacity = np.where(solid, rng.normal(4.0, 1.2, n), rng.normal(-0.5, 1.5, n))
        dc = np.clip(self.colour(pts, which) + rng.normal(scale=8.0, size=(n, 3)), 0, 255)
        rest = self.views[which] * 0.7 + rng.normal(size=(n, 3, 15)) * (
            0.3 * np.asarray(SH_BAND_SCALE)[BANDS])
        # floaters: loose, faint, isotropic blobs anywhere in the room
        fp = rng.uniform(size=(n_float, 3)) * [self.ext[0], self.h, self.ext[1]]
        frot = Rotation.random(n_float, random_state=int(rng.integers(1 << 31))).as_matrix()
        fscale = rng.normal(np.log(0.015), 0.4, size=(n_float, 1)) + rng.normal(
            0.0, 0.2, size=(n_float, 3))
        return {
            "means": np.concatenate([pts, fp]),
            "rot": np.concatenate([rot, frot]),
            "log_scales": np.concatenate([scales, fscale]),
            "opacity": np.concatenate([opacity, rng.normal(-2.0, 1.0, n_float)]),
            "dc": np.concatenate([dc, rng.uniform(60, 200, size=(n_float, 1)).repeat(3, 1)]),
            "rest": np.concatenate([rest, rng.normal(size=(n_float, 3, 15)) * 0.02]),
        }

    def cameras(self, width: int):
        """cameras.json entries: interior viewpoints looking at the walls, at
        ScanNet's colour size and focal scaled to `width`."""
        rng = self.rng
        ext, h = self.ext, self.h
        height = int(round(width * SCANNET_SIZE[1] / SCANNET_SIZE[0]))
        focal = SCANNET_FOCAL * width / SCANNET_SIZE[0]
        out = []
        for i, phi in enumerate(np.linspace(0.0, np.pi / 2, NUM_CAMERAS)):
            eye = np.array([ext[0] * (0.5 + 0.35 * np.cos(phi)), rng.uniform(1.2, 1.6),
                            ext[1] * (0.5 + 0.35 * np.sin(phi))])
            phi_t = phi + rng.uniform(-0.15, 0.15)
            target = np.array([ext[0] * (0.5 - 0.45 * np.cos(phi_t)), rng.uniform(0.3, 0.9),
                               ext[1] * (0.5 - 0.45 * np.sin(phi_t))])
            fwd = (target - eye) / np.linalg.norm(target - eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            w2c = np.stack([right, down, fwd])
            out.append({"id": i, "img_name": f"{i:05d}", "width": width, "height": height,
                        "position": eye.tolist(), "rotation": w2c.T.tolist(), "fx": focal,
                        "fy": focal})
        return out


def sh_rotation(rot: np.ndarray) -> np.ndarray:
    """(15, 15) M with c' = c @ M.T the bands 1-3 of the colour function
    c'(d) = c(rot^T d): least squares over 64 fixed directions (exact for
    band-limited functions)."""
    u = np.random.default_rng(0).normal(size=(64, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    y = sh_basis(torch.from_numpy(u)).numpy()[:, 1:]
    z = sh_basis(torch.from_numpy(u @ rot)).numpy()[:, 1:]
    return np.linalg.lstsq(y, z, rcond=None)[0]


def similarity(rng: np.random.Generator, seed: int) -> np.ndarray:
    """The easy tier's src -> ref similarity (portbench/gen/synthetic.py)."""
    m = np.eye(4)
    m[:3, :3] = rng.uniform(1.0, 2.5) * Rotation.random(
        random_state=int(seed) % (1 << 32)).as_matrix()
    m[:3, 3] = rng.normal(scale=0.5, size=3)
    return m


def moved(g: Dict[str, np.ndarray], m: np.ndarray) -> Dict[str, np.ndarray]:
    """The gaussians `g` under the similarity `m`."""
    s = np.cbrt(np.linalg.det(m[:3, :3]))
    rot = m[:3, :3] / s
    rest = g["rest"] @ sh_rotation(rot).T
    return dict(g, means=g["means"] @ m[:3, :3].T + m[:3, 3], rot=rot @ g["rot"],
                log_scales=g["log_scales"] + np.log(s), rest=rest)


def ply_columns(g: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """3DGS's point_cloud.ply vertex columns of the gaussians `g`."""
    n = g["means"].shape[0]
    quat = Rotation.from_matrix(g["rot"]).as_quat()  # x, y, z, w
    cols = {k: g["means"][:, i] for i, k in enumerate("xyz")}
    cols.update({k: np.zeros(n) for k in ("nx", "ny", "nz")})
    dc = (g["dc"] / 255.0 - 0.5) / SH_C0
    cols.update({f"f_dc_{i}": dc[:, i] for i in range(3)})
    rest = g["rest"].reshape(n, 45)
    cols.update({f"f_rest_{i}": rest[:, i] for i in range(45)})
    cols["opacity"] = g["opacity"]
    cols.update({f"scale_{i}": g["log_scales"][:, i] for i in range(3)})
    cols.update({f"rot_{i}": quat[:, (3, 0, 1, 2)[i]] for i in range(4)})
    return cols


def write_ply(path: str, cols: Dict[str, np.ndarray]) -> None:
    """A binary little-endian .ply of float32 vertex columns."""
    names = list(cols)
    n = len(cols[names[0]])
    data = np.empty(n, dtype=[(k, "<f4") for k in names])
    for k in names:
        data[k] = cols[k]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def scene_pair(seed: int, num_gaussians: int, camera_width: int = SCANNET_SIZE[0]):
    """(ref gaussians, src gaussians, cameras.json entries, the (4, 4)
    src -> ref similarity), ref in the room's frame; the cameras at
    ScanNet's colour size, or scaled to `camera_width` (the tests')."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x6753]))
    room = Room(rng)
    gt = similarity(rng, seed)
    ref = room.densify("ref", num_gaussians)
    src = moved(room.densify("src", num_gaussians), np.linalg.inv(gt))
    return ref, src, room.cameras(camera_width), gt.astype(np.float32)


def write_pair(root: str, seed: int, num_gaussians: int,
               camera_width: int = SCANNET_SIZE[0]):
    """Write a scene pair under `root` (ref/ and src/ in 3DGS's layout, ref's
    cameras.json beside its model); returns (ref ply, src ply, gt)."""
    ref, src, cams, gt = scene_pair(seed, num_gaussians, camera_width)
    paths = []
    for name, g in (("ref", ref), ("src", src)):
        d = os.path.join(root, name, "point_cloud", "iteration_30000")
        os.makedirs(d, exist_ok=True)
        paths.append(os.path.join(d, "point_cloud.ply"))
        write_ply(paths[-1], ply_columns(g))
    with open(os.path.join(root, "ref", "cameras.json"), "w") as f:
        json.dump(cams, f)
    return paths[0], paths[1], gt
