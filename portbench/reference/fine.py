"""Plain reference of GaussReg's render-and-compare fine stage
(`api.register_gs_pair(fine=True)`'s refinement), written from the 3D
Gaussian Splatting definition (Kerbl et al., SIGGRAPH 2023,
arXiv:2308.04079) and GaussReg's fine stage (arXiv:2407.05254): plain
PyTorch, float32 with TF32 off, float64 where it sums a loss. It reads the
.ply and cameras.json files with parsers of its own and takes nothing the
program made.

The definition:
- a gaussian: mean mu, covariance Sigma = R S S^T R^T with R the rotation
  of the normalised quaternion (w, x, y, z) and S = diag(exp(scale_i)),
  opacity sigmoid(o), colour by real spherical harmonics of degree 3;
- a similarity (s, Q, t) moves it to mu' = s Q mu + t, Sigma' = s^2 Q Sigma
  Q^T, and its colour function c'(d) = c(Q^T d): the rotated bands are
  evaluated at the rotated direction rather than rotated themselves;
- a view (world-to-camera W, t_c, focals f, principal point c): the mean
  in the camera p = W mu' + t_c, kept when p_z > 0.2; the screen position
  f p_xy / p_z + c; the screen covariance J W Sigma' W^T J^T + 0.3 I with
  J the perspective Jacobian at (x, y) / z clamped to 1.3 times the half
  field of view; the colour max(0, SH(d) + 0.5) toward d = mu' - centre;
- a pixel centre x: alpha = min(0.99, opacity exp(-1/2 d^T Sigma'^-1 d)),
  d = x - screen mean, skipped under 1/255; the gaussians in depth (p_z)
  order composited front to back, C = sum alpha_i T_i c_i, T_{i+1} =
  T_i (1 - alpha_i), stopped before the first that would take T under
  1e-4; T is the pixel's transmittance;
- the fine loss at a similarity: the mean over the views of the L1 colour
  gap (over pixels and channels) plus 0.1 times the L1 transmittance gap
  between the moved source model's render and the reference model's;
- the pose: a log-scale, a rotation vector and a translation (7 numbers)
  applied on the left of the coarse similarity, exp(l) Exp(w) A + [t],
  the gradient by autograd.

Conventions the papers leave open, taken as the program takes them:
- the near plane 0.2 and the Jacobian's clamp at 1.3
  (gaussreg_tpu_torch/gs/rasterizer/project.py:54-93);
- a gaussian's extent is the exact alpha >= 1/255 ellipse, not 3DGS's
  3-sigma circle (project.py:107-117); the reference finds each tile's
  gaussians by that ellipse's bounding box against the tile's pixel
  centres, its own test, not the program's binning;
- images of 640 or fewer pixels a side: a cameras.json view scaled by
  640 / max(width, height), its size rounded, the principal point at the
  centre, 4 views spread evenly through the list (gs/cameras.py:54-84);
- the model cut to the 200 000 gaussians of highest sigmoid opacity, by
  numpy's argsort of the negated float32 opacities
  (gs/fine_registration.py `to_device_gaussians`);
- the pixels are evaluated in 32x32 tiles from the image's corner (the
  program's tile grid, render.py `render`), which the work counts use.
The program's tile rasterizer stops a tile after a 128-pair chunk once
every pixel's T is under 1e-4 and culls gaussians behind a tile's
saturation depth; both differ from the per-pixel stop by less than 1e-4
of a pixel's colour."""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
NEAR = 0.2
BLUR = 0.3
CLAMP = 1.3
TILE = 32
F64 = torch.float64

# real spherical harmonics up to degree 3 (3DGS's sh_utils constants)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Gaussians(NamedTuple):
    means: torch.Tensor  # (G, 3)
    cov: torch.Tensor  # (G, 3, 3)
    opacity: torch.Tensor  # (G,)
    sh: torch.Tensor  # (G, 3, 16)


class View(NamedTuple):
    w2c: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Render(NamedTuple):
    rgb: torch.Tensor  # (H, W, 3)
    transmittance: torch.Tensor  # (H, W)
    counts: Dict[str, float]  # the pixel-gaussian work (`pixel_pairs` ...)


_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
              "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """The vertex columns of a binary little-endian .ply (3DGS's layout)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        if header[0] != "ply" or "format binary_little_endian 1.0" not in header:
            raise ValueError(f"{path}: not a binary little-endian ply")
        count, props, in_vertex = 0, [], False
        for line in header:
            words = line.split()
            if words[:2] == ["element", "vertex"]:
                count, in_vertex = int(words[2]), True
            elif words[:1] == ["element"]:
                in_vertex = False
            elif words[:1] == ["property"] and in_vertex:
                props.append((words[2], _PLY_TYPES[words[1]]))
        data = np.frombuffer(f.read(count * np.dtype(props).itemsize), dtype=props,
                             count=count)
    return {name: data[name] for name, _ in props}


def _sigmoid_f32(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def load_model(path: str, cap: Optional[int], device) -> Gaussians:
    """A 3DGS .ply as activated tensors, cut to the `cap` gaussians of
    highest opacity."""
    v = read_ply(path)
    opacity = _sigmoid_f32(v["opacity"].astype(np.float32))
    keep = np.arange(opacity.shape[0])
    if cap is not None and opacity.shape[0] > cap:
        keep = np.argsort(-opacity)[:cap]

    def cols(prefix, n):
        return np.stack([v[f"{prefix}{i}"][keep] for i in range(n)], axis=1).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    xyz = np.stack([v["x"][keep], v["y"][keep], v["z"][keep]], axis=1).astype(np.float32)
    sh = np.concatenate([cols("f_dc_", 3)[:, :, None],
                         cols("f_rest_", 45).reshape(-1, 3, 15)], axis=2)
    quats = t(cols("rot_", 4))
    quats = quats / torch.linalg.norm(quats, dim=1, keepdim=True)
    rot = quaternion_matrix(quats)
    m = rot * torch.exp(t(cols("scale_", 3)))[:, None, :]
    return Gaussians(t(xyz), m @ m.transpose(1, 2), t(opacity[keep]), t(sh))


def quaternion_matrix(q: torch.Tensor) -> torch.Tensor:
    """(G, 3, 3) rotations of unit quaternions (w, x, y, z)."""
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(-1, 3, 3)


def read_cameras(path: str, views: int, max_size: int, device) -> List[View]:
    """`views` entries of a 3DGS cameras.json (spread evenly through the
    list), each scaled so that its larger side is at most `max_size`."""
    with open(path) as f:
        entries = json.load(f)
    if len(entries) > views:
        entries = [entries[i] for i in np.linspace(0, len(entries) - 1, views).round().astype(int)]
    out = []
    for e in entries:
        scale = min(1.0, max_size / max(e["width"], e["height"]))
        c2w = torch.tensor(e["rotation"], dtype=torch.float32, device=device)
        w2c = c2w.T.contiguous()
        width, height = int(round(e["width"] * scale)), int(round(e["height"] * scale))
        out.append(View(w2c, -w2c @ torch.tensor(e["position"], dtype=torch.float32,
                                                 device=device),
                        float(e["fx"]) * scale, float(e["fy"]) * scale,
                        width / 2.0, height / 2.0, width, height))
    return out


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(N, 16) real spherical harmonics of degree <= 3 at unit directions."""
    x, y, z = d.unbind(1)
    xx, yy, zz = x * x, y * y, z * z
    one = torch.ones_like(x)
    return torch.stack([
        SH_C0 * one,
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ], dim=1)


def rotation_vector(w: torch.Tensor) -> torch.Tensor:
    """Exp of a rotation vector (Rodrigues), differentiable at 0."""
    th2 = torch.sum(w * w)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6 + th2 * th2 / 120, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24 + th2 * th2 / 720, (1 - torch.cos(th)) / (th * th))
    zero = torch.zeros_like(w[0])
    k = torch.stack([zero, -w[2], w[1], w[2], zero, -w[0], -w[1], w[0], zero]).reshape(3, 3)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * k + b * (k @ k)


def pose(coarse: torch.Tensor, params: Optional[torch.Tensor] = None):
    """(scale, rotation, translation) of exp(l) Exp(w) A + [t] for the
    7 numbers params = (l, w, t) (zero if None) and the coarse (4, 4)
    similarity A."""
    if params is None:
        params = torch.zeros(7, dtype=coarse.dtype, device=coarse.device)
    delta = torch.exp(params[0]) * rotation_vector(params[1:4])
    a = delta @ coarse[:3, :3]
    t = delta @ coarse[:3, 3] + params[4:7]
    s = torch.linalg.det(a) ** (1.0 / 3.0)
    return s, a / s, t


def project(g: Gaussians, view: View, sim=None):
    """Screen means, conics, colours, depths, opacities and the alpha >= 1/255
    half extents of `g` moved by the similarity `sim` = (s, Q, t)."""
    means, cov, q_rot = g.means, g.cov, None
    if sim is not None:
        s, q_rot, t = sim
        means = s * means @ q_rot.T + t
        cov = (s * s) * q_rot @ cov @ q_rot.T
    p = means @ view.w2c.T + view.t
    z = p[:, 2]
    keep = (z > NEAR) & (g.opacity >= ALPHA_MIN)
    zc = torch.where(keep, z, torch.ones_like(z))
    x, y = p[:, 0] / zc, p[:, 1] / zc
    mean2d = torch.stack([view.fx * x + view.cx, view.fy * y + view.cy], dim=1)
    lx, ly = CLAMP * view.cx / view.fx, CLAMP * view.cy / view.fy
    xc, yc = torch.clamp(x, -lx, lx), torch.clamp(y, -ly, ly)
    zero = torch.zeros_like(z)
    jac = torch.stack([view.fx / zc, zero, -view.fx * xc / zc,
                       zero, view.fy / zc, -view.fy * yc / zc], dim=1).reshape(-1, 2, 3)
    jw = jac @ view.w2c
    cov2 = jw @ cov @ jw.transpose(1, 2) + BLUR * torch.eye(2, device=z.device)
    a, b, c = cov2[:, 0, 0], cov2[:, 0, 1], cov2[:, 1, 1]
    det = a * c - b * b
    keep = keep & (det > 0)
    det = torch.where(keep, det, torch.ones_like(det))
    conic = torch.stack([c / det, -b / det, a / det], dim=1)
    centre = -view.w2c.T @ view.t
    d = means - centre
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    if q_rot is not None:
        d = d @ q_rot  # Q^T d, row-wise
    colour = torch.clamp_min(torch.einsum("gck,gk->gc", g.sh, sh_basis(d)) + 0.5, 0.0)
    rho2 = 2.0 * torch.log(torch.clamp_min(255.0 * g.opacity, 1.0))
    ext = torch.sqrt(torch.clamp_min(rho2[:, None] * torch.stack([a, c], dim=1), 0.0))
    return dict(mean2d=mean2d, conic=conic, colour=colour, depth=z, opacity=g.opacity,
                ext=ext.detach(), keep=keep)


def _tiles(view: View):
    for y0 in range(0, view.height, TILE):
        for x0 in range(0, view.width, TILE):
            yield x0, y0, min(x0 + TILE, view.width), min(y0 + TILE, view.height)


def composite_tile(proj, idx: torch.Tensor, x0, y0, x1, y1, counts=None):
    """(rgb (h, w, 3), T (h, w)) of the gaussians `idx` (depth-ordered) at
    the tile's pixel centres."""
    dev = proj["mean2d"].device
    ys = torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    h, w = py.shape
    if idx.numel() == 0:
        return (torch.zeros((h, w, 3), device=dev), torch.ones((h, w), device=dev))
    m = proj["mean2d"][idx]
    con = proj["conic"][idx]
    dx = px.reshape(1, -1) - m[:, :1]
    dy = py.reshape(1, -1) - m[:, 1:]
    q = con[:, :1] * dx * dx + 2.0 * con[:, 1:2] * dx * dy + con[:, 2:] * dy * dy
    alpha = torch.clamp_max(proj["opacity"][idx, None] * torch.exp(-0.5 * q), ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    after = torch.cumprod(1.0 - alpha, dim=0)  # T after each gaussian
    before = torch.cat([torch.ones_like(after[:1]), after[:-1]], dim=0)
    used = (after >= T_STOP) & (alpha > 0)
    weight = torch.where(used, alpha * before, torch.zeros_like(alpha))
    rgb = weight.T @ proj["colour"][idx]
    trans = torch.prod(torch.where(used, 1.0 - alpha, torch.ones_like(alpha)), dim=0)
    if counts is not None:
        with torch.no_grad():
            hit = used.any(dim=1)
            counts["pixel_pairs"] += float(used.sum())
            counts["tile_pairs"] += float(hit.sum())
            counts["hit"][idx[hit]] = True
    return rgb.reshape(h, w, 3), trans.reshape(h, w)


def tile_members(proj, x0, y0, x1, y1) -> torch.Tensor:
    """The gaussians whose alpha >= 1/255 ellipse's box reaches a pixel
    centre of the tile, in depth order (ties by index)."""
    m, ext = proj["mean2d"].detach(), proj["ext"]
    hit = (proj["keep"]
           & (m[:, 0] + ext[:, 0] >= x0 + 0.5) & (m[:, 0] - ext[:, 0] <= x1 - 0.5)
           & (m[:, 1] + ext[:, 1] >= y0 + 0.5) & (m[:, 1] - ext[:, 1] <= y1 - 0.5))
    idx = torch.nonzero(hit)[:, 0]
    order = torch.sort(proj["depth"].detach()[idx], stable=True).indices
    return idx[order]


def render(g: Gaussians, view: View, sim=None, targets=None, count: bool = False,
           cotangent=None):
    """The view's render of `g` moved by `sim`, and with `targets` (rgb, T)
    its term of the fine loss (float64), or with `cotangent` (c_rgb, c_T)
    the linear term sum(c_rgb rgb) + sum(c_T T). With either the render is
    also differentiated tile by tile: each tile's share of the term is
    back-propagated into leaf copies of the projection's screen means,
    conics and colours (`leaves`, whose .grad then holds the term's
    gradient). Returns {"render": Render, "loss", "leaves"}."""
    with torch.no_grad():
        proj = project(g, view, sim)
    leaves = {}
    grad = targets is not None or cotangent is not None
    if grad:
        leaves = {k: proj[k].requires_grad_(True) for k in ("mean2d", "conic", "colour")}
    counts = None
    if count:
        counts = {"pixel_pairs": 0.0, "tile_pairs": 0.0,
                  "hit": torch.zeros(g.means.shape[0], dtype=torch.bool, device=g.means.device)}
    rgb = torch.zeros((view.height, view.width, 3), device=g.means.device)
    trans = torch.ones((view.height, view.width), device=g.means.device)
    loss = torch.zeros((), dtype=F64, device=g.means.device)
    npx = view.height * view.width
    for x0, y0, x1, y1 in _tiles(view):
        idx = tile_members(proj, x0, y0, x1, y1)
        with torch.set_grad_enabled(grad):
            c, t = composite_tile(proj, idx, x0, y0, x1, y1, counts)
            if grad:
                if cotangent is not None:
                    term = (torch.sum(cotangent[0][y0:y1, x0:x1] * c.to(F64))
                            + torch.sum(cotangent[1][y0:y1, x0:x1] * t.to(F64)))
                else:
                    term = (torch.sum(torch.abs(c - targets[0][y0:y1, x0:x1]).to(F64))
                            / (3 * npx) + 0.1 * torch.sum(
                                torch.abs(t - targets[1][y0:y1, x0:x1]).to(F64)) / npx)
                if term.requires_grad:
                    term.backward()
                loss = loss + term.detach()
        rgb[y0:y1, x0:x1] = c.detach()
        trans[y0:y1, x0:x1] = t.detach()
    if counts is not None:
        counts["gaussians"] = float(counts.pop("hit").sum())
        counts["pixels"] = float(npx)
    return {"render": Render(rgb, trans, counts or {}), "loss": loss, "leaves": leaves}


def l1_cotangents(renders: Sequence[Render], targets):
    """Per view (c_rgb, c_T), float64: the gradient of the view's term of the
    fine loss in its render (the sign of the gap to the target over the
    view's pixels and channels; the transmittance's weighted 0.1), so that
    the term's pose gradient is that of sum(c_rgb rgb) + sum(c_T T)."""
    out = []
    for r, (t_rgb, t_t) in zip(renders, targets):
        npx = r.transmittance.numel()
        out.append((torch.sign(r.rgb - t_rgb).to(F64) / (3 * npx),
                    0.1 * torch.sign(r.transmittance - t_t).to(F64) / npx))
    return out


def fine_loss(src: Gaussians, views: Sequence[View], targets, coarse,
              params=None, grad: bool = False, count: bool = False, cotangents=None):
    """The fine loss of `src` at exp(l) Exp(w) coarse + [t] (params = the 7
    numbers (l, w, t), zero if None) against the target renders [(rgb, T)],
    its gradient in the 7 numbers (with `grad`), and the views' renders.
    With `cotangents` ([(c_rgb, c_T)] per view) the gradient is that of the
    linear term sum(c_rgb rgb) + sum(c_T T) instead (the loss's own, when
    they are `l1_cotangents` of this pose's renders).
    Returns (loss float, gradient (7,) float64 numpy or None, [Render])."""
    dev = src.means.device
    coarse = torch.as_tensor(np.asarray(coarse), dtype=torch.float32, device=dev)
    p = torch.zeros(7, dtype=torch.float32, device=dev) if params is None \
        else torch.as_tensor(np.asarray(params), dtype=torch.float32, device=dev)
    total, renders = 0.0, []
    grads = torch.zeros(7, dtype=F64, device=dev)
    for i, (view, target) in enumerate(zip(views, targets)):
        cot = None if cotangents is None else cotangents[i]
        out = render(src, view, pose(coarse, p), target if grad and cot is None else None,
                     count, cot if grad else None)
        if grad:
            leaves = out["leaves"]
            q = p.clone().requires_grad_(True)
            proj = project(src, view, pose(coarse, q))
            (g,) = torch.autograd.grad(
                [proj[k] for k in leaves], [q],
                [v.grad if v.grad is not None else torch.zeros_like(v)
                 for v in leaves.values()])
            grads += g.to(F64)
        if grad and cot is None:
            loss = out["loss"]
        else:
            r = out["render"]
            loss = (torch.mean(torch.abs(r.rgb - target[0]).to(F64))
                    + 0.1 * torch.mean(torch.abs(r.transmittance - target[1]).to(F64)))
        total += float(loss)
        renders.append(out["render"])
    n = len(views)
    return total / n, (grads / n).cpu().numpy() if grad else None, renders
