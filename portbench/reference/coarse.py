"""Plain reference of a coarse registration call (`api.coarse_register_clouds`),
written from the function's definition at the clouds' own sizes: no padding,
no capacities, no masks, brute-force searches, the two clouds of a pair
stacked into one set of rows (so that group norms span both), SVD
Procrustes in float64, RANSAC's hypotheses drawn from the call's seed by
the configuration's rule. Precision as the
configuration states it: float32 with TF32 off, KPConv's influences,
features, weighted features and weights rounded to bfloat16 with float32
sums.

The definition, level by level (configuration `gaussreg_indoor`):
- pyramid: level 0 is the input cloud; level l > 0 holds the centroids of
  level l-1's points per voxel of size init_voxel_size * 2^l, cells counted
  in float32 from the cloud's least coordinate, floor((p - min) / size),
  clipped to [0, 1023]. Searches at radius r_l = init_radius * 2^l: each
  level into itself and each coarser level into the finer one, the
  `neighbor_limits[l]` nearest within r_l (d2 <= r^2); each finer level into
  the coarser one at r_{l+1}, the min(4, limit_{l+1}) nearest.
- backbone: KPConv-FPN; influence max(0, 1 - |n - q - kp| / sigma) over the
  kernel disposition of `kernel_points`, sums over neighbours divided by the
  neighbour count, group norms over both clouds' points, LeakyReLU 0.1, a
  strided block's shortcut the neighbours' max with a missing neighbour
  counted as 0, nearest-neighbour upsampling (0 without a neighbour).
- geometric transformer over the coarsest level, superpoint matching with
  dual normalisation, patches of each node's nearest assigned points,
  Sinkhorn with a learned dustbin, local-to-global registration, similarity
  RANSAC.

The reference follows the program step by step in two places: it takes
the program's pyramid points of each level (their order too), after
checking each against its own centroids of the program's level below and
level 0 against the input (`pyramid`); and the runner also runs the
reference transformer on the program's backbone features, so that the
transformer is judged alone. Every other stage it computes itself from
its own results."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench import counts

F64 = torch.float64
BF16 = torch.bfloat16
FAR = 1e6  # a missing neighbour's coordinate: no kernel point reaches it
BAND = 1e-4  # a neighbour this close (share of r^2) to a cut is rounding's


def kernel_points(num_points: int, seed: int = 42) -> np.ndarray:
    """The model's fixed kernel disposition in the unit ball (part of the
    configuration's definition, `shared_kpconv_geometry`): first point at
    the centre, the others spread by inverse-square repulsion from a seeded
    start."""
    if num_points > 30:
        raise ValueError("kernels of more than 30 points take another disposition")
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(num_points, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.uniform(0.3, 1.0, size=(num_points, 1))
    pts[0] = 0.0
    lr = 0.01
    for _ in range(2000):
        diff = pts[:, None, :] - pts[None, :, :]
        d = np.linalg.norm(diff, axis=-1) + 1e-9
        np.fill_diagonal(d, np.inf)
        pts += lr * np.sum(diff / (d**3)[..., None], axis=1)
        pts[0] = 0.0
        norms = np.linalg.norm(pts[1:], axis=1, keepdims=True)
        pts[1:] = np.where(norms > 1.0, pts[1:] / norms, pts[1:])
        lr *= 0.999
    return pts.astype(np.float32)


# ---------------------------------------------------------------- pyramid


def centroids(points: torch.Tensor, size: float) -> torch.Tensor:
    """Voxel centroids (float64) of a cloud's points (n, 3) float32."""
    cell = torch.floor((points - points.amin(dim=0)) / torch.tensor(
        size, dtype=points.dtype, device=points.device)).clamp(0, 1023).to(torch.int64)
    key = (cell[:, 0] << 20) | (cell[:, 1] << 10) | cell[:, 2]
    _, inverse = torch.unique(key, return_inverse=True)
    m = int(inverse.max()) + 1
    sums = torch.zeros(m, 3, dtype=F64, device=points.device).index_add_(0, inverse, points.double())
    count = torch.zeros(m, dtype=F64, device=points.device).index_add_(
        0, inverse, torch.ones_like(inverse, dtype=F64))
    return sums / count[:, None]


def sq_dists(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(m, n) squared distances in float64."""
    q, s = q.double(), s.double()
    return ((q * q).sum(1)[:, None] + (s * s).sum(1)[None, :] - 2.0 * q @ s.T).clamp_min(0.0)


def level_gap(finer: torch.Tensor, coarser: torch.Tensor, size: float) -> float:
    """How far a coarser level (m, 3) lies from the centroids of its finer
    level: the largest distance to the matched centroid, inf where the
    counts differ or two points match one centroid."""
    ref = centroids(finer, size)
    if ref.shape[0] != coarser.shape[0]:
        return math.inf
    best, near = [], []
    for lo in range(0, coarser.shape[0], 2048):
        d2 = sq_dists(coarser[lo:lo + 2048], ref)
        v, i = d2.min(dim=1)
        best.append(v)
        near.append(i)
    if torch.unique(torch.cat(near)).numel() != ref.shape[0]:
        return math.inf
    return float(torch.cat(best).max().sqrt())


def pyramid(config: dict, clouds: Sequence[torch.Tensor], given=None):
    """([levels][cloud] points (n, 3) float32, gap). Without `given` the
    reference builds its own levels; with the program's ([levels][cloud]
    points, [cloud] level-0 permutation) it checks each level against the
    centroids of the program's level below (level 0: the input permuted,
    the permutation whole) and returns the program's points with the
    largest gap."""
    bb = config["backbone"]
    sizes = [bb["init_voxel_size"] * 2**lvl for lvl in range(bb["num_stages"])]
    if given is None:
        levels = [list(clouds)]
        for size in sizes[1:]:
            levels.append([centroids(p, size).float() for p in levels[-1]])
        return levels, 0.0
    levels, perms = given
    gap = 0.0
    for c, (cloud, perm) in enumerate(zip(clouds, perms)):
        whole = torch.equal(torch.sort(perm)[0], torch.arange(cloud.shape[0], device=perm.device))
        if not whole or not torch.equal(levels[0][c], cloud[perm]):
            return levels, math.inf
        for lvl in range(1, len(sizes)):
            gap = max(gap, level_gap(levels[lvl - 1][c], levels[lvl][c], sizes[lvl]))
    return levels, gap


class Search:
    """One brute-force radius search: the `limit` nearest support points
    within `radius` of each query, nearest first; `idx` (m, limit) with n
    for a missing neighbour, `d2` (m, limit + 1) the nearest squared
    distances (the one past the limit tells where the list was cut)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, radius: float, limit: int):
        self.q, self.s, self.r2, self.limit = q, s, radius * radius, limit
        n, k = s.shape[0], min(limit + 1, s.shape[0])
        vals, idx = [], []
        for lo in range(0, q.shape[0], 1024):
            v, i = torch.topk(sq_dists(q[lo:lo + 1024], s), k, dim=1, largest=False)
            vals.append(v)
            idx.append(i)
        v = torch.cat(vals) if vals else q.new_zeros((0, k), dtype=F64)
        i = torch.cat(idx) if idx else q.new_zeros((0, k), dtype=torch.int64)
        if k < limit + 1:
            v = F.pad(v, (0, limit + 1 - k), value=math.inf)
            i = F.pad(i, (0, limit + 1 - k), value=n)
        self.d2 = v
        self.idx = torch.where(v[:, :limit] <= self.r2, i[:, :limit], n)

    def valid(self) -> int:
        return int((self.idx < self.s.shape[0]).sum())

    def mismatch(self, prog: torch.Tensor) -> tuple:
        """(entries that differ, entries that differ within rounding of a
        cut, entries) between the program's lists (m, limit), n for a
        missing neighbour and -1 for a point that is not one, and this
        search's. An entry is within rounding
        when its squared distance lies within BAND * r^2 of r^2 or, in a
        list cut at the limit, of the last kept one."""
        n = self.s.shape[0]
        if prog.shape != self.idx.shape:
            return 1, 0, 1
        ours = self.idx
        p_ok, o_ok = (prog >= 0) & (prog < n), ours < n
        in_ours = ((prog[:, :, None] == ours[:, None, :]) & o_ok[:, None, :]).any(dim=2)
        in_prog = ((ours[:, :, None] == prog[:, None, :]) & p_ok[:, None, :]).any(dim=2)
        srt = torch.sort(torch.where(p_ok, prog, -1 - torch.arange(
            prog.shape[1], device=prog.device)), dim=1)[0]
        dup = (srt[:, 1:] == srt[:, :-1]).sum()
        diff_p = p_ok & ~in_ours
        diff_o = o_ok & ~in_prog
        band = BAND * self.r2
        cut = self.d2[:, self.limit - 1:self.limit]
        truncated = self.d2[:, self.limit:] <= self.r2

        def near_cut(d2):
            return ((d2 - self.r2).abs() <= band) | (truncated & ((d2 - cut).abs() <= band))

        safe = prog.clamp(0, n - 1)
        d2_p = ((self.q[:, None, :].double() - self.s[safe].double()) ** 2).sum(-1)
        amb = (diff_p & near_cut(d2_p)).sum() + (diff_o & near_cut(self.d2[:, :self.limit])).sum()
        bad = diff_p.sum() + diff_o.sum() - amb + dup + (prog < 0).sum()
        return int(bad), int(amb), int(o_ok.sum())


def searches(config: dict, levels) -> Dict[str, List[Search]]:
    """The pyramid's 13 searches for each cloud: 'self<l>', 'down<l>'
    (level l+1 into l), 'up<l>' (level l into l+1)."""
    bb, limits = config["backbone"], config["capacity"]["neighbor_limits"]
    r0 = bb["base_radius"] * bb["init_voxel_size"]
    out = {}
    for lvl in range(len(levels)):
        r = r0 * 2**lvl
        out[f"self{lvl}"] = [Search(p, p, r, limits[lvl]) for p in levels[lvl]]
        if lvl + 1 < len(levels):
            out[f"down{lvl}"] = [Search(q, s, r, limits[lvl])
                                 for q, s in zip(levels[lvl + 1], levels[lvl])]
            out[f"up{lvl}"] = [Search(q, s, 2 * r, min(4, limits[lvl + 1]))
                               for q, s in zip(levels[lvl], levels[lvl + 1])]
    return out


def stacked(lists: List[torch.Tensor], sizes: List[int]) -> torch.Tensor:
    """Both clouds' index lists into the stacked support rows; a missing
    neighbour becomes the row past the end."""
    total, out, off = sum(sizes), [], 0
    for idx, n in zip(lists, sizes):
        out.append(torch.where(idx < n, idx + off, total))
        off += n
    return torch.cat(out)


# ---------------------------------------------------------------- backbone


def dense(x, p):
    return x @ p["kernel"] + p["bias"]


def group_norm(x, p, groups: int, eps: float = 1e-5):
    n, c = x.shape
    xg = x.reshape(n, groups, c // groups)
    mean = xg.mean(dim=(0, 2), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(0, 2), keepdim=True)
    return ((xg - mean) / torch.sqrt(var + eps)).reshape(n, c) * p["scale"] + p["bias"]


def leaky(x):
    return F.leaky_relu(x, 0.1)


def unary(x, p, groups, relu=True):
    x = group_norm(dense(x, p["Dense_0"]), p["MaskedGroupNorm_0"], groups)
    return leaky(x) if relu else x


def kpconv(x, q, s, nbr, kp, sigma, p, calls=None, chunk=4096):
    """sum over neighbours n and kernel points k of
    max(0, 1 - |n - q - kp_k| / sigma) x_n W_k, over the neighbour count,
    plus the bias; bfloat16 operands, float32 sums."""
    n = s.shape[0]
    s_pad = torch.cat([s, s.new_full((1, 3), FAR)])
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    w = p["weights"].to(BF16).float()
    out = []
    for lo in range(0, q.shape[0], chunk):
        nb = nbr[lo:lo + chunk]
        rel = s_pad[nb] - q[lo:lo + chunk, None, :]
        dist = torch.linalg.vector_norm(rel[:, :, None, :] - kp, dim=-1)
        infl = torch.clamp_min(1.0 - dist / sigma, 0.0).to(BF16).float()
        feats = x_pad[nb].to(BF16).float()
        wf = torch.einsum("mhk,mhc->mkc", infl, feats).to(BF16).float()
        y = torch.einsum("mkc,kcd->md", wf, w)
        count = (nb < n).sum(dim=1).clamp_min(1)
        out.append(y / count[:, None] + p["bias"])
        if calls is not None:
            nz = infl != 0
            calls.append({"nnz": float(nz.sum()), "rows": float(nz.any(dim=2).any(dim=1).sum()),
                          "K": float(w.shape[0]), "C": float(w.shape[1]), "D": float(w.shape[2])})
    return torch.cat(out)


def residual(x, q, s, nbr, kp, sigma, p, groups, strided, calls):
    mid = p["KPConv_0"]["weights"].shape[1]
    subs = [p[k] for k in sorted(k for k in p if k.startswith("UnaryBlock_"))]
    h = unary(x, subs.pop(0), groups) if x.shape[1] != mid else x
    h = kpconv(h, q, s, nbr, kp, sigma, p["KPConv_0"], calls)
    h = leaky(group_norm(h, p["MaskedGroupNorm_0"], groups))
    h = unary(h, subs.pop(0), groups, relu=False)
    if strided:
        x = torch.cat([x, x.new_zeros((1, x.shape[1]))])[nbr].amax(dim=1)
    if subs:
        x = unary(x, subs.pop(0), groups, relu=False)
    return leaky(h + x)


def backbone(config, w, levels, srch, feats, calls=None):
    """(feats_f, feats_c): level 1's and level 4's features of the stacked
    clouds."""
    bb = config["backbone"]
    groups, k = bb["group_norm"], bb["kernel_size"]
    r0 = bb["base_radius"] * bb["init_voxel_size"]
    s0 = bb["base_sigma"] * bb["init_voxel_size"]
    pts = [torch.cat(lv) for lv in levels]
    sizes = [[p.shape[0] for p in lv] for lv in levels]
    nl = len(levels)
    own = [stacked([s.idx for s in srch[f"self{l}"]], sizes[l]) for l in range(nl)]
    down = [stacked([s.idx for s in srch[f"down{l}"]], sizes[l]) for l in range(nl - 1)]
    up = [stacked([s.idx[:, :1] for s in srch[f"up{l}"]], sizes[l + 1])[:, 0]
          for l in range(nl - 1)]
    disposition = torch.from_numpy(kernel_points(k)).to(pts[0].device)

    def geometry(p, lvl):
        if bb.get("shared_kpconv_geometry", True):
            return disposition * (r0 * 2**lvl), s0 * 2**lvl
        return p["KPConv_0"]["kernel_points"], s0 * 2**lvl

    b = w["backbone"]
    p = b["ConvBlock_0"]
    kp, sg = geometry(p, 0)
    x = kpconv(feats, pts[0], pts[0], own[0], kp, sg, p["KPConv_0"], calls)
    x = leaky(group_norm(x, p["MaskedGroupNorm_0"], groups))
    block, skips = 0, []
    for lvl in range(nl):
        for j in range(1 if lvl == 0 else 3):
            p = b[f"CheckpointResidualBlock_{block}"]
            block += 1
            if lvl > 0 and j == 0:
                kp, sg = geometry(p, lvl - 1)
                x = residual(x, pts[lvl], pts[lvl - 1], down[lvl - 1], kp, sg, p, groups, True, calls)
            else:
                kp, sg = geometry(p, lvl)
                x = residual(x, pts[lvl], pts[lvl], own[lvl], kp, sg, p, groups, False, calls)
        skips.append(x)
    feats_c = x
    for lvl, name in ((nl - 2, "UnaryBlock_0"), (nl - 3, "UnaryBlock_1"), (nl - 4, "Dense_0")):
        coarse = torch.cat([x, x.new_zeros((1, x.shape[1]))])[up[lvl]]
        x = torch.cat([coarse, skips[lvl]], dim=1)
        x = dense(x, b[name]) if name == "Dense_0" else unary(x, b[name], groups)
    return x, feats_c


# ---------------------------------------------------------------- transformer


def sinusoid(x, d: int):
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
                    * (-math.log(10000.0) / d))
    om = x[..., None] * div
    return torch.stack([torch.sin(om), torch.cos(om)], dim=-1).reshape(x.shape + (d,))


def structure_embedding(points, p, gt, chunk=64):
    """(n, n, hidden) distance and angle embedding of a cloud's nodes."""
    n, d = points.shape[0], gt["hidden_dim"]
    diff = points[None, :, :] - points[:, None, :]  # [i, j] = p_j - p_i
    dist = torch.linalg.vector_norm(diff, dim=-1)
    emb = dense(sinusoid(dist / gt["sigma_d"], d), p["proj_d"])
    k = gt["angle_k"]
    knn = torch.sort(dist.masked_fill(torch.eye(n, dtype=torch.bool, device=points.device),
                                      math.inf), dim=1, stable=True)[1][:, :k]
    refv = points[knn] - points[:, None, :]  # (n, k, 3)
    factor = 180.0 / (gt["sigma_a"] * math.pi)
    parts = []
    for lo in range(0, n, chunk):
        rv, an = refv[lo:lo + chunk], diff[lo:lo + chunk]
        sin = torch.linalg.vector_norm(torch.linalg.cross(
            rv[:, None, :, :].expand(-1, n, -1, -1), an[:, :, None, :].expand(-1, -1, k, -1),
            dim=-1), dim=-1)
        cos = torch.einsum("itc,ijc->ijt", rv, an)
        a = sinusoid(torch.atan2(sin, cos) * factor, d) @ p["proj_a_kernel"] + p["proj_a_bias"]
        parts.append(a.amax(dim=2) if gt["reduction_a"] == "max" else a.mean(dim=2))
    return emb + torch.cat(parts)


def layer_norm(x, p):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps=1e-6)


def attention_layer(x, memory, p, heads, embed=None):
    a = p["RPEMultiHeadAttention_0" if embed is not None else "MultiHeadAttention_0"]
    n, d = x.shape
    dh = d // heads
    q = dense(x, a["proj_q"]).reshape(n, heads, dh)
    k = dense(memory, a["proj_k"]).reshape(-1, heads, dh)
    v = dense(memory, a["proj_v"]).reshape(-1, heads, dh)
    scores = torch.einsum("ihc,jhc->hij", q, k)
    if embed is not None:
        pe = (embed @ a["proj_p_kernel"] + a["proj_p_bias"]).reshape(n, n, heads, dh)
        scores = scores + torch.einsum("ihc,ijhc->hij", q, pe)
    attn = torch.softmax(scores / math.sqrt(dh), dim=-1)
    h = dense(torch.einsum("hij,jhc->ihc", attn, v).reshape(n, d), p["Dense_0"])
    x = layer_norm(x + h, p["LayerNorm_0"])
    o = p["AttentionOutput_0"]
    return layer_norm(x + dense(F.relu(dense(x, o["Dense_0"])), o["Dense_1"]), o["LayerNorm_0"])


def transformer(config, w, nodes, feats):
    """Both clouds' normalised superpoint features."""
    gt, t = config["geotransformer"], w["transformer"]
    embeds = [structure_embedding(p, t["embedding"], gt) for p in nodes]
    x = [dense(f, t["in_proj"]) for f in feats]
    for j, kind in enumerate(gt["blocks"]):
        p = t["transformer"][f"layer_{j}_{kind}"]
        if kind == "self":
            x = [attention_layer(x[c], x[c], p, gt["num_heads"], embeds[c]) for c in range(2)]
        else:
            x[0] = attention_layer(x[0], x[1], p, gt["num_heads"])
            x[1] = attention_layer(x[1], x[0], p, gt["num_heads"])
    out = [dense(f, t["out_proj"]) for f in x]
    return [f / torch.sqrt((f * f).sum(dim=1, keepdim=True) + 1e-12) for f in out]


# ---------------------------------------------------------------- matching


def patches(points, nodes, size: int):
    """Each point to its nearest node; each node's patch its `size` nearest
    assigned points, nearest first: (idx (m, size), n where empty; mask)."""
    d2 = sq_dists(points, nodes)
    owner = d2.argmin(dim=1)
    own_d2 = d2.gather(1, owner[:, None])[:, 0]
    n, m = points.shape[0], nodes.shape[0]
    idx = torch.full((m, size), n, dtype=torch.int64, device=points.device)
    for j in range(m):
        members = torch.nonzero(owner == j)[:, 0]
        order = torch.sort(own_d2[members], stable=True)[1][:size]
        idx[j, :order.numel()] = members[order]
    return idx, idx < n


def superpoints(fr, fs, vr, vs, num: int):
    """The `num` best node pairs by dual-normalised feature similarity:
    (ref, src, valid)."""
    ok = vr[:, None] & vs[None, :]
    s = torch.where(ok, torch.exp(-(2.0 - 2.0 * fr @ fs.T).clamp_min(0.0)), 0.0)
    s = s / s.sum(dim=1, keepdim=True).clamp_min(1e-12) * (s / s.sum(dim=0, keepdim=True).clamp_min(1e-12))
    vals, flat = torch.sort(torch.where(ok, s, -1.0).reshape(-1), descending=True, stable=True)
    vals, flat = vals[:num], flat[:num]
    return flat // fs.shape[0], flat % fs.shape[0], vals > 0


def sinkhorn(scores, rmask, cmask, alpha, iters: int):
    """Log-domain optimal transport of (P, m, n) scores with a dustbin row
    and column of score alpha; rows and columns outside the masks carry no
    mass. Every patch pair has at least one valid row and column."""
    p, m, n = scores.shape
    z = torch.cat([torch.cat([scores, alpha.expand(p, m, 1)], 2), alpha.expand(p, 1, n + 1)], 1)
    rows = torch.cat([rmask, rmask.new_ones((p, 1))], 1)
    cols = torch.cat([cmask, cmask.new_ones((p, 1))], 1)
    z = z.masked_fill(~(rows[:, :, None] & cols[:, None, :]), -math.inf)
    mr, nc = rmask.sum(1).float(), cmask.sum(1).float()
    norm = -torch.log(mr + nc)
    log_mu = torch.cat([norm[:, None].expand(p, m), (torch.log(nc) + norm)[:, None]], 1)
    log_nu = torch.cat([norm[:, None].expand(p, n), (torch.log(mr) + norm)[:, None]], 1)
    log_mu = log_mu.masked_fill(~rows, -math.inf)
    log_nu = log_nu.masked_fill(~cols, -math.inf)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = torch.where(rows, log_mu - torch.logsumexp(z + v[:, None, :], dim=2), 0.0)
        v = torch.where(cols, log_nu - torch.logsumexp(z + u[:, :, None], dim=1), 0.0)
    return z + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def procrustes(src, ref, w, scale: bool = False, eps: float = 1e-5):
    """(..., 4, 4) float64 (similarity if `scale`) mapping src onto ref
    under weights w, by SVD."""
    src, ref, w = src.double(), ref.double(), w.double()
    w = w / (w.sum(dim=-1, keepdim=True) + eps)
    cs = (w[..., None] * src).sum(dim=-2)
    cr = (w[..., None] * ref).sum(dim=-2)
    sc, rc = src - cs[..., None, :], ref - cr[..., None, :]
    h = torch.einsum("...ni,...nj->...ij", w[..., None] * sc, rc)
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    d = torch.ones(h.shape[:-1], dtype=F64, device=h.device)
    d[..., -1] = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    rot = (v * d[..., None, :]) @ u.transpose(-1, -2)
    if scale:
        var = (w * (sc * sc).sum(dim=-1)).sum(dim=-1)
        s = torch.einsum("...ij,...ji->...", rot, h) / var.clamp_min(eps)
        rot = rot * s[..., None, None]
    t = cr - torch.einsum("...ij,...j->...i", rot, cs)
    out = torch.zeros(h.shape[:-2] + (4, 4), dtype=F64, device=h.device)
    out[..., :3, :3], out[..., :3, 3], out[..., 3, 3] = rot, t, 1.0
    return out


def transformed(points, t):
    return points.double() @ t[..., :3, :3].transpose(-1, -2) + t[..., None, :3, 3]


def local_to_global(rp, sp, rmask, smask, scores, fm, cap):
    """LGR: mutual top-k confident point pairs inside the patch pairs, the
    best `max_correspondences` of them, one Procrustes hypothesis a patch
    pair from its best `max_patch_correspondences`, the hypothesis with the
    most inliers, then re-weighted refinement. Returns (ref points, src
    points, valid, transform float64)."""
    s = torch.exp(scores)
    p, kk, _ = s.shape
    k = fm["topk"]
    row = torch.topk(s, k, dim=2).values[:, :, -1:]
    col = torch.topk(s, k, dim=1).values[:, -1:, :]
    corr = (s >= row) & (s >= col) if fm["mutual"] else (s >= row) | (s >= col)
    corr &= (s > fm["confidence_threshold"]) & rmask[:, :, None] & smask[:, None, :]
    masked = torch.where(corr, s, 0.0)
    vals, flat = torch.sort(masked.reshape(-1), descending=True, stable=True)
    vals, flat = vals[:cap["max_correspondences"]], flat[:cap["max_correspondences"]]
    pi, ri, si = flat // (kk * kk), (flat // kk) % kk, flat % kk
    ref_c, src_c, valid = rp[pi, ri], sp[pi, si], vals > 0
    weights = torch.where(valid, vals, 0.0)
    pk = min(cap["max_patch_correspondences"], kk * kk)
    pv, pf = torch.sort(masked.reshape(p, -1), dim=1, descending=True, stable=True)
    pv, pf = pv[:, :pk], pf[:, :pk]
    hyp = procrustes(torch.gather(sp, 1, (pf % kk)[..., None].expand(-1, -1, 3)),
                     torch.gather(rp, 1, (pf // kk)[..., None].expand(-1, -1, 3)), pv)
    r2 = fm["acceptance_radius"] ** 2

    def inliers(t):
        return (((ref_c.double() - transformed(src_c, t)) ** 2).sum(-1) < r2) & valid

    counts_ = torch.where(corr.sum(dim=(1, 2)) >= fm["correspondence_threshold"],
                          inliers(hyp).sum(dim=1), -1)
    cur = weights * inliers(hyp[counts_.argmax()])
    t = None
    for _ in range(fm["num_refinement_steps"]):
        t = procrustes(src_c, ref_c, cur)
        cur = weights * inliers(t)
    return ref_c, src_c, valid, t


def ransac(src, ref, valid, rs, generator, block=1024):
    """Similarity RANSAC: hypotheses from `num_points_test` correspondences
    drawn uniformly among the valid ones (an (iterations, points) block of
    integer draws from `generator`, indices into the valid ones in order), the one with the most inliers
    (residual under the distance threshold), refit on its inliers twice,
    each refit kept where it loses none. Returns (4, 4) float64."""
    ids = torch.nonzero(valid)[:, 0]
    if ids.numel() == 0:
        ids = torch.arange(valid.shape[0], device=valid.device)
    pick = ids[torch.randint(0, ids.numel(), (rs["num_iterations_test"], rs["num_points_test"]),
                             generator=generator, device=valid.device)]
    scale = rs["with_scale"]
    hyp = procrustes(src[pick], ref[pick], torch.ones(pick.shape, device=valid.device), scale)
    thr2 = rs["distance_threshold"] ** 2

    def inliers(t):
        return (((ref.double() - transformed(src, t)) ** 2).sum(-1) < thr2) & valid

    n_in = torch.cat([inliers(hyp[i:i + block]).sum(-1) for i in range(0, hyp.shape[0], block)])
    t = hyp[n_in.argmax()]
    for _ in range(2):
        keep = inliers(t)
        t2 = procrustes(src, ref, keep.double(), scale)
        if inliers(t2).sum() >= keep.sum():
            t = t2
    return t


# ---------------------------------------------------------------- the call


def forward(config: dict, w: Dict, pair, seed: int, device, given=None,
            totals: Optional[Dict] = None) -> Dict:
    """The reference's outputs of one call on `pair` (ref_points, ref_feats,
    src_points, src_feats, ...) with the call's RANSAC seed `seed`. `given`:
    the program's pyramid ([levels][cloud] points, [cloud] level-0
    permutation) to check and then follow; `totals`: add the call's counted
    work (counts.py) into it."""
    clouds = [torch.as_tensor(np.asarray(pair[i], np.float32), device=device) for i in (0, 2)]
    feats0 = [torch.as_tensor(np.asarray(pair[i], np.float32), device=device) for i in (1, 3)]
    levels, gap = pyramid(config, clouds, given)
    out = {"levels": levels, "points_gap": gap}
    if not math.isfinite(gap):
        return out
    perms = given[1] if given is not None else [torch.arange(c.shape[0], device=device) for c in clouds]
    srch = searches(config, levels)
    out["searches"] = srch
    calls = [] if totals is not None else None
    cm, mc, cap = config["coarse_matching"], config["model"], config["capacity"]
    with (counts.count_flops(totals) if totals is not None else contextlib.nullcontext()):
        feats = torch.cat([f[p] for f, p in zip(feats0, perms)])
        feats_f, feats_c = backbone(config, w, levels, srch, feats, calls)
        n1 = [p.shape[0] for p in levels[1]]
        n4 = [p.shape[0] for p in levels[-1]]
        out["feats_f"] = list(torch.split(feats_f, n1))
        out["feats_c"] = list(torch.split(feats_c, n4))
        out["coarse"] = transformer(config, w, levels[-1], out["feats_c"])
        parts = [patches(levels[1][c], levels[-1][c], mc["num_points_in_patch"]) for c in range(2)]
        node_ok = [m.any(dim=1) for _, m in parts]
        ri, si, pv = superpoints(out["coarse"][0], out["coarse"][1], node_ok[0], node_ok[1],
                                 cm["num_correspondences"])
        out["corr"] = (ri, si, pv)
        ri, si = ri[pv], si[pv]
        (ridx, rmask), (sidx, smask) = parts
        rmask, smask = rmask[ri], smask[si]
        rf = torch.cat([out["feats_f"][0], feats_f.new_zeros((1, feats_f.shape[1]))])[ridx[ri]]
        sf = torch.cat([out["feats_f"][1], feats_f.new_zeros((1, feats_f.shape[1]))])[sidx[si]]
        scores = torch.einsum("pkc,plc->pkl", rf, sf) / math.sqrt(feats_f.shape[1])
        plan = sinkhorn(scores, rmask, smask, w["ot_alpha"], mc["num_sinkhorn_iterations"])
    far = lambda p: torch.cat([p, p.new_zeros((1, 3))])  # noqa: E731
    rp, sp = far(levels[1][0])[ridx[ri]], far(levels[1][1])[sidx[si]]
    ref_c, src_c, valid, out["lgr_transform"] = local_to_global(
        rp, sp, rmask, smask, plan[:, :-1, :-1], config["fine_matching"], cap)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    out["estimated_transform"] = ransac(src_c, ref_c, valid, config["ransac"], generator)
    out["correspondences"] = (src_c, ref_c, valid, config["ransac"]["distance_threshold"])
    if totals is not None:
        valid_pts = [[p.shape[0] for p in lv] for lv in levels]
        k1 = counts.k1_counts([list(x) for x in zip(*valid_pts)], cap["neighbor_limits"],
                              sum(s.valid() for ss in srch.values() for s in ss))
        for name, c in (("k1", k1), ("k2", counts.k2_counts(calls))):
            for key, v in c.items():
                totals[f"{name}_{key}"] = totals.get(f"{name}_{key}", 0.0) + v
    return out


def _mean_rel(p, r) -> float:
    return float((p - r).abs().mean() / r.abs().mean().clamp_min(1e-30))


def _max_rel(p, r) -> float:
    return float((p - r).abs().max() / r.abs().max().clamp_min(1e-30))


def compare(prog: Dict, ref: Dict, pair) -> Dict[str, float]:
    """The numbers by which the program's outputs of one call on `pair`
    (`prog`: the keys of `forward`'s result and 'lists', {search: [cloud]
    (m, limit)}) depart from the reference's, each 0 where they agree."""
    nums = {"points_gap": ref["points_gap"]}
    if not math.isfinite(ref["points_gap"]):
        return nums
    bad = amb = total = 0
    for name, ours in ref["searches"].items():
        for c, s in enumerate(ours):
            b, a, t = s.mismatch(prog["lists"][name][c])
            bad, amb, total = bad + b, amb + a, total + t
    nums["neighbor_mismatch"] = bad / max(total, 1)
    nums["neighbor_in_rounding"] = amb / max(total, 1)
    nums["backbone_mean_rel"] = max(_mean_rel(torch.cat(prog[k]), torch.cat(ref[k]))
                                    for k in ("feats_f", "feats_c"))
    nums["backbone_rel"] = max(_max_rel(torch.cat(prog[k]), torch.cat(ref[k]))
                               for k in ("feats_f", "feats_c"))
    nums["coarse_feats_mean_rel"] = _mean_rel(torch.cat(prog["coarse"]), torch.cat(ref["coarse"]))
    if "coarse_of_program" in ref:
        # the transformer alone, on the program's own backbone features:
        # the chained number above carries the backbone's bfloat16 flips,
        # which attention spreads over a small cloud
        nums["transformer_mean_rel"] = _mean_rel(torch.cat(prog["coarse"]),
                                                 torch.cat(ref["coarse_of_program"]))

    def pairs(corr):
        r, s, v = corr
        return set(zip(r[v].tolist(), s[v].tolist()))

    cp, cr = pairs(prog["corr"]), pairs(ref["corr"])
    nums["corr_miss"] = 1.0 - len(cp & cr) / max(len(cr), 1)
    # RANSAC's answer judged by what it claims: as many of the reference's
    # correspondences within the threshold as the reference's own answer
    src_c, ref_c, valid, thr = ref["correspondences"]
    mine = prog["estimated_transform"].to(src_c.device).double()

    def inliers(t):
        return int(((((ref_c.double() - transformed(src_c, t)) ** 2).sum(-1) < thr * thr)
                     & valid).sum())

    best = inliers(ref["estimated_transform"])
    nums["transform_inlier_gap"] = (best - inliers(mine)) / max(best, 1)
    x = torch.as_tensor(np.asarray(pair[2]), dtype=F64, device=src_c.device)
    gt = torch.as_tensor(np.asarray(pair[4]), dtype=F64, device=src_c.device)
    for name, p, r in (("transform_rmse", mine, ref["estimated_transform"]),
                       ("lgr_rmse", prog["lgr_transform"].to(x.device).double(), ref["lgr_transform"]),
                       ("gt_rmse", mine, gt)):
        d = transformed(x, p) - transformed(x, r)
        nums[name] = float(torch.sqrt((d * d).sum(dim=1).mean()))
    return nums


def as_program(out: Dict) -> Dict:
    """A reference result in the program's place (the control): its own
    lists, features and transforms, judged by `compare`."""
    prog = {k: out[k] for k in ("feats_f", "feats_c", "coarse", "corr",
                                "lgr_transform", "estimated_transform")}
    prog["lists"] = {name: [s.idx for s in ss] for name, ss in out["searches"].items()}
    return prog
