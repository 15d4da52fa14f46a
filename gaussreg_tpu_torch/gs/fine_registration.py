"""Fine registration: render-and-compare pose refinement through the
differentiable rasterizer (port of gaussreg_tpu/gs/fine_registration.py).

Optimize a similarity delta (log-scale, so(3) rotation, translation)
applied on top of the coarse transform so that renders of the transformed
source GS model match renders of the reference model from shared
viewpoints. Gradients flow through the rasterizer's autograd.Function
(CUDA kernels on CUDA tensors). The JAX package runs each segment as one
compiled scan; here a segment is a Python loop of eager steps. Capacities
are read from device counters between segments (`int(...)`, a host sync
each); inside a segment nothing is read back. After a segment one read
tells whether any of its renders breached a capacity, or whether the
per-gaussian tile cap dropped more than its bound; such a segment is run
again from its saved pose and Adam state uncapped (and at more tiles a
gaussian), so no step's loss or gradient comes from a render that dropped
pairs at a capacity.

Spans (engine/debug.annotate): `fine_call` around a call, `fine.targets`,
`fine.probe` (each probe), `fine.step` with `fine.step.forward`,
`fine.step.backward` and `fine.step.adam`, and `fine.check` (the read after
a segment). Counters, read with the kernels' launches
(`ops._cuda.launch_counts()`): `fine.steps` (redone ones included),
`fine.probes`, `fine.segments_redone`,
`fine.cap_pairs_dropped` (pairs the segments' renders dropped at a
capacity, redone segments' included), `fine.tile_pairs_dropped` (pairs
the per-gaussian tile cap dropped in the accepted steps' renders) and
`fine.pairs` (the pairs those renders binned).
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.gs import sh as sh_mod
from gaussreg_tpu_torch.gs.ply import GaussianModel
from gaussreg_tpu_torch.gs.rasterizer.camera import Camera, look_at_camera
from gaussreg_tpu_torch.gs.rasterizer.render import render
from gaussreg_tpu_torch.ops import _cuda
from gaussreg_tpu_torch.ops.transforms import (
    exp_so3,
    matrix_to_quaternion,
    quaternion_multiply,
    transform_from_rotation_translation,
)

STEPS = _cuda.counter("fine.steps")
PROBES = _cuda.counter("fine.probes")
REDONE = _cuda.counter("fine.segments_redone")
CAP_DROPPED = _cuda.counter("fine.cap_pairs_dropped")
TILE_DROPPED = _cuda.counter("fine.tile_pairs_dropped")
PAIRS = _cuda.counter("fine.pairs")
# a segment runs at most this often: at the probe's capacities, then uncapped
SEGMENT_ATTEMPTS = 2
# the share of pairs the adaptive tile cap may drop: the probe picks the
# smallest of MT_CANDIDATES (max_tiles_per_gaussian) under it, and a segment
# is held to it too. Candidates past 16 serve views with gaussians near the
# camera (the JAX package stops at 16)
TILE_DROP_SHARE = 1e-3
MT_CANDIDATES = (4, 8, 16, 32, 64, 128)


class GaussiansDevice(NamedTuple):
    """Device-side gaussian tensors (activated: linear scales, sigmoid
    opacity)."""

    means: torch.Tensor  # (G, 3)
    scales: torch.Tensor  # (G, 3) linear
    quats: torch.Tensor  # (G, 4)
    opacities: torch.Tensor  # (G,)
    sh_coeffs: torch.Tensor  # (G, 3, 16)
    valid: torch.Tensor  # (G,) bool


def gaussians_from_numpy(
    means, scales, quats, opacities, sh_coeffs, valid=None, device: DeviceLike = None
) -> GaussiansDevice:
    """Build a GaussiansDevice from numpy arrays (the fields of the JAX
    package's GaussiansDevice, same order and activation) on `device`."""
    dev = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    n = np.asarray(means).shape[0]
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    return GaussiansDevice(
        means=f(means), scales=f(scales), quats=f(quats), opacities=f(opacities),
        sh_coeffs=f(sh_coeffs), valid=torch.as_tensor(valid, device=dev),
    )


def to_device_gaussians(
    g: GaussianModel, max_gaussians: Optional[int] = None, device: DeviceLike = None
) -> GaussiansDevice:
    """Activate + pad a host GaussianModel for rendering. Keeps the
    highest-opacity gaussians when over the cap."""
    opac = 1.0 / (1.0 + np.exp(-g.opacity[:, 0]))
    n = g.num_gaussians
    if max_gaussians is not None and n > max_gaussians:
        keep = np.argsort(-opac)[:max_gaussians]
    else:
        keep = np.arange(n)
    cap = max_gaussians or n
    pad = cap - keep.shape[0]

    def f(x):
        x = x[keep]
        return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    # padding rows take the identity quaternion: a zero quaternion has no
    # rotation matrix (0 / 0), and although the row is culled its NaN would
    # reach the pose gradient as 0 * NaN
    quats = f(g.rots)
    quats[len(keep):, 0] = 1.0
    return gaussians_from_numpy(
        means=f(g.xyz),
        scales=np.exp(f(g.scales)),
        quats=quats,
        opacities=np.concatenate([opac[keep], np.zeros(pad)]),
        sh_coeffs=f(np.concatenate([g.f_dc, g.f_rest], axis=2)),
        valid=np.concatenate([np.ones(len(keep), bool), np.zeros(pad, bool)]),
        device=device,
    )


def transform_gaussians_device(
    g: GaussiansDevice, transform: torch.Tensor
) -> GaussiansDevice:
    """Differentiable similarity transform of device gaussians."""
    a = transform[:3, :3]
    t = transform[:3, 3]
    scale = torch.sqrt(torch.sum(a[0] * a[0]))
    r = a / scale
    means = g.means @ a.T + t
    scales = g.scales * scale
    rq = matrix_to_quaternion(r)
    quats = quaternion_multiply(rq[None, :], g.quats)
    f_dc = g.sh_coeffs[:, :, :1]
    f_rest = sh_mod.rotate_sh_rest(g.sh_coeffs[:, :, 1:], r)
    return g._replace(
        means=means,
        scales=scales,
        quats=quats,
        sh_coeffs=torch.cat([f_dc, f_rest], dim=2),
    )


def default_cameras(
    points: np.ndarray, num_views: int = 4, width: int = 640, height: int = 480
) -> List[Camera]:
    """Synthetic orbit viewpoints around a cloud's bbox (used when no real
    cameras.json poses are supplied)."""
    points = np.asarray(points)
    center = points.mean(0)
    extent = float(np.linalg.norm(points.max(0) - points.min(0)))
    cams = []
    for i in range(num_views):
        angle = 2 * np.pi * i / num_views
        eye = center + extent * np.array([np.cos(angle), 0.35, np.sin(angle)])
        cams.append(
            look_at_camera(eye, center, [0, 1, 0], fov_deg=60, width=width, height=height)
        )
    return cams


def _delta_transform(params):
    s = torch.exp(params["log_s"])
    r = exp_so3(params["omega"])
    return transform_from_rotation_translation(s * r, params["t"])


class FineRegistrationResult(NamedTuple):
    transform: torch.Tensor  # refined (4, 4) similarity src -> ref
    losses: torch.Tensor  # (steps,) photometric loss trace
    overflow: torch.Tensor  # () int32 pairs dropped by the capacities across
    # the accepted segments' steps and views (0: no loss saw a dropped pair)


def _quant_up(x, q: int) -> int:
    return ((int(x) + q - 1) // q) * q


class _Caps(NamedTuple):
    mt: int
    bwd_cap: Optional[int]
    live_cap: Optional[int]
    pair_cap: Optional[int]
    sat_depths: Optional[List[torch.Tensor]]


def _probe_caps(
    src: GaussiansDevice, transform, cameras: Sequence[Camera],
    mt_candidates: Sequence[int], sat_cull: bool, dense_reference: bool,
) -> _Caps:
    """Two-probe capacity protocol at the given pose; also picks
    max_tiles_per_gaussian from the probe's own overflow counters."""
    PROBES.launches += 1
    with annotate("fine.probe"), torch.no_grad():
        moved = transform_gaussians_device(src, transform)

        def rend(cam, mt, sat_depth=None):
            return render(
                moved.means, moved.scales, moved.quats, moved.opacities,
                moved.sh_coeffs, cam, valid=moved.valid,
                dense_reference=dense_reference,
                max_tiles_per_gaussian=mt, sat_depth=sat_depth,
            )

        # the smallest candidate whose renders drop under TILE_DROP_SHARE of
        # their pairs, else the largest
        for mt in mt_candidates:
            probes1 = [rend(cam, mt) for cam in cameras]
            if mt == mt_candidates[-1]:
                break
            worst = 0.0
            for p in probes1:
                dropped = float(p.overflow)
                worst = max(worst, dropped / max(dropped + float(p.num_pairs), 1.0))
            if worst < TILE_DROP_SHARE:
                break
        bwd_cap = _quant_up(max(int(p.sat_blocks) for p in probes1) * 1.25 + 64, 256)
        live_cap = pair_cap = sat_depths = None
        if sat_cull:
            probes2 = [
                rend(cam, mt, sat_depth=p1.sat_depth) for cam, p1 in zip(cameras, probes1)
            ]
            live_cap = _quant_up(max(int(p.num_live) for p in probes2) * 1.25, 1024)
            live_cap = min(live_cap, src.means.shape[0])
            pair_cap = _quant_up(
                (max(int(p.num_pairs) for p in probes2) * 1.30) / 128 + 8, 64
            )
            sat_depths = [p1.sat_depth for p1 in probes1]
    return _Caps(mt, bwd_cap, live_cap, pair_cap, sat_depths)


def _render_targets(ref: GaussiansDevice, cameras: Sequence[Camera],
                    mt_candidates: Sequence[int], dense_reference: bool):
    """The reference model's renders of the views, each at the smallest
    max_tiles_per_gaussian of 16 and the larger candidates whose render
    drops under TILE_DROP_SHARE of its pairs (else the largest): a target
    that drops the pairs of gaussians near the camera would be compared
    with renders that keep them."""
    targets = []
    with annotate("fine.targets"), torch.no_grad():
        for cam in cameras:
            for mt in [m for m in mt_candidates if m >= 16] or [mt_candidates[-1]]:
                out = render(
                    ref.means, ref.scales, ref.quats, ref.opacities, ref.sh_coeffs,
                    cam, valid=ref.valid, dense_reference=dense_reference,
                    max_tiles_per_gaussian=mt,
                )
                dropped = float(out.overflow)
                if mt == mt_candidates[-1] or dropped < TILE_DROP_SHARE * max(
                        dropped + float(out.num_pairs), 1.0):
                    break
            targets.append(out)
    return targets


def fine_register(
    ref: GaussiansDevice,
    src: GaussiansDevice,
    init_transform,
    cameras: List[Camera],
    num_steps: int = 100,
    lr: float = 3e-3,
    dense_reference: bool = False,
    sat_cull: bool = True,
    reprobe_every: int = 30,
    adaptive_mt: bool = True,
) -> FineRegistrationResult:
    """Refine `init_transform` (src -> ref) by photometric render matching,
    on the device the gaussians live on.

    With `sat_cull` (default), every optimization step culls gaussians
    behind the per-tile saturation depth reported by the PREVIOUS step's
    render of the same view (render.py): the sat_depth tensors are carried
    from step to step, so the cull margin only has to cover one Adam step
    of pose drift, and the pair sort, the gathers and the backward all run
    at the probe-sized culled capacities.

    - `reprobe_every`: the trajectory runs in SEGMENTS of this many steps;
      capacities are re-probed from the CURRENT pose between segments
      (fixed step-0 caps are breached as the pose drifts). Caps are
      quantized upward (256/1024/64-block buckets). The probe sees only
      the segment's first pose, and later steps may need more: after each
      segment one read of its renders' counters shows whether any dropped
      pairs at the live or pair capacity or walked past the backward's
      buffer. Such a segment is run again from the pose, Adam state and
      saturation depths it started from, uncapped: the pair list and the
      backward's buffer at their worst case and no live cap, where no
      capacity can drop anything. So is a segment whose
      renders the tile cap dropped more than TILE_DROP_SHARE of the pairs
      of (the probe's bound, which drift can pass), at the next larger
      max_tiles_per_gaussian. A segment without a breach runs once, at the
      probe's capacities, as before.
    - `adaptive_mt`: subpixel-dominated scenes have median bboxes of ~1
      tile; a probe measures the pair overflow at
      max_tiles_per_gaussian in MT_CANDIDATES and picks the smallest whose
      dropped-pair fraction is < 1e-3 (those pairs are counted in each
      render's `overflow` and the counter `fine.tile_pairs_dropped`, not in
      the result's).
    - `dense_reference`: render with the dense reference renderer (tiny
      scenes only).

    `overflow` in the result counts the pairs that the accepted segments'
    renders dropped at a capacity: 0, as a breached segment is redone and
    its uncapped attempt has no capacity to drop pairs at.
    """
    with annotate("fine_call"):
        return _fine_register(ref, src, init_transform, cameras, num_steps, lr,
                              dense_reference, sat_cull, reprobe_every, adaptive_mt)


def _fine_register(ref, src, init_transform, cameras, num_steps, lr, dense_reference,
                   sat_cull, reprobe_every, adaptive_mt) -> FineRegistrationResult:
    dev = src.means.device
    init_transform = torch.as_tensor(init_transform, dtype=torch.float32, device=dev)

    mt_candidates = MT_CANDIDATES if adaptive_mt else (16,)
    targets = _render_targets(ref, cameras, mt_candidates, dense_reference)
    target_arrays = [(t.rgb, t.transmittance) for t in targets]

    params = {
        "log_s": torch.zeros((), device=dev, requires_grad=True),
        "omega": torch.zeros(3, device=dev, requires_grad=True),
        "t": torch.zeros(3, device=dev, requires_grad=True),
    }
    # torch.optim.Adam with eps=1e-8 is optax.adam's update:
    # m_hat / (sqrt(v_hat) + eps)
    optimizer = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8)

    def photometric_loss(caps: _Caps, sat_depths):
        """The loss at the current pose, the renders' saturation depths,
        and per render (overflow_cap, overflow, num_pairs, sat_blocks),
        stacked (views, 4) int32."""
        transform = _delta_transform(params) @ init_transform
        moved = transform_gaussians_device(src, transform)
        loss = 0.0
        new_sat, stats = [], []
        for i, cam in enumerate(cameras):
            out = render(
                moved.means, moved.scales, moved.quats, moved.opacities,
                moved.sh_coeffs, cam, valid=moved.valid,
                dense_reference=dense_reference,
                max_tiles_per_gaussian=caps.mt,
                bwd_capacity_blocks=caps.bwd_cap,
                sat_depth=None if sat_depths is None else sat_depths[i],
                live_gaussian_cap=caps.live_cap,
                pair_capacity_blocks=caps.pair_cap,
                sat_margin=1.10,
            )
            t_rgb, t_tr = target_arrays[i]
            # L1 on colour; the transmittance term keeps coverage aligned
            loss = loss + torch.mean(torch.abs(out.rgb - t_rgb))
            loss = loss + 0.1 * torch.mean(torch.abs(out.transmittance - t_tr))
            stats.append(torch.stack([out.overflow_cap, out.overflow, out.num_pairs,
                                      out.sat_blocks]).to(torch.int32))
            new_sat.append(out.sat_depth.detach())
        return loss / len(cameras), new_sat, torch.stack(stats)

    def run_segment(caps: _Caps, steps: int):
        """`steps` steps at `caps`; returns their losses, the summed
        (overflow_cap, overflow, num_pairs) and the largest sat_blocks over
        their renders, on the device."""
        sat_depths = caps.sat_depths
        losses = []
        sums = torch.zeros(3, dtype=torch.int64, device=dev)
        max_sat = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(steps):
            STEPS.launches += 1
            with annotate("fine.step"):
                optimizer.zero_grad(set_to_none=True)
                with annotate("fine.step.forward"):
                    loss, new_sat, stats = photometric_loss(caps, sat_depths)
                with annotate("fine.step.backward"):
                    loss.backward()
                with annotate("fine.step.adam"):
                    optimizer.step()
                if sat_depths is not None:
                    sat_depths = new_sat
                losses.append(loss.detach())
                sums = sums + stats[:, :3].sum(dim=0)
                max_sat = torch.maximum(max_sat, stats[:, 3].amax())
        return losses, sums, max_sat

    losses = []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    done = 0
    reprobe_every = max(1, int(reprobe_every))
    while done < num_steps:
        seg = min(reprobe_every, num_steps - done)
        with torch.no_grad():
            current = _delta_transform(params) @ init_transform
        caps = _probe_caps(src, current, cameras, mt_candidates, sat_cull, dense_reference)
        start = ({k: p.detach().clone() for k, p in params.items()},
                 copy.deepcopy(optimizer.state_dict()))
        for attempt in range(SEGMENT_ATTEMPTS):
            seg_losses, sums, max_sat = run_segment(caps, seg)
            with annotate("fine.check"):
                cap_dropped, tile_dropped, pairs, max_sat = (
                    torch.cat([sums, max_sat.to(torch.int64).reshape(1)]).tolist())
            CAP_DROPPED.launches += cap_dropped
            bwd_breach = caps.bwd_cap is not None and max_sat > caps.bwd_cap
            wider = [m for m in mt_candidates if m > caps.mt]
            tile_breach = bool(wider) and tile_dropped > TILE_DROP_SHARE * (tile_dropped
                                                                            + pairs)
            if attempt == SEGMENT_ATTEMPTS - 1 or not (cap_dropped or bwd_breach
                                                       or tile_breach):
                break
            REDONE.launches += 1
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[0][k])
            optimizer.load_state_dict(copy.deepcopy(start[1]))
            caps = caps._replace(mt=wider[0] if tile_breach else caps.mt, bwd_cap=None,
                                 live_cap=None, pair_cap=None)
        TILE_DROPPED.launches += tile_dropped
        PAIRS.launches += pairs
        losses += seg_losses
        overflow = overflow + cap_dropped
        done += seg

    with torch.no_grad():
        transform = _delta_transform(params) @ init_transform
    return FineRegistrationResult(
        transform=transform,
        losses=torch.stack(losses) if losses else torch.zeros(0, device=dev),
        overflow=overflow,
    )
