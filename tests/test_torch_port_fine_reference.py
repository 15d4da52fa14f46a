"""The port's fine stage (gs/rasterizer's render, the pose gradient through
it, gs/fine_registration.fine_register) against the benchmark's plain
reference written from the 3DGS definition (portbench/reference/fine.py),
on the CPU, where the rasterizer takes its plain versions of K4-K6: seeded
rooms of 2 000 gaussians a model (portbench/gen/gs_scene.py) seen by 2 views
of 64x48. Also the fine loop's capacity fix: a segment whose probe-sized
capacities are breached is run again and drops nothing, and a segment
without a breach runs as the loop before the fix did, bit for bit. Each
tolerance states its reason."""

import numpy as np
import pytest
import torch

from gaussreg_tpu_torch.gs import fine_registration as fr
from gaussreg_tpu_torch.gs.cameras import load_cameras_json
from gaussreg_tpu_torch.gs.ply import load_gaussians
from gaussreg_tpu_torch.gs.rasterizer.render import render
from gaussreg_tpu_torch.ops import _cuda
from portbench.gen import gs_scene
from portbench.reference import fine as ref_fine

torch.set_num_threads(2)

N = 2000
# a perturbed pose: log-scale, rotation vector, translation
PARAMS = np.array([0.01, 0.01, -0.02, 0.015, 0.01, 0.0, -0.01])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("fine_reference")
    ref_ply, src_ply, gt = gs_scene.write_pair(str(root), 2**31 + 77, N, camera_width=64)
    cams_json = str(root / "ref" / "cameras.json")
    return dict(
        gt=gt,
        ref=fr.to_device_gaussians(load_gaussians(ref_ply), None, device="cpu"),
        src=fr.to_device_gaussians(load_gaussians(src_ply), None, device="cpu"),
        cams=load_cameras_json(cams_json, max_cameras=2, max_size=640),
        ref_r=ref_fine.load_model(ref_ply, None, "cpu"),
        src_r=ref_fine.load_model(src_ply, None, "cpu"),
        views=ref_fine.read_cameras(cams_json, 2, 640, "cpu"),
    )


def _program_render(g, cam):
    with torch.no_grad():
        return render(g.means, g.scales, g.quats, g.opacities, g.sh_coeffs, cam, valid=g.valid)


def _reference_targets(scene):
    return [ref_fine.render(scene["ref_r"], v)["render"] for v in scene["views"]]


@pytest.mark.parametrize("model", ["ref", "src_at_gt"])
def test_renders_match_the_reference(scene, model):
    """Colour and transmittance of both views, the ref model as it is and
    the src model moved by the GT similarity (the SH bands rotated by the
    port, evaluated at the rotated direction by the reference). The mean
    colour gap within 2e-3 of the mean colour (measured 1.7-2.1e-4) and the
    mean T gap within 4e-4 (measured 2.5-4.3e-5): the tile rasterizer
    composites whole 128-pair chunks past T = 1e-4 where the reference stops
    each pixel, and a pair whose alpha rounds to either side of 1/255 enters
    one side only; the largest pixel gap within 0.01 (measured 9.3e-4), one
    such pair's 1/255 times a colour of at most 2.5."""
    g, sim, model_r = scene["ref"], None, scene["ref_r"]
    if model == "src_at_gt":
        gt = torch.from_numpy(scene["gt"])
        g = fr.transform_gaussians_device(scene["src"], gt)
        sim, model_r = ref_fine.pose(gt), scene["src_r"]
    for cam, view in zip(scene["cams"], scene["views"]):
        out = _program_render(g, cam)
        r = ref_fine.render(model_r, view, sim)["render"]
        assert out.rgb.shape == r.rgb.shape == (48, 64, 3)
        gap = (out.rgb - r.rgb).abs()
        assert float(gap.mean()) < 2e-3 * float(r.rgb.abs().mean()), float(gap.mean())
        assert float((out.transmittance - r.transmittance).abs().mean()) < 4e-4
        assert float(gap.max()) < 0.01
        # the scene is seen: the check is not one of two empty images
        assert float(r.transmittance.mean()) < 0.95


def _program_loss_and_grad(scene, targets, params):
    p = {"log_s": torch.tensor(params[0], dtype=torch.float32),
         "omega": torch.tensor(params[1:4], dtype=torch.float32),
         "t": torch.tensor(params[4:7], dtype=torch.float32)}
    for v in p.values():
        v.requires_grad_(True)
    moved = fr.transform_gaussians_device(
        scene["src"], fr._delta_transform(p) @ torch.from_numpy(scene["gt"]))
    loss = 0.0
    for cam, t in zip(scene["cams"], targets):
        out = render(moved.means, moved.scales, moved.quats, moved.opacities,
                     moved.sh_coeffs, cam, valid=moved.valid)
        loss = loss + torch.mean(torch.abs(out.rgb - t.rgb))
        loss = loss + 0.1 * torch.mean(torch.abs(out.transmittance - t.transmittance))
    loss = loss / len(targets)
    loss.backward()
    grad = torch.cat([p["log_s"].grad.reshape(1), p["omega"].grad, p["t"].grad])
    return float(loss.detach()), grad.double().numpy()


def test_loss_and_pose_gradient_match_the_reference(scene):
    """The fine loss and its gradient in the 7 pose numbers at a pose off
    the GT, the port's targets and renders against the reference's: the
    loss within 1e-4 of itself (measured 8e-6), the gradient within 1e-2 of
    its norm (measured 1.2e-3): the gradient sums the same chunk- and
    cut-level differences as the renders, weighted by their pixels'
    positions."""
    targets = [_program_render(scene["ref"], cam) for cam in scene["cams"]]
    loss, grad = _program_loss_and_grad(scene, targets, PARAMS)
    tgt = [(r.rgb, r.transmittance) for r in _reference_targets(scene)]
    loss_r, grad_r, _ = ref_fine.fine_loss(scene["src_r"], scene["views"], tgt, scene["gt"],
                                           PARAMS, grad=True)
    assert abs(loss - loss_r) < 1e-4 * loss_r, (loss, loss_r)
    assert np.linalg.norm(grad - grad_r) < 1e-2 * np.linalg.norm(grad_r), (grad, grad_r)
    assert np.linalg.norm(grad_r) > 1e-3  # the pose is off the optimum


def test_fine_register_loss_trace_matches_the_reference(scene):
    """5 steps of fine_register from the perturbed pose (segments of 3 and 2,
    Adam at lr 3e-3) against the reference's own loss, autograd gradient and
    torch.optim.Adam over the same 7 numbers: each step's loss within 2e-3
    of itself (measured 1.3e-4): Adam's first steps move each number by
    about lr times the sign of its gradient, which the two gradients'
    1e-3 gaps leave as they are, so the trajectories part only by the
    renders' own gaps."""
    p = torch.tensor(PARAMS, dtype=torch.float32)
    init = (fr._delta_transform({"log_s": p[0], "omega": p[1:4], "t": p[4:7]})
            @ torch.from_numpy(scene["gt"]))
    out = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], num_steps=5,
                           reprobe_every=3)
    assert int(out.overflow) == 0
    tgt = [(r.rgb, r.transmittance) for r in _reference_targets(scene)]
    q = torch.zeros(7, requires_grad=True)
    adam = torch.optim.Adam([q], lr=3e-3, eps=1e-8)
    trace = []
    for _ in range(5):
        loss, grad, _ = ref_fine.fine_loss(scene["src_r"], scene["views"], tgt,
                                           init.numpy(), q.detach().numpy(), grad=True)
        trace.append(loss)
        q.grad = torch.as_tensor(grad, dtype=torch.float32)
        adam.step()
    np.testing.assert_allclose(out.losses.numpy(), trace, rtol=2e-3)
    assert trace[-1] < trace[0]


def _unfixed_fine_register(ref, src, init_transform, cameras, num_steps=100, lr=3e-3,
                           reprobe_every=30):
    """The fine loop as it was before segments were checked and redone (at
    its defaults: saturation cull, adaptive tiles): caps from the probe at
    each segment's start, the overflow only summed."""
    init_transform = torch.as_tensor(init_transform, dtype=torch.float32)
    with torch.no_grad():
        targets = [render(ref.means, ref.scales, ref.quats, ref.opacities, ref.sh_coeffs,
                          cam, valid=ref.valid) for cam in cameras]
    params = {"log_s": torch.zeros((), requires_grad=True),
              "omega": torch.zeros(3, requires_grad=True),
              "t": torch.zeros(3, requires_grad=True)}
    optimizer = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8)
    losses, overflow, done = [], torch.zeros((), dtype=torch.int32), 0
    while done < num_steps:
        seg = min(reprobe_every, num_steps - done)
        with torch.no_grad():
            current = fr._delta_transform(params) @ init_transform
        caps = fr._probe_caps(src, current, cameras, (4, 8, 16), True, False)
        sat_depths = caps.sat_depths
        for _ in range(seg):
            optimizer.zero_grad(set_to_none=True)
            moved = fr.transform_gaussians_device(
                src, fr._delta_transform(params) @ init_transform)
            loss, new_sat = 0.0, []
            for i, cam in enumerate(cameras):
                out = render(moved.means, moved.scales, moved.quats, moved.opacities,
                             moved.sh_coeffs, cam, valid=moved.valid,
                             max_tiles_per_gaussian=caps.mt, bwd_capacity_blocks=caps.bwd_cap,
                             sat_depth=sat_depths[i], live_gaussian_cap=caps.live_cap,
                             pair_capacity_blocks=caps.pair_cap, sat_margin=1.10)
                loss = loss + torch.mean(torch.abs(out.rgb - targets[i].rgb))
                loss = loss + 0.1 * torch.mean(
                    torch.abs(out.transmittance - targets[i].transmittance))
                overflow = overflow + out.overflow_cap
                new_sat.append(out.sat_depth.detach())
            loss = loss / len(cameras)
            loss.backward()
            optimizer.step()
            sat_depths = new_sat
            losses.append(loss.detach())
        done += seg
    with torch.no_grad():
        transform = fr._delta_transform(params) @ init_transform
    return torch.stack(losses), transform, overflow


def _breaching(monkeypatch):
    """Make every probe size the live and pair capacities for a small share
    of the demand: each segment's first attempt drops pairs."""
    probe = fr._probe_caps

    def small(*args, **kwargs):
        caps = probe(*args, **kwargs)
        return caps._replace(live_cap=256, pair_cap=2)

    monkeypatch.setattr(fr, "_probe_caps", small)


def test_without_a_breach_the_trajectory_is_the_unfixed_loops(scene):
    """6 steps in segments of 4 and 2 from the GT's neighbourhood: the losses
    and the transform equal the unfixed loop's bit for bit, no segment is
    redone, and the saved and restored state changes nothing."""
    init = torch.from_numpy(scene["gt"]) @ fr._delta_transform(
        {"log_s": torch.tensor(0.01), "omega": torch.tensor([0.01, -0.02, 0.0]),
         "t": torch.tensor([0.02, 0.0, -0.01])})
    before = _cuda.launch_counts()
    out = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], num_steps=6,
                           reprobe_every=4)
    after = _cuda.launch_counts()
    losses, transform, overflow = _unfixed_fine_register(
        scene["ref"], scene["src"], init, scene["cams"], num_steps=6, reprobe_every=4)
    assert torch.equal(out.losses, losses)
    assert torch.equal(out.transform, transform)
    assert int(out.overflow) == int(overflow) == 0
    assert after["fine.segments_redone"] == before["fine.segments_redone"]
    assert after["fine.probes"] - before["fine.probes"] == 2
    assert after["fine.steps"] - before["fine.steps"] == 6


def test_a_breached_segment_is_redone_and_drops_nothing(scene, monkeypatch):
    """With the probe's capacities cut to a share of the demand, the loop
    before the fix drops pairs (its overflow > 0) and its losses differ; the
    fixed loop redoes each segment uncapped: overflow 0, the redo counter
    and the dropped pairs counted, and the trajectory is the one without a
    breach bit for bit (capacities that drop nothing leave every pair, sum
    and step as they were)."""
    init = torch.from_numpy(scene["gt"])
    kw = dict(num_steps=4, reprobe_every=2)
    clean = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], **kw)
    _breaching(monkeypatch)
    unfixed = _unfixed_fine_register(scene["ref"], scene["src"], init, scene["cams"], **kw)
    assert int(unfixed[2]) > 0
    assert not torch.equal(unfixed[0], clean.losses)
    before = _cuda.launch_counts()
    out = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], **kw)
    after = _cuda.launch_counts()
    assert int(out.overflow) == 0
    assert after["fine.segments_redone"] - before["fine.segments_redone"] == 2
    assert after["fine.cap_pairs_dropped"] > before["fine.cap_pairs_dropped"]
    assert after["fine.steps"] - before["fine.steps"] == 8
    assert torch.equal(out.losses, clean.losses)
    assert torch.equal(out.transform, clean.transform)


def test_a_segment_past_the_tile_caps_bound_is_redone_at_more_tiles(scene, monkeypatch):
    """A probe that picks one tile a gaussian (its drops pass
    TILE_DROP_SHARE: at 64x48, 2x2 tiles, many gaussians straddle a tile
    edge) has each segment redone at the next candidate, 4, where nothing
    is dropped: the trajectory is the one whose probe picked 4, bit for
    bit."""
    init = torch.from_numpy(scene["gt"])
    kw = dict(num_steps=4, reprobe_every=2)
    clean = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], **kw)
    probe = fr._probe_caps
    monkeypatch.setattr(fr, "_probe_caps",
                        lambda *a, **k: probe(*a, **k)._replace(mt=1))
    before = _cuda.launch_counts()
    out = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], **kw)
    after = _cuda.launch_counts()
    assert after["fine.segments_redone"] - before["fine.segments_redone"] == 2
    assert after["fine.tile_pairs_dropped"] == before["fine.tile_pairs_dropped"]
    assert torch.equal(out.losses, clean.losses)
    assert torch.equal(out.transform, clean.transform)


def test_the_probe_and_the_targets_take_more_tiles_where_16_drop_too_many():
    """Gaussians that each cover most of a 320x256 view (80 tiles): at 16
    tiles a gaussian a render would drop most pairs, so the probe takes the
    smallest candidate past 16 whose renders drop under TILE_DROP_SHARE, as
    the JAX package's {4, 8, 16} cannot, and so do the targets."""
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera

    rng = np.random.default_rng(3)
    n = 12
    g = fr.gaussians_from_numpy(
        means=rng.uniform(-0.3, 0.3, size=(n, 3)), scales=np.full((n, 3), 0.25),
        quats=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)), opacities=np.full(n, 0.5),
        sh_coeffs=rng.normal(scale=0.3, size=(n, 3, 16)), device="cpu")
    cam = look_at_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [0, 1, 0], fov_deg=60,
                         width=320, height=256)
    caps = fr._probe_caps(g, torch.eye(4), [cam], fr.MT_CANDIDATES, True, False)
    assert caps.mt > 16
    with torch.no_grad():
        out = render(g.means, g.scales, g.quats, g.opacities, g.sh_coeffs, cam, valid=g.valid,
                     max_tiles_per_gaussian=caps.mt)
    assert int(out.overflow) <= fr.TILE_DROP_SHARE * (int(out.overflow) + int(out.num_pairs))
    (target,) = fr._render_targets(g, [cam], fr.MT_CANDIDATES, False)
    assert torch.equal(target.rgb, out.rgb)


def test_a_segment_that_drops_whatever_the_capacity_ends_uncapped(scene, monkeypatch):
    """A render that drops pairs at every capacity (the planted fault of
    portbench/faults_fine.py) stops the redo after the second, uncapped
    attempt, and its drops reach the result's overflow: the loop ends."""
    from portbench import faults_fine

    init = torch.from_numpy(scene["gt"])
    before = _cuda.launch_counts()
    with faults_fine.pairs_dropped():
        out = fr.fine_register(scene["ref"], scene["src"], init, scene["cams"], num_steps=2,
                               reprobe_every=2)
    after = _cuda.launch_counts()
    assert int(out.overflow) > 0
    assert after["fine.segments_redone"] - before["fine.segments_redone"] == 1
    assert after["fine.steps"] - before["fine.steps"] == 4
