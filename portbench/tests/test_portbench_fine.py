"""The fine cell (`fine_capped`) on the CPU: run whole at a tiny scene and
traffic (the tiny coarse configuration with weights drawn from the seed,
3 000-gaussian rooms seen by 2 views of 64x48, 4 steps), the planted
faults of portbench/faults_fine.py over a limit (`sat_margin_one` moves
no number here: PERF.md), the
timed path's steps read from a kept call, the plain reference loading
nothing of the program, and the long-trace reduction equal to trace.py's."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import faults_fine, run, spec, trace, trace_long
from portbench.runners import gs_fine
from portbench.tests import helpers

torch.set_num_threads(2)
SEED = 2**31 + 5
# the numbers that hold the program against the reference; `fine_gain` is
# left out at random coarse weights, whose coarse transform is arbitrary
AGREEMENT = ("fine_overflow", "loss0_rel", "loss_drift_rel", "render_mean_rel")


def fine_cell(tmp_path):
    cell = spec.load_cell("fine_capped")
    coarse = tmp_path / "coarse.json"
    coarse.write_text(json.dumps(helpers.tiny_config()))
    cell.config = dict(cell.config, coarse_config=str(coarse), fine=dict(
        cell.config["fine"], steps=4, max_gaussians=1500, views=2, point_limit=800))
    cell.traffic = dict(cell.traffic, num_gaussians=3000, camera_width=64)
    return cell


def test_fine_cell_runs_whole_on_the_cpu(tmp_path):
    result = run.run_cell(fine_cell(tmp_path), SEED, 0.2, False, device="cpu")
    assert set(result["metrics"]) == {"pair_ms", "setup_s"}
    assert result["attempted"] >= 2 and result["failed"] == 0
    checks = result["checks"]
    assert set(checks) == {"failed_calls", *spec.load_cell("fine_capped").traffic["limits"]}
    for name in AGREEMENT:
        assert checks[name]["value"] <= checks[name]["limit"], checks
    assert result["readings"]["segments_redone_per_call"] == 0
    assert result["readings"]["pose_grad_rel"] < 0.1


@pytest.mark.parametrize("fault,number", [
    ("pairs_dropped", "fine_overflow"),
    ("sh_rotation_skipped", "render_mean_rel"),
    ("colour_off", "loss0_rel"),
])
def test_a_planted_fault_is_not_correct(fault, number, tmp_path):
    with faults_fine.FAULTS[fault]():
        result = run.run_cell(fine_cell(tmp_path), SEED, 0.2, False, device="cpu")
    assert not result["correct"], result["checks"]
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_accepted_steps_follow_the_loops_spans():
    """Steps of a redone attempt give way to the redo's; the attempt closed
    last before a probe or the call's end is the accepted one."""
    events = ["fine.probe", 0, 1, "fine.check", "fine.probe", 2, 3, "fine.check", 4, 5,
              "fine.check", "fine.probe", 6, "fine.check"]
    assert gs_fine.accepted_steps(events) == ([0, 1, 4, 5, 6], [1, 3, 4])


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    from gaussreg_tpu_torch.gs import fine_registration as fr
    from gaussreg_tpu_torch.gs.cameras import load_cameras_json
    from gaussreg_tpu_torch.gs.ply import load_gaussians
    from portbench.gen import gs_scene

    root = tmp_path_factory.mktemp("kept_call")
    ref_ply, src_ply, gt = gs_scene.write_pair(str(root), 2**31 + 77, 2000, camera_width=64)
    delta = fr._delta_transform({"log_s": torch.tensor(0.01),
                                 "omega": torch.tensor([0.01, -0.02, 0.0]),
                                 "t": torch.tensor([0.02, 0.0, -0.01])})
    return dict(init=(delta @ torch.from_numpy(gt)).numpy(),
                ref=fr.to_device_gaussians(load_gaussians(ref_ply), None, device="cpu"),
                src=fr.to_device_gaussians(load_gaussians(src_ply), None, device="cpu"),
                cams=load_cameras_json(str(root / "ref" / "cameras.json"), max_cameras=2,
                                       max_size=640))


def _kept(scene, num_steps, monkeypatch=None):
    from gaussreg_tpu_torch import api

    store = {}
    with gs_fine.kept_fine_call(store):
        api.fine_register(scene["ref"], scene["src"], scene["init"], scene["cams"],
                          num_steps=num_steps, reprobe_every=2)
    return store


def test_a_kept_call_holds_each_segments_last_pose_and_renders(small_scene, monkeypatch):
    """4 steps in segments of 2, each segment redone (the probe's live and
    pair capacities cut): the kept poses of steps 1 and 3 are the final
    transforms of 1- and 3-step calls, and poses and last renders are the
    unbreached call's, bit for bit."""
    from gaussreg_tpu_torch.gs import fine_registration as fr
    from gaussreg_tpu_torch.ops import _cuda

    clean = _kept(small_scene, 4)
    probe = fr._probe_caps
    monkeypatch.setattr(fr, "_probe_caps",
                        lambda *a, **k: probe(*a, **k)._replace(live_cap=256, pair_cap=2))
    before = _cuda.launch_counts()["fine.segments_redone"]
    breached = _kept(small_scene, 4)
    assert _cuda.launch_counts()["fine.segments_redone"] - before == 2
    monkeypatch.undo()
    assert breached["n_steps"] == 4 and [k for k, _ in breached["drift"]] == [1, 3]
    for steps, (_, pose) in zip((1, 3), breached["drift"]):
        assert torch.equal(pose, _kept(small_scene, steps)["out"].transform)
    for (_, a), (_, b) in zip(clean["drift"], breached["drift"]):
        assert torch.equal(a, b)
    assert len(breached["last_renders"]) == 2
    for (rgb_a, t_a), (rgb_b, t_b) in zip(clean["last_renders"], breached["last_renders"]):
        assert torch.equal(rgb_a, rgb_b) and torch.equal(t_a, t_b)


def test_the_fine_reference_loads_nothing_of_the_program():
    """The reference, the scene generator and the count functions in a fresh
    process: no module of the program, JAX, Flax or the JAX package."""
    code = (
        "import sys\n"
        "from portbench import counts_fine, guard\n"
        "from portbench.gen import gs_scene\n"
        "from portbench.reference import fine\n"
        "bad = guard.forbidden_modules() + sorted(\n"
        "    m for m in sys.modules if m.split('.')[0] == 'gaussreg_tpu_torch')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _events(seed: int):
    """A chrome trace's complete events: nested stage ranges, runtime calls
    with correlations, device operations launched by them (some with no
    correlation, as the ctypes launches), and a stage with no operation."""
    rng = np.random.default_rng(seed)
    events, corr, t = [], 0, 0.0
    for step in range(20):
        lo = t
        events.append({"ph": "X", "cat": "user_annotation", "name": "step", "ts": lo})
        for part in ("fwd", "bwd", "idle"):
            plo = t
            for _ in range(int(rng.integers(1, 6)) if part != "idle" else 0):
                t += float(rng.uniform(1, 5))
                corr += 1
                events.append({"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": t,
                               "dur": 1.0, "args": {"correlation": corr}})
                start = t + float(rng.uniform(0, 30))
                events.append({"ph": "X", "cat": "kernel", "name": f"k{rng.integers(4)}",
                               "ts": start, "dur": float(rng.uniform(1, 20)),
                               "args": {"correlation": corr if rng.uniform() < 0.8 else -5}})
            t += float(rng.uniform(1, 10))
            events.append({"ph": "X", "cat": "user_annotation", "name": part, "ts": plo,
                           "dur": t - plo})
        events[[i for i, e in enumerate(events) if e["name"] == "step"][-1]]["dur"] = t - lo
        t += float(rng.uniform(0, 50))
    return events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_long_reduces_as_trace_does(seed):
    events = _events(seed)
    stages = ["step", "fwd", "bwd", "idle", "absent"]
    a = trace.reduce(events, stages, 2, 1.0)
    b = trace_long.reduce(events, stages, 2, 1.0)
    assert b.busy_s == pytest.approx(a.busy_s, rel=1e-12)
    assert b.kernels == a.kernels
    assert set(b.stage_ops) == set(a.stage_ops)
    for stage, ops in a.stage_ops.items():
        assert b.stage_ops[stage] == pytest.approx(ops, rel=1e-12)
    assert [r[0] for r in b.breakdown["idle_gaps"]] == [r[0] for r in a.breakdown["idle_gaps"]]
    assert [r[1] for r in b.breakdown["idle_gaps"]] == pytest.approx(
        [r[1] for r in a.breakdown["idle_gaps"]], rel=1e-12)
    assert b.breakdown["device_ops"] == a.breakdown["device_ops"]
