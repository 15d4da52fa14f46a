"""Closed loop of `api.register_gs_pair(ref.ply, src.ply, model, cfg,
fine=True)`, one client, back to back: the whole demo --fine call, from the
.ply files' read to the refined transform.

Set-up builds the kernels, loads the coarse network named by the
configuration's `coarse_config` (its checkpoint through the program's own
loader, or a tree drawn from the seed for the tests' small configurations),
writes a pool of distinct 3DGS scene pairs drawn from the seed
(portbench/gen/gs_scene.py) into a temporary directory and calls each once.
The window cycles through the pool in order, each call with its own seed,
timed by the host clock ending in a device sync. Each compared call keeps
its fine inputs and result, the pose of the last step of each accepted
segment and the last step's renders (`kept_fine_call`, for that call
only); after the window the plain reference (portbench/reference/fine.py)
judges the call's own losses at its first step and at those poses, and its
last renders, and reads the program's pose gradient at the coarse
transform (`program_gradient`). A program whose fine loop does not check
and redo its segments fails at set-up's start. Traffic parameters:
num_gaussians, pool, sample (compared calls, drawn from the seed among the
first sample_range), traced_calls, limits; camera_width (ScanNet's 1296
if absent) only in the tests' small cells."""

from __future__ import annotations

import atexit
import contextlib
import math
import os
import shutil
import tempfile
import time

import numpy as np

from portbench import spec, trace, trace_long
from portbench.runners.common import Clock, sample, sub_seed, sync, worst

# the program's spans that the per-layer readers and the breakdown read,
# and the runner's own host spans (`front_end`, `probe`)
STAGES = ("front_end", "probe", "gs_pair.extract", "gs_pair.normalise", "coarse_call",
          "gs_pair.fine_load", "fine.targets", "fine.step", "fine.step.forward",
          "fine.step.backward", "fine.step.adam", "fine.check")
COUNTERS = ("fine.steps", "fine.probes", "fine.segments_redone", "fine.cap_pairs_dropped",
            "fine.tile_pairs_dropped", "fine.pairs")
K4, K5, K6 = "rasterize_fwd_kernel", "rasterize_bwd_kernel", "accumulate_pairs_kernel"


def _counts():
    from gaussreg_tpu_torch.ops import _cuda

    return _cuda.launch_counts()


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in COUNTERS if k in after}


def accepted_steps(events):
    """The deltas of the accepted attempts' steps in order, and the index of
    each accepted attempt's last step, from the loop's `events` as
    `kept_fine_call` records them: a step's delta, "fine.check" closing an
    attempt, and "fine.probe" (or the call's end) accepting the attempt
    closed last (a redone one is closed again by the redo's check)."""
    steps, ends, attempt, closed = [], [], [], None
    for e in [*events, "fine.probe"]:
        if not isinstance(e, str):
            attempt.append(e)
        elif e == "fine.check":
            closed, attempt = attempt, []
        elif closed is not None:
            steps += closed
            ends.append(len(steps) - 1)
            closed = None
    return steps, ends


@contextlib.contextmanager
def kept_fine_call(store: dict):
    """Keep the inputs and the result of the `api.fine_register` call made
    inside, with the pose of the last step of each accepted segment
    (`drift`: [(step, (4, 4) transform)]) and the last step's renders
    (`last_renders`: [(rgb, T)] a view): no read, no sync. The loop's steps
    are told by `_delta_transform` and `render` called with grad enabled,
    its attempts by its spans (`accepted_steps`)."""
    import torch

    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.gs import fine_registration as fr

    orig_fine, orig_delta = api.fine_register, fr._delta_transform
    orig_render, orig_annotate = fr.render, fr.annotate
    events, renders = [], []

    def delta(params):
        out = orig_delta(params)
        if torch.is_grad_enabled():
            events.append(out.detach().clone())
            renders.clear()
        return out

    def render(*args, **kwargs):
        out = orig_render(*args, **kwargs)
        if torch.is_grad_enabled():
            renders.append((out.rgb.detach(), out.transmittance.detach()))
        return out

    def annotate(name):
        if name in ("fine.probe", "fine.check"):
            events.append(name)
        return orig_annotate(name)

    def keep(ref_g, src_g, transform, cams, **kwargs):
        events.clear()
        out = orig_fine(ref_g, src_g, transform, cams, **kwargs)
        steps, ends = accepted_steps(events)
        init = torch.as_tensor(transform, dtype=torch.float32, device=out.transform.device)
        store.update(ref_g=ref_g, src_g=src_g, init=transform, cams=cams, out=out,
                     n_steps=len(steps), drift=[(k, steps[k] @ init) for k in ends],
                     last_renders=list(renders))
        return out

    api.fine_register, fr._delta_transform = keep, delta
    fr.render, fr.annotate = render, annotate
    try:
        yield
    finally:
        api.fine_register, fr._delta_transform = orig_fine, orig_delta
        fr.render, fr.annotate = orig_render, orig_annotate


def program_gradient(ref_g, src_g, init, cams, cotangents):
    """The pose gradient of the program's first step of a segment at the
    similarity `init`, as `fine_register` takes it (the probe's capacities
    at `init`, `render` at them), of the renders' linear
    term mean over views of sum(c_rgb rgb) + sum(c_T T), `cotangents` =
    [(c_rgb, c_T)] a view: with the reference's `l1_cotangents` the loss's
    gradient at the reference's L1 signs, so that a pixel whose gap to the
    target is within the two renders' rounding does not flip the
    comparison. Returns it in (log-scale, rotation vector, translation), a
    (7,) float64 array."""
    import torch

    from gaussreg_tpu_torch.gs import fine_registration as fr

    dev = src_g.means.device
    init = torch.as_tensor(np.asarray(init), dtype=torch.float32, device=dev)
    caps = fr._probe_caps(src_g, init, cams, fr.MT_CANDIDATES, True, False)
    params = {"log_s": torch.zeros((), device=dev), "omega": torch.zeros(3, device=dev),
              "t": torch.zeros(3, device=dev)}
    for p in params.values():
        p.requires_grad_(True)
    moved = fr.transform_gaussians_device(src_g, fr._delta_transform(params) @ init)
    term = 0.0
    for i, (cam, (c_rgb, c_t)) in enumerate(zip(cams, cotangents)):
        out = fr.render(moved.means, moved.scales, moved.quats, moved.opacities,
                        moved.sh_coeffs, cam, valid=moved.valid,
                        max_tiles_per_gaussian=caps.mt, bwd_capacity_blocks=caps.bwd_cap,
                        sat_depth=caps.sat_depths[i], live_gaussian_cap=caps.live_cap,
                        pair_capacity_blocks=caps.pair_cap, sat_margin=1.10)
        term = term + torch.sum(c_rgb * out.rgb.double())
        term = term + torch.sum(c_t * out.transmittance.double())
    (term / len(cams)).backward()
    return torch.cat([params["log_s"].grad.reshape(1), params["omega"].grad,
                      params["t"].grad]).double().cpu().numpy()


def pose_errors(est: np.ndarray, gt: np.ndarray):
    """(rotation error in degrees, translation error, relative scale
    error) of a similarity against the GT."""
    s_e, s_g = np.cbrt(np.linalg.det(est[:3, :3])), np.cbrt(np.linalg.det(gt[:3, :3]))
    r = (est[:3, :3] / s_e) @ (gt[:3, :3] / s_g).T
    angle = math.degrees(math.acos(float(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0))))
    return angle, float(np.linalg.norm(est[:3, 3] - gt[:3, 3])), float(abs(s_e / s_g - 1))


def render_gap(prog, ref) -> float:
    """The largest over the views of the mean colour gap over the
    reference's mean colour, and of the mean transmittance gap (T is itself
    a share, in [0, 1])."""
    worst_gap = 0.0
    for (rgb, t), r in zip(prog, ref):
        c = float((rgb.double() - r.rgb.double()).abs().mean() / r.rgb.double().abs().mean())
        tr = float((t.double() - r.transmittance.double()).abs().mean())
        worst_gap = max(worst_gap, c, tr)
    return worst_gap


class Runner:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.dev = cell, int(seed), device
        self.t = cell.traffic
        self.fine = cell.config["fine"]
        self.coarse = spec.load_json(os.path.join(spec.ROOT, cell.config["coarse_config"]))
        self.kept = {}
        self.trace = None
        self.traced_call = None
        self.root = None

    def call_seed(self, i: int) -> int:
        return sub_seed(self.seed, 2, i)

    def scenes(self):
        """Write the pool of scene pairs; [(ref ply, src ply, gt)]."""
        from portbench.gen import gs_scene

        self.root = tempfile.mkdtemp(prefix="portbench_fine_")
        atexit.register(shutil.rmtree, self.root, True)
        width = self.t.get("camera_width", gs_scene.SCANNET_SIZE[0])
        return [gs_scene.write_pair(os.path.join(self.root, f"pair{i}"),
                                    sub_seed(self.seed, 1, i), self.t["num_gaussians"], width)
                for i in range(self.t["pool"])]

    def setup(self) -> None:
        from gaussreg_tpu_torch import api
        from gaussreg_tpu_torch.config import Config
        from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint, params_from_flax
        from gaussreg_tpu_torch.models.registration import create_model
        from gaussreg_tpu_torch.gs import fine_registration
        from gaussreg_tpu_torch.ops import _cuda

        if not hasattr(fine_registration, "SEGMENT_ATTEMPTS"):
            raise RuntimeError("fine_capped: the program's fine loop neither checks nor "
                               "redoes its segments (no fine.check span to read)")
        if str(self.dev).startswith("cuda"):
            _cuda.build_all()
        self.api = api
        self.cfg = spec.program_config(self.coarse, Config)
        self.model = create_model(self.cfg, self.dev)
        if self.coarse.get("weights"):
            state = load_checkpoint(os.path.join(spec.ROOT, self.coarse["weights"]))
        else:
            from portbench.reference import weights

            state = params_from_flax(weights.seeded(self.coarse, sub_seed(self.seed, 5)))
        self.model.load_state_dict(state)
        self.pool = self.scenes()
        for i, pair in enumerate(self.pool):
            self._call(pair, sub_seed(self.seed, 3, i))
        sync(self.dev)

    def _call(self, pair, seed: int):
        f = self.fine
        return self.api.register_gs_pair(
            pair[0], pair[1], self.model, self.cfg, point_limit=f["point_limit"], fine=True,
            fine_steps=f["steps"], max_fine_gaussians=f["max_gaussians"],
            fine_views=f["views"], seed=seed, device=self.dev)

    def window(self, seconds: float):
        compared = set(sample(self.seed, self.t["sample_range"], self.t["sample"]))
        clock = Clock()
        finite, counters = [], {}
        i = 0
        while True:
            store = {}
            before = _counts()
            with kept_fine_call(store) if i in compared else contextlib.nullcontext():
                t0 = time.perf_counter()
                res = self._call(self.pool[i % len(self.pool)], self.call_seed(i))
                sync(self.dev)
                elapsed = clock.record(t0)
            for k, v in _delta(before, _counts()).items():
                counters[k] = counters.get(k, 0) + v
            if i in compared:
                self.kept[i] = dict(store, res=res, pair=self.pool[i % len(self.pool)])
            finite.append(bool(np.isfinite(res["transform"]).all()))
            i += 1
            if elapsed >= seconds and i > max(compared):
                break
        self.calls, self.window_s = i, clock.seconds
        self.latencies = clock.latencies
        self.counters = counters
        return {"pair_ms": 1e3 * clock.seconds / i}, i, finite.count(False)

    def traced(self) -> trace.Trace:
        from gaussreg_tpu_torch import api
        from gaussreg_tpu_torch.gs import fine_registration

        n = self.t["traced_calls"]
        spans, store, counters = {}, {}, {}

        def run():
            before = _counts()
            with kept_fine_call(store):
                self._call(self.pool[0], sub_seed(self.seed, 4, 0))
            for j in range(1, n):
                self._call(self.pool[j % len(self.pool)], sub_seed(self.seed, 4, j))
            sync(self.dev)
            counters.update(_delta(before, _counts()))
            return n

        with trace.host_spans(spans, [("front_end", api, "load_point_cloud_from_gs_ply"),
                                      ("front_end", api, "adjust_point_cloud_volume"),
                                      ("probe", fine_registration, "_probe_caps")]):
            self.trace = trace_long.profile(run, STAGES)
        self.trace.host_s = spans
        if "fine.steps" in counters:
            self.trace.info["fine_steps"] = counters["fine.steps"]
        self.traced_call = dict(store, pair=self.pool[0])
        return self.trace

    def release(self) -> None:
        del self.model
        self.api = None

    def reference_side(self, pair, tf32: bool = False):
        """The reference's models, views and target renders of a pair."""
        import torch

        from portbench.reference import fine, precision

        f = self.fine
        with precision(tf32), torch.no_grad():
            ref = fine.load_model(pair[0], f["max_gaussians"], self.dev)
            src = fine.load_model(pair[1], f["max_gaussians"], self.dev)
            views = fine.read_cameras(
                os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(pair[0]))),
                             "cameras.json"), f["views"], f["max_size"], self.dev)
            targets = [fine.render(ref, v, count=True)["render"] for v in views]
        return ref, src, views, targets

    def reference_at(self, pair, coarse, final, drift):
        """The reference's loss, pose gradient and `l1_cotangents` at
        `coarse`, its loss at each pose of `drift` and its renders at the
        last, and its loss at `final`."""
        from portbench.reference import fine, precision

        _, src, views, targets = self.reference_side(pair)
        tgt = [(r.rgb, r.transmittance) for r in targets]
        with precision(False):
            loss0, grad0, renders0 = fine.fine_loss(src, views, tgt, coarse, grad=True)
            drifted = [fine.fine_loss(src, views, tgt, pose) for pose in drift]
            loss1, _, _ = fine.fine_loss(src, views, tgt, final)
        return {"loss0": loss0, "grad0": grad0, "loss1": loss1,
                "drift": [d[0] for d in drifted], "renders": drifted[-1][2],
                "cot": fine.l1_cotangents(renders0, tgt)}

    def judge(self, pair, coarse, final, prog, ref):
        """{name: value} of one call: `prog` holds the program's overflow,
        its losses at the first step and at `ref`'s drifted poses, its
        renders at the last of them and its pose gradient at `coarse`;
        `ref` is `reference_at` of the same poses."""
        nums = {
            "fine_overflow": float(prog["overflow"]),
            "loss0_rel": abs(prog["loss0"] - ref["loss0"]) / ref["loss0"],
            "loss_drift_rel": max(abs(p - r) / r for p, r in zip(prog["drift"], ref["drift"])),
            "render_mean_rel": render_gap(prog["renders"], ref["renders"]),
            "pose_grad_rel": float(np.linalg.norm(prog["grad"] - ref["grad0"])
                                   / max(np.linalg.norm(ref["grad0"]), 1e-30)),
            "fine_gain": ref["loss1"] / ref["loss0"],
        }
        gt = pair[2].astype(np.float64)
        for name, m in (("coarse", coarse), ("final", final)):
            rre, rte, rse = pose_errors(np.asarray(m, np.float64), gt)
            nums.update({f"{name}_rre_deg": rre, f"{name}_rte": rte, f"{name}_rse": rse})
        return nums

    def compare(self, kept, pair):
        """{name: value} of one kept call: the reference at its coarse
        transform, at the pose of each accepted segment's last step and at
        its final transform, against the timed call's overflow, losses and
        last renders, and (a reading) the program's pose gradient at the
        coarse transform (`program_gradient`)."""
        res = kept["res"]
        losses = res["fine_losses"]
        if kept["n_steps"] != len(losses):
            raise RuntimeError(f"fine_capped: {kept['n_steps']} accepted steps told from the "
                               f"loop's spans, {len(losses)} losses")
        ref = self.reference_at(pair, res["coarse_transform"], res["transform"],
                                [t.cpu().numpy() for _, t in kept["drift"]])
        prog = {"overflow": int(kept["out"].overflow), "loss0": float(losses[0]),
                "drift": [float(losses[k]) for k, _ in kept["drift"]],
                "renders": kept["last_renders"],
                "grad": program_gradient(kept["ref_g"], kept["src_g"], res["coarse_transform"],
                                         kept["cams"], ref["cot"])}
        return self.judge(pair, res["coarse_transform"], res["transform"], prog, ref)

    def check(self):
        """{name: value} over the compared calls (the worst of each), and in
        a traced run the counted work of the traced call's renders."""
        nums = {}
        for _, kept in sorted(self.kept.items()):
            worst(nums, self.compare(kept, kept["pair"]))
        c = self.counters
        per_call = {"reprobes_per_call": c.get("fine.probes"),
                    "segments_redone_per_call": c.get("fine.segments_redone"),
                    "cap_pairs_dropped_per_call": c.get("fine.cap_pairs_dropped")}
        nums.update({k: v / self.calls for k, v in per_call.items() if v is not None})
        if "fine.pairs" in c:
            dropped = c["fine.tile_pairs_dropped"]
            nums["tile_drop_share"] = dropped / max(1, dropped + c["fine.pairs"])
        if self.trace is not None:
            self.count_work()
        shutil.rmtree(self.root, ignore_errors=True)
        return nums

    def count_work(self) -> None:
        """The traced call's K4-K6 work (portbench/counts_fine.py): the
        reference's work of the reference model's views for the targets,
        and of the moved model's views at the call's coarse and final
        transforms (their mean) for each other render of a launch count
        that the trace gives."""
        from portbench import counts_fine
        from portbench.reference import fine, precision

        call = self.traced_call
        res_init, res_final = call["init"], call["out"].transform.cpu().numpy()
        _, src, views, targets = self.reference_side(call["pair"])
        tgt = [(r.rgb, r.transmittance) for r in targets]
        with precision(False):
            moved = [r.counts for t in (res_init, res_final)
                     for r in fine.fine_loss(src, views, tgt, t, count=True)[2]]
        per_render = counts_fine.mean_work(moved)
        launches = {k: sum(c for name, (_, c) in self.trace.kernels.items() if k in name)
                    for k in (K4, K5, K6)}
        info = self.trace.info
        totals = {
            "k4": counts_fine.add(
                counts_fine.k4_counts(per_render, launches[K4] - len(views) * self.trace.calls),
                counts_fine.k4_counts(counts_fine.total_work(r.counts for r in targets),
                                      self.trace.calls)),
            "k5": counts_fine.k5_counts(per_render, launches[K5]),
            "k6": counts_fine.k6_counts(per_render, launches[K6]),
        }
        for key, total in totals.items():
            info.update({f"{key}_{k}": v for k, v in total.items()})

    def faults(self, names):
        """{fault: {name: value}}: this seed's compared calls made by the
        program with each fault of portbench/faults_fine.py planted (the
        gradient pass too), judged as a run judges them (set-up first; no
        window)."""
        from portbench import faults_fine

        out = {}
        for name in names:
            nums = {}
            for i in sample(self.seed, self.t["sample_range"], self.t["sample"]):
                store = {}
                pair = self.pool[i % len(self.pool)]
                with faults_fine.FAULTS[name]():
                    with kept_fine_call(store):
                        res = self._call(pair, self.call_seed(i))
                    worst(nums, self.compare(dict(store, res=res), pair))
            out[name] = nums
        shutil.rmtree(self.root, ignore_errors=True)
        return out

    def control(self):
        """{name: value}: the reference in TF32 put in the program's place on
        this seed's compared pairs (no program, no window): its loss and
        pose gradient (at the float32 reference's cotangents) at a coarse
        pose 0.01 off the GT in each of the 7 numbers, its loss and renders
        at the GT (in the place of the drifted steps')."""
        import torch

        from portbench.reference import fine, precision

        self.pool = self.scenes()
        step = np.array([0.01, 0.01, -0.01, 0.01, 0.01, -0.01, 0.01])
        nums = {}
        for i in sample(self.seed, self.t["sample_range"], self.t["sample"]):
            pair = self.pool[i % len(self.pool)]
            gt = torch.as_tensor(pair[2], device=self.dev)
            s, r, t = fine.pose(gt, torch.as_tensor(step, dtype=torch.float32, device=self.dev))
            coarse = torch.eye(4, device=self.dev)
            coarse[:3, :3], coarse[:3, 3] = s * r, t
            coarse = coarse.cpu().numpy()
            ref = self.reference_at(pair, coarse, pair[2], [pair[2]])
            _, src, views, targets = self.reference_side(pair, tf32=True)
            tgt = [(x.rgb, x.transmittance) for x in targets]
            with precision(True):
                loss0, _, _ = fine.fine_loss(src, views, tgt, coarse)
                _, grad0, _ = fine.fine_loss(src, views, tgt, coarse, grad=True,
                                             cotangents=ref["cot"])
                loss_gt, _, renders = fine.fine_loss(src, views, tgt, pair[2])
            prog = {"overflow": 0, "loss0": loss0, "drift": [loss_gt], "grad": grad0,
                    "renders": [(x.rgb, x.transmittance) for x in renders]}
            worst(nums, self.judge(pair, coarse, pair[2], prog, ref))
        shutil.rmtree(self.root, ignore_errors=True)
        return nums
