"""Closed loop of `api.coarse_register_clouds`, one client, back to back.

Set-up builds the kernels, loads the configuration's weights (the
checkpoint file through the program's own loader, or a tree drawn from the
seed for the tests' small configurations), draws a pool of distinct
synthetic pairs from the seed (portbench/gen/synthetic.py) and runs each
once. The window cycles through the pool in order, each call with its own
RANSAC seed, and times every call by the host clock ending in a device
sync. Traffic parameters: num_points, tier, pool, sample (calls compared
with the reference, drawn from the seed among the first sample_range),
traced_calls, limits."""

from __future__ import annotations

import os
import time

from portbench import spec, trace
from portbench.runners.common import Clock, percentile, sample, sub_seed, sync, worst
from portbench.gen.synthetic import random_pair

# (stage, attribute of the program's models/registration.py) marked in a trace
REGISTRATION_STAGES = (
    ("partition", "point_to_node_partition"),
    ("matching", "superpoint_matching"),
    ("sinkhorn", "log_optimal_transport"),
    ("LGR", "local_to_global_registration"),
    ("RANSAC", "ransac_similarity"),
)
STAGES = ("pyramid", "backbone", "transformer") + tuple(s for s, _ in REGISTRATION_STAGES)
SEARCHES = ("self", "down", "up")  # the reference's names of Pyramid's three lists


def weights_tree(cell, seed: int):
    """The configuration's parameter tree as the benchmark reads it: the
    checkpoint file, or drawn from the run's seed without one."""
    from portbench.reference import weights

    if cell.config.get("weights"):
        return weights.read(os.path.join(spec.ROOT, cell.config["weights"]))
    return weights.seeded(cell.config, sub_seed(seed, 5))


def program_outputs(out, backbone_out):
    """The program's outputs of one call, at the clouds' own sizes in the
    program's point order, in `reference.coarse.compare`'s keys; and the
    pyramid the reference checks, ([levels][cloud] points, [cloud] level-0
    permutation into the input)."""
    import torch

    pyr = out["batch"].pyramid
    pos, remap, levels = [], [], []
    for pts, msk in zip(pyr.points, pyr.masks):
        p_l, r_l = [], []
        for c in range(2):
            p = torch.nonzero(msk[c])[:, 0]
            r = torch.full((msk.shape[1] + 1,), -1, dtype=torch.int64, device=p.device)
            r[p] = torch.arange(p.numel(), device=p.device)
            r[-1] = p.numel()
            p_l.append(p)
            r_l.append(r)
        pos.append(p_l)
        remap.append(r_l)
        levels.append([pts[c][p_l[c]] for c in range(2)])
    perms = [pyr.perm0[c][pos[0][c]] for c in range(2)]
    lists = {}
    for name, tables in zip(SEARCHES, (pyr.neighbors, pyr.subsampling, pyr.upsampling)):
        for lvl, table in enumerate(tables):
            q, s = {"self": (lvl, lvl), "down": (lvl + 1, lvl), "up": (lvl, lvl + 1)}[name]
            lists[f"{name}{lvl}"] = [remap[s][c][table[c][pos[q][c]].long()] for c in range(2)]
    node = remap[-1]
    v = out["node_corr_valid"]
    prog = {
        "lists": lists,
        "feats_f": [backbone_out[0][c][pos[1][c]] for c in range(2)],
        "feats_c": [backbone_out[1][c][pos[-1][c]] for c in range(2)],
        "coarse": [out[k][pos[-1][c]] for c, k in enumerate(("ref_feats_c", "src_feats_c"))],
        "corr": (node[0][out["ref_node_corr_indices"].long()],
                 node[1][out["src_node_corr_indices"].long()], v),
        "lgr_transform": out["lgr_transform"],
        "estimated_transform": out["estimated_transform"],
    }
    return prog, (levels, perms)


class Runner:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.dev = cell, int(seed), device
        self.t = cell.traffic
        self.kept = {}
        self.trace = None

    def call_seed(self, i: int) -> int:
        return sub_seed(self.seed, 2, i)

    def setup(self) -> None:
        from gaussreg_tpu_torch import api
        from gaussreg_tpu_torch.config import Config
        from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint, params_from_flax
        from gaussreg_tpu_torch.models.registration import create_model
        from gaussreg_tpu_torch.ops import _cuda

        if str(self.dev).startswith("cuda"):
            _cuda.build_all()
        self.api = api
        self.cfg = spec.program_config(self.cell.config, Config)
        self.model = create_model(self.cfg, self.dev)
        if self.cell.config.get("weights"):
            state = load_checkpoint(os.path.join(spec.ROOT, self.cell.config["weights"]))
        else:
            state = params_from_flax(weights_tree(self.cell, self.seed))
        self.model.load_state_dict(state)
        self.pool = [self.pair(i) for i in range(self.t["pool"])]
        for i, pair in enumerate(self.pool):
            self._call(pair, sub_seed(self.seed, 3, i))
        sync(self.dev)

    def pair(self, i: int):
        return random_pair(self.cell.config, sub_seed(self.seed, 1, i % self.t["pool"]),
                           num_points=self.t["num_points"], tier=self.t["tier"])

    def _call(self, pair, ransac_seed: int):
        return self.api.coarse_register_clouds(self.cfg, self.model, *pair[:4],
                                               seed=ransac_seed, device=self.dev)

    def window(self, seconds: float):
        import torch

        compared = set(sample(self.seed, self.t["sample_range"], self.t["sample"]))
        clock = Clock()
        transforms = []
        i = 0
        while True:
            store, hook = {}, None
            if i in compared:
                hook = self.model.backbone.register_forward_hook(
                    lambda _m, _a, o, store=store: store.__setitem__("bb", o))
            t0 = time.perf_counter()
            out = self._call(self.pool[i % len(self.pool)], self.call_seed(i))
            sync(self.dev)
            elapsed = clock.record(t0)
            if hook is not None:
                hook.remove()
                self.kept[i] = (out, store["bb"])
            transforms.append(out["estimated_transform"])
            i += 1
            if elapsed >= seconds and i > max(compared):
                break
        self.calls, self.window_s = i, clock.seconds
        self.latencies = clock.latencies
        finite = torch.isfinite(torch.stack(transforms)).flatten(1).all(dim=1)
        failed = int((~finite).sum())
        metrics = {"pair_ms": 1e3 * clock.seconds / i,
                   "pair_p95_ms": 1e3 * percentile(clock.latencies, 95)}
        return metrics, i, failed

    def traced(self) -> trace.Trace:
        from gaussreg_tpu_torch.models import registration

        n = self.t["traced_calls"]
        spans = {}

        def run():
            for j in range(n):
                self._call(self.pool[j % len(self.pool)], sub_seed(self.seed, 4, j))
            sync(self.dev)
            return n

        wrappers = [(s, registration, a) for s, a in REGISTRATION_STAGES]
        hooks = [("backbone", self.model.backbone), ("transformer", self.model.transformer)]
        with trace.stage_ranges(hooks, wrappers), \
                trace.host_spans(spans, [("pyramid", self.api, "make_pair_batch")]):
            self.trace = trace.profile(run, STAGES)
        self.trace.host_s = spans
        self.trace.info["call_s"] = self.window_s / self.calls
        return self.trace

    def release(self) -> None:
        del self.model
        self.api = None

    def control(self):
        """{name: value}: the reference in TF32 put in the program's place on
        this seed's compared calls (no program, no window)."""
        import torch

        from portbench.reference import coarse, precision, weights

        w = weights.tensors(weights_tree(self.cell, self.seed), self.dev)
        nums = {}
        for i in sample(self.seed, self.t["sample_range"], self.t["sample"]):
            pair = self.pair(i)
            with precision(True), torch.no_grad():
                low = coarse.forward(self.cell.config, w, pair, self.call_seed(i),
                                     self.dev)
            given = (low["levels"], [torch.arange(len(pair[k]), device=self.dev) for k in (0, 2)])
            worst(nums, self.judge(w, pair, i, coarse.as_program(low), given))
        return nums

    def judge(self, w, pair, i: int, prog, given):
        import torch

        from portbench.reference import coarse, precision

        with precision(False), torch.no_grad():
            ref = coarse.forward(self.cell.config, w, pair, self.call_seed(i),
                                 self.dev, given=given)
            if "levels" in ref and "feats_c" in prog:
                ref["coarse_of_program"] = coarse.transformer(
                    self.cell.config, w, ref["levels"][-1], prog["feats_c"])
        return coarse.compare(prog, ref, pair)

    def faults(self, names):
        """{fault: {name: value}}: this seed's compared calls made by the
        program with each fault of portbench/faults.py planted, judged as
        a run judges them (set-up first; no window)."""
        from portbench import faults
        from portbench.reference import weights

        w = weights.tensors(weights_tree(self.cell, self.seed), self.dev)
        out = {}
        for name in names:
            nums = {}
            for i in sample(self.seed, self.t["sample_range"], self.t["sample"]):
                store = {}
                pair = self.pool[i % len(self.pool)]
                hook = self.model.backbone.register_forward_hook(
                    lambda _m, _a, o: store.__setitem__("bb", o))
                with faults.FAULTS[name]():
                    res = self._call(pair, self.call_seed(i))
                hook.remove()
                prog, given = program_outputs(res, store["bb"])
                worst(nums, self.judge(w, pair, i, prog, given))
                del res, prog, given
            out[name] = nums
        return out

    def check(self):
        """{name: value} over the compared calls (the worst of each), and in
        a traced run the counted work of the traced calls' pairs."""
        import torch

        from portbench.reference import coarse, precision, weights

        w = weights.tensors(weights_tree(self.cell, self.seed), self.dev)
        nums = {}
        for i, (out, backbone_out) in sorted(self.kept.items()):
            prog, given = program_outputs(out, backbone_out)
            worst(nums, self.judge(w, self.pool[i % len(self.pool)], i, prog, given))
        if self.trace is not None:
            totals = {}
            n = self.t["traced_calls"]
            for j in range(n):
                with precision(False), torch.no_grad():
                    coarse.forward(self.cell.config, w, self.pool[j % len(self.pool)],
                                   sub_seed(self.seed, 4, j), self.dev, totals=totals)
            self.trace.info.update({k: v / n for k, v in totals.items()})
        return nums
