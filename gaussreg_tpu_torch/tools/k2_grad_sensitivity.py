"""How far one train step's KPConv weight gradients move with the last bits
of the forward, and how far a faulty K2 moves them, at make_tiny_cfg() on
one CUDA card.

    python -m gaussreg_tpu_torch.tools.k2_grad_sensitivity [--seeds 4]

The step is tests/test_torch_port_cuda.py's: random_pair(cfg, 0,
num_points=500), weights from reset_parameters(Generator().manual_seed(0)),
the GT draw fed numpy's default_rng(0) Gumbel noise, one train-mode forward
(with_transform=False), the overall loss and its backward. Per KPConv
weight leaf, each reading is max |g - g_plain| / max |g_plain|, with
g_plain the gradient with K2's plain version (reference_apply) in its place:

- kernel: the gradient through K2, as shipped, against g_plain taken
  anew (--seeds pairs of runs; the largest reading);
- plain_sens / kernel_sens: the plain (or kernel) path's own gradient with
  every weight moved by 1e-6 of itself (--seeds draws; the largest reading),
  against the same path unmoved: the chaos of the forward's last bits;
- fault_*: K2 with a planted fault, each a wrapper around the kernel that
  corrupts one part of its inputs or output: `kpoint` drops the last kernel
  point (its influences zeroed), `neighbour` drops every query's last
  neighbour column, `tail` zeroes the output's last 32 rows (a missed row
  block);
- plain_again: the plain path run once more, unmoved (the run-to-run
  spread: the gather's backward, index_add_, sums with atomics on the card).

Prints a line per leaf, the card's name and power limit, and all of it as
one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from gaussreg_tpu_torch.models import kpconv as kpconv_mod
from gaussreg_tpu_torch.models import registration as reg_mod
from gaussreg_tpu_torch.ops import kpconv_kernel as kk


def _kpoint(nf, infl, w):
    infl = infl.clone()
    infl[..., -1] = 0
    return kk.kpconv_fused_apply(nf, infl, w)


def _neighbour(nf, infl, w):
    infl = infl.clone()
    infl[..., -1, :] = 0
    return kk.kpconv_fused_apply(nf, infl, w)


def _tail(nf, infl, w):
    out = kk.kpconv_fused_apply(nf, infl, w)
    mask = torch.ones(out.shape[0] * out.shape[1], 1, device=out.device, dtype=out.dtype)
    mask[-32:] = 0
    return out * mask.reshape(out.shape[:2] + (1,))


FAULTS = {"kpoint": _kpoint, "neighbour": _neighbour, "tail": _tail}


def weight_grads(cfg, batch, model, gumbel, apply):
    """One train step's KPConv weight gradients by name, K2 as `apply`."""
    from gaussreg_tpu_torch.models.losses import overall_loss
    from gaussreg_tpu_torch.models.matching import sample_gt_node_correspondences_from_gumbel

    saved = kpconv_mod.kpconv_fused_apply, reg_mod.sample_gt_node_correspondences
    kpconv_mod.kpconv_fused_apply = apply
    reg_mod.sample_gt_node_correspondences = (
        lambda gen, *a: sample_gt_node_correspondences_from_gumbel(gumbel, *a))
    try:
        model.zero_grad(set_to_none=True)
        out = model(batch, None, train=True, with_transform=False)
        overall_loss(cfg, out, batch.transform)["loss"].backward()
    finally:
        kpconv_mod.kpconv_fused_apply, reg_mod.sample_gt_node_correspondences = saved
    return {n: p.grad.clone() for n, p in model.named_parameters() if n.endswith("conv.weights")}


def rel(a, b):
    return {n: float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in b}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_grad_sensitivity: needs a CUDA card")
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair

    dev = torch.device("cuda")
    cfg = make_tiny_cfg()
    batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=500), device=dev)
    model = reg_mod.create_model(cfg, dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    nc = batch.pyramid.points[-1].shape[1]
    gumbel = torch.from_numpy(np.random.default_rng(0).gumbel(size=(nc, nc)).astype(np.float32))
    gumbel = gumbel.to(dev)
    paths = {"plain": kk.reference_apply, "kernel": kk.kpconv_fused_apply}

    base = {p: weight_grads(cfg, batch, model, gumbel, f) for p, f in paths.items()}
    grads = lambda f: weight_grads(cfg, batch, model, gumbel, f)
    readings = {"kernel": dict.fromkeys(base["plain"], 0.0),
                "plain_again": rel(grads(paths["plain"]), base["plain"])}
    for _ in range(args.seeds):
        for n, x in rel(grads(paths["kernel"]), grads(paths["plain"])).items():
            readings["kernel"][n] = max(readings["kernel"][n], x)
    for fault, f in FAULTS.items():
        readings["fault_" + fault] = rel(grads(f), base["plain"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p, f in paths.items():
        sens = dict.fromkeys(base[p], 0.0)
        for seed in range(args.seeds):
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for n, q in model.named_parameters():
                    q.copy_(start[n] * (1 + 1e-6 * torch.randn(q.shape, generator=gen).to(dev)))
            for n, x in rel(grads(f), base[p]).items():
                sens[n] = max(sens[n], x)
        readings[p + "_sens"] = sens
    with torch.no_grad():
        for n, q in model.named_parameters():
            q.copy_(start[n])

    cols = list(readings)
    print("leaf " + " ".join(f"{c:>16s}" for c in cols))
    for n in base["plain"]:
        print(n + " " + " ".join(f"{readings[c][n]:16.5f}" for c in cols), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    print(json.dumps({"readings": readings, "card": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
