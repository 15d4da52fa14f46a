"""Stage-by-stage diagnosis of the eval path on one pair (port of
tools/diagnose_eval.py, with the same flags and lines).

Loads a checkpoint, runs the full forward (proposals -> Sinkhorn -> LGR ->
RANSAC) and prints, per stage, the quantity that must be healthy for the
next stage to work:
  - coarse: proposal PIR (GT-overlapping fraction of proposed node pairs)
  - fine:   GT-inlier ratio of the extracted dense correspondences
  - sinkhorn: the mass the plan sends from valid ref points to the dustbin
  - LGR:    RRE/RTE/RSE of the LGR transform vs GT
  - RANSAC: RRE/RTE/RSE of the final estimated transform, inlier count

This localizes "val RR = 0" to features vs matching vs estimation
(reference's Evaluator reports the same chain: experiments/.../loss.py:94-151).

    python -m gaussreg_tpu_torch.tools.diagnose_eval --ckpt CKPT.msgpack
        [--seed N] [--tiny] [--cpu]

Runs on CUDA unless --cpu is given: without a card the default raises.
RANSAC draws its hypotheses from a torch.Generator seeded 3 (the JAX tool
uses PRNGKey(3)).
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np


def diagnose(model, cfg, batch, generator) -> Dict[str, float]:
    """The stage numbers of one eval forward of `model` on `batch` (RANSAC
    drawn with `generator`): proposals, PIR; the dense correspondences'
    count, capacity, GT-inlier ratio and median residual; the mean dustbin
    probability of valid ref points; the LGR's and RANSAC's RRE (deg), RTE
    (relative), absolute translation error, GT and estimated scale and
    RSE; RANSAC's inlier count."""
    import torch

    from gaussreg_tpu_torch.models.metrics import isotropic_transform_error
    from gaussreg_tpu_torch.ops.transforms import apply_transform

    with torch.no_grad():
        out = model(batch, generator, train=False, with_transform=True, with_gt_overlaps=True)
    host = lambda k: out[k].detach().cpu().numpy()
    gt = batch.transform.cpu().numpy().astype(np.float64)
    res: Dict[str, float] = {}

    # ---- coarse stage ----
    gt_map = host("gt_node_overlaps") > cfg.eval.acceptance_overlap
    ri, si, v = host("ref_node_corr_indices"), host("src_node_corr_indices"), host("node_corr_valid")
    res["proposals"] = int(v.sum())
    res["PIR"] = float((gt_map[ri, si] & v).sum() / max(v.sum(), 1))

    # ---- fine stage: dense correspondences from LGR extraction ----
    cv = host("corr_valid")
    sc_t = apply_transform(out["src_corr_points"], batch.transform).cpu().numpy()
    resid = np.linalg.norm(host("ref_corr_points") - sc_t, axis=-1)
    res["corrs"] = int(cv.sum())
    res["corr_capacity"] = int(cv.shape[0])
    res["IR"] = float(((resid < cfg.eval.acceptance_radius) & cv).sum()) / max(int(cv.sum()), 1)
    res["median_resid"] = float(np.median(resid[cv])) if cv.any() else float("nan")

    # ---- matching_scores health: dustbin mass ----
    plan = np.exp(host("matching_scores"))  # (P, K+1, K+1) log plan
    res["dustbin"] = float(plan[:, :-1, -1][host("ref_node_corr_knn_masks")].mean())

    for name, key in (("LGR", "lgr_transform"), ("RANSAC", "estimated_transform")):
        est = out[key].detach()
        rre, rte, rse = (float(x) for x in isotropic_transform_error(batch.transform, est))
        est = est.cpu().numpy().astype(np.float64)
        res[f"{name}_RRE"], res[f"{name}_RTE"], res[f"{name}_RSE"] = rre, rte, rse
        # absolute translation error too (synthetic t_gt can be ~0)
        res[f"{name}_RTEabs"] = float(np.linalg.norm(gt[:3, 3] - est[:3, 3]))
        res[f"{name}_scale_gt"] = float(np.cbrt(abs(np.linalg.det(gt[:3, :3]))))
        res[f"{name}_scale_est"] = float(np.cbrt(abs(np.linalg.det(est[:3, :3]))))
    res["inliers"] = float(out["ransac_inliers"])
    return res


def report(res: Dict[str, float], cfg) -> List[str]:
    """The JAX tool's lines for `diagnose`'s numbers."""
    r = cfg.eval.acceptance_radius
    lines = [
        f"[coarse] proposals={res['proposals']} PIR={res['PIR']:.3f}",
        f"[fine]   corrs={res['corrs']}/{res['corr_capacity']} IR@{r}={res['IR']:.3f} "
        f"median_resid={res['median_resid']:.3f}",
        f"[sinkhorn] mean P(ref point -> dustbin) over valid = {res['dustbin']:.3f}",
    ]
    for name in ("LGR   ", "RANSAC"):
        k = name.strip()
        lines.append(
            f"[{name}] RRE={res[k + '_RRE']:.2f}deg RTEabs={res[k + '_RTEabs']:.3f} "
            f"scale gt={res[k + '_scale_gt']:.3f} est={res[k + '_scale_est']:.3f} "
            f"RSE={res[k + '_RSE']:.3f}"
        )
    lines.append(f"[ransac] inliers={res['inliers']:.0f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--seed", type=int, default=10_000_000)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    model = create_model(cfg, dev)
    model.load_state_dict(load_checkpoint(args.ckpt))
    batch = make_pair_batch(cfg, *random_pair(cfg, args.seed), device=dev)
    res = diagnose(model, cfg, batch, torch.Generator(device=dev).manual_seed(3))
    for line in report(res, cfg):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
