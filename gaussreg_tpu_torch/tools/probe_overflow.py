"""Quantify capacity and search overflow across synthetic pairs (port of
tools/probe_overflow.py, with the same flags and lines, plus --tiny and
--cpu).

Checks whether the vox_overflow counter seen in training logs corresponds
to actual degradation: per-level true voxel counts against capacities, the
grid-run search_overflow entry count, and the ground truth that matters,
the recall of the neighbor lists against an exact brute-force radius
search, for both clouds of the pair and for the cross-level subsampling
searches (all of which contribute to search_overflow;
data/pipeline.py build_pyramid).

Recall is compared on distance values with a float32-epsilon tolerance, not
strict index membership: equidistant points at the k-th boundary or
round-off near radius^2 are not real misses.

    python -m gaussreg_tpu_torch.tools.probe_overflow [--seeds 0 1 2 ...]
        [--sample 512] [--tiny] [--cpu]

The pyramid is built on the device (on a card, every search a window
selection); the brute force stays numpy on the host. Runs on CUDA unless
--cpu is given: without a card the default raises.
"""

from __future__ import annotations

import argparse

import numpy as np


def _recall(pts_q, msk_q, pts_s, msk_s, nbr, radius):
    """Distance-multiset recall of a padded neighbor list vs brute force.

    A neighbor list entry is correct if its distance is within eps of some
    true neighbor distance; the list may keep any `limit`-subset of the true
    neighbors provided it keeps the nearest ones (up to distance ties)."""
    n_s = pts_s.shape[0]
    limit = nbr.shape[1]
    q_idx = np.where(msk_q)[0]
    d2 = ((pts_q[q_idx][:, None] - pts_s[None]) ** 2).sum(-1)
    r2 = radius * radius
    eps = 1e-6 + 1e-4 * r2
    inball = (d2 <= r2 + eps) & msk_s[None, :]
    missing = total = truncated_true = 0
    for i, qi in enumerate(q_idx):
        exact = np.where(inball[i])[0]
        got = nbr[qi][nbr[qi] < n_s]
        k = min(len(exact), limit)
        if k == 0:
            continue
        exact_d = np.sort(d2[i][exact])[:k]
        got_d = np.sort(d2[i][got]) if got.size else np.empty(0)
        # k-th-distance tolerant: every exact distance strictly below the
        # k-th got distance (minus eps) that has no counterpart is a miss
        miss = 0
        j = 0
        for ed in exact_d:
            while j < got_d.size and got_d[j] < ed - eps:
                j += 1
            if j < got_d.size and abs(got_d[j] - ed) <= eps:
                j += 1
            elif got_d.size and ed >= got_d[-1] - eps:
                pass  # beyond the list's k-th distance: a valid truncation
            else:
                miss += 1
        missing += miss
        total += k
        if len(exact) > limit:
            truncated_true += 1
    return missing, total, truncated_true, len(q_idx)


def _sample_mask(rng, msk, sample):
    """`msk` with at most `sample` of its set entries kept, drawn by `rng`."""
    valid = np.where(msk)[0]
    if valid.size <= sample:
        return msk
    keep = rng.choice(valid, size=sample, replace=False)
    qm = np.zeros_like(msk)
    qm[keep] = True
    return qm


def probe_pair(cfg, seed, sample=512, quiet=False, device=None):
    """Build pair `seed`'s batch on `device` (default cuda) and return
    (search_overflow, rows), one row (name, recall, missing, total,
    queries with more true neighbors than the limit, queries) per level,
    cloud and search (`self`, and `sub` into the next level's points)."""
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair

    pb = make_pair_batch(cfg, *random_pair(cfg, seed), device=device)
    pyr = pb.pyramid
    overflow = int(pyr.search_overflow)
    if not quiet:
        print(f"--- seed {seed}: search_overflow={overflow}")
        for lvl, (nv, cap) in enumerate(zip(pyr.num_voxels, cfg.capacity.levels)):
            print(f"  level {lvl}: num_voxels={nv.cpu().numpy()} capacity={cap}")

    host = lambda t: t.cpu().numpy()
    rng = np.random.default_rng(0)
    results = []
    radius = cfg.backbone.init_radius
    for lvl in range(len(cfg.capacity.levels)):
        for b, name in ((0, "ref"), (1, "src")):
            pts = host(pyr.points[lvl][b])
            msk = host(pyr.masks[lvl][b]).copy()
            # sample queries to keep brute force tractable
            qm = _sample_mask(rng, msk, sample)
            miss, tot, trunc, nq = _recall(pts, qm, pts, msk, host(pyr.neighbors[lvl][b]), radius)
            results.append((f"L{lvl}/{name}/self", 1 - miss / max(tot, 1), miss, tot, trunc, nq))
            # subsampling search: queries = level lvl+1 points
            if lvl < len(cfg.capacity.levels) - 1:
                pts_q = host(pyr.points[lvl + 1][b])
                qm2 = _sample_mask(rng, host(pyr.masks[lvl + 1][b]).copy(), sample)
                miss, tot, trunc, nq = _recall(
                    pts_q, qm2, pts, msk, host(pyr.subsampling[lvl][b]), radius,
                )
                results.append((f"L{lvl}/{name}/sub", 1 - miss / max(tot, 1), miss, tot,
                                trunc, nq))
        radius *= 2.0
    if not quiet:
        for name, rec, miss, tot, trunc, nq in results:
            print(
                f"  {name:14s} recall={rec:.4f} ({miss}/{tot} missing), "
                f"queries with >limit true neighbors: {trunc}/{nq}"
            )
    return overflow, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[12345, 0, 3, 7])
    ap.add_argument("--sample", type=int, default=512)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny capacities (CPU smoke run of the tool itself)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg
    from gaussreg_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    worst = 1.0
    for seed in args.seeds:
        overflow, results = probe_pair(cfg, seed, sample=args.sample, device=dev)
        worst = min(worst, min(r[1] for r in results))
    print(f"worst recall across seeds/levels/clouds: {worst:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
