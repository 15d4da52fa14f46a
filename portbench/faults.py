"""Faults planted in the program, each a context manager that breaks one
layer of the coarse call underneath while inside: the readings that a
broken timed path gives set the upper ends of the limits the control does
not reach (PERF.md), and the CPU tests show each makes a run not correct.
Never used by a benchmark run."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def transform_altered():
    """RANSAC's answer moved by 0.5 along x, past the configuration's
    registration limit (eval.rmse_threshold 0.2)."""
    from gaussreg_tpu_torch.models import registration

    def make(orig):
        def altered(*args, **kwargs):
            transform, inliers = orig(*args, **kwargs)
            transform = transform.clone()
            transform[:3, 3] += 0.5
            return transform, inliers
        return altered

    return _patched(registration, "ransac_similarity", make)


def backbone_altered():
    """The backbone's fine features 1 % too large."""
    from gaussreg_tpu_torch.models.backbone import KPConvFPN

    def make(orig):
        def altered(self, feats, pyramid):
            feats_f, feats_c = orig(self, feats, pyramid)
            return feats_f * 1.01, feats_c
        return altered

    return _patched(KPConvFPN, "forward", make)


def neighbour_altered():
    """In every pyramid, one neighbour of one level-0 list points at
    another point (the first of a pyramid's 13 searches)."""
    from gaussreg_tpu_torch.data import pipeline

    calls = []

    def make(orig):
        def altered(q, s, *args, **kwargs):
            idx, overflow = orig(q, s, *args, **kwargs)
            calls.append(1)
            if len(calls) % 13 == 1:
                idx = idx.clone()
                idx[0, 5, 0] = (idx[0, 5, 0] + 7) % s.shape[1]
            return idx, overflow
        return altered

    return _patched(pipeline, "grid_radius_search", make)


def point_moved():
    """In every pyramid, one point of level 1 moved by a millimetre (the
    first of a pyramid's 8 subsamplings)."""
    from gaussreg_tpu_torch.data import pipeline

    calls = []

    def make(orig):
        def altered(points, mask, voxel, capacity):
            p, m, n = orig(points, mask, voxel, capacity)
            calls.append(1)
            if len(calls) % 8 == 1:
                p = p.clone()
                p[3, 0] += 1e-3
            return p, m, n
        return altered

    return _patched(pipeline, "grid_subsample", make)


FAULTS = {
    "transform": transform_altered,
    "backbone": backbone_altered,
    "neighbour": neighbour_altered,
    "point": point_moved,
}
