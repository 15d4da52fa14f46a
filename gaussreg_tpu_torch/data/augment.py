"""Generic point-cloud augmentation library on the host, with an explicit
RNG (port of gaussreg_tpu/data/augment.py, a copy: the same numpy code,
so the same draws from the same generator state).

reference: geotransformer/transforms/functional.py:7-162. Two deliberate
design changes against the reference:

* every random op takes an explicit ``numpy.random.Generator``: no global
  ``np.random``/``random`` state;
* ops are pure: inputs are never mutated (the reference's
  ``random_dropout_points`` writes into its argument).

These run in the host data path (a dataset's ``__getitem__``) before
batches are moved to the device, so numpy is the right layer; the rigid
pose re-augmentation of a built batch is
``data/pipeline.py:augment_pair_pose``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

Array = np.ndarray


def _with_normals(points, normals, sel_or_none=None):
    if sel_or_none is not None:
        points = points[sel_or_none]
        if normals is not None:
            normals = normals[sel_or_none]
    if normals is not None:
        return points, normals
    return points


def normalize_points(points: Array) -> Array:
    """Center at the origin and scale into the unit sphere
    (reference functional.py:7-11)."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


def sample_points(points: Array, num_samples: int, normals: Optional[Array] = None):
    """Keep the first K points (reference functional.py:14-21)."""
    return _with_normals(points, normals, slice(None, num_samples))


def random_sample_points(
    points: Array,
    num_samples: int,
    rng: np.random.Generator,
    normals: Optional[Array] = None,
):
    """Random permutation truncated/tiled to exactly ``num_samples``
    (reference functional.py:24-42: undersized clouds are repeated)."""
    n = points.shape[0]
    sel = rng.permutation(n)
    if n >= num_samples:
        sel = sel[:num_samples]
    else:
        reps = num_samples // n
        pad = num_samples % n
        sel = np.concatenate([sel] * reps + ([sel[:pad]] if pad else []))
    return _with_normals(points, normals, sel)


def random_scale_shift_points(
    points: Array,
    rng: np.random.Generator,
    low: float = 2.0 / 3.0,
    high: float = 3.0 / 2.0,
    shift: float = 0.2,
    normals: Optional[Array] = None,
):
    """Anisotropic per-axis scale + shift; normals are rescaled and
    re-normalized (reference functional.py:45-55)."""
    scale = rng.uniform(low=low, high=high, size=(1, 3))
    bias = rng.uniform(low=-shift, high=shift, size=(1, 3))
    out = points * scale + bias
    if normals is not None:
        normals = normals * scale
        normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
        return out, normals
    return out


def random_rotate_points_along_up_axis(
    points: Array, rng: np.random.Generator, normals: Optional[Array] = None
):
    """Random yaw about +z (reference functional.py:58-73)."""
    theta = rng.random() * 2.0 * math.pi
    c, s = math.cos(theta), math.sin(theta)
    rot_t = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    out = points @ rot_t
    if normals is not None:
        return out, normals @ rot_t
    return out


def random_rescale_points(
    points: Array, rng: np.random.Generator, low: float = 0.8, high: float = 1.2
) -> Array:
    """Isotropic random rescale (reference functional.py:76-80)."""
    return points * rng.uniform(low, high)


def random_jitter_points(
    points: Array,
    rng: np.random.Generator,
    scale: float,
    noise_magnitude: float = 0.05,
) -> Array:
    """Clipped gaussian positional jitter (reference functional.py:83-87)."""
    noise = np.clip(
        rng.normal(scale=scale, size=points.shape),
        a_min=-noise_magnitude,
        a_max=noise_magnitude,
    )
    return points + noise


def random_shuffle_points(
    points: Array, rng: np.random.Generator, normals: Optional[Array] = None
):
    """Random permutation of point order (reference functional.py:90-99)."""
    return _with_normals(points, normals, rng.permutation(points.shape[0]))


def random_dropout_points(
    points: Array, rng: np.random.Generator, max_p: float
) -> Array:
    """PointNet++-style dropout: each point is replaced by point 0 with a
    per-point random probability in [0, max_p) (reference
    functional.py:102-108 — which mutates in place; this copy does not)."""
    n = points.shape[0]
    p = rng.random(n) * max_p
    masks = rng.random(n) < p
    out = points.copy()
    out[masks] = points[0]
    return out


def random_jitter_features(
    features: Array,
    rng: np.random.Generator,
    mu: float = 0.0,
    sigma: float = 0.01,
    prob: float = 0.95,
) -> Array:
    """FCGF-style feature jitter, applied with probability ``prob``
    (reference functional.py:111-115)."""
    if rng.random() < prob:
        features = features + rng.normal(mu, sigma, features.shape).astype(
            features.dtype
        )
    return features


def random_sample_plane(rng: np.random.Generator) -> Array:
    """Unit normal of a random plane through the origin
    (reference functional.py:118-128)."""
    phi = rng.uniform(0.0, 2 * np.pi)
    theta = rng.uniform(0.0, np.pi)
    return np.array(
        [
            np.sin(theta) * np.cos(phi),
            np.sin(theta) * np.sin(phi),
            np.cos(theta),
        ]
    )


def random_crop_points_with_plane(
    points: Array,
    rng: np.random.Generator,
    p_normal: Optional[Array] = None,
    keep_ratio: float = 0.7,
    normals: Optional[Array] = None,
):
    """Keep the ``keep_ratio`` fraction of points on the far side of a random
    plane (reference functional.py:131-144)."""
    num_samples = int(math.floor(points.shape[0] * keep_ratio + 0.5))
    if p_normal is None:
        p_normal = random_sample_plane(rng)
    distances = points @ p_normal
    sel = np.argsort(-distances)[:num_samples]
    return _with_normals(points, normals, sel)


def random_sample_viewpoint(rng: np.random.Generator, limit: float = 500.0) -> Array:
    """A far-away observing point in one of the 8 octants
    (reference functional.py:147-149)."""
    return rng.random(3) + limit * rng.choice([1.0, -1.0], size=3)


def random_crop_points_from_viewpoint(
    points: Array,
    rng: np.random.Generator,
    viewpoint: Optional[Array] = None,
    keep_ratio: float = 0.7,
    normals: Optional[Array] = None,
):
    """Keep the ``keep_ratio`` fraction of points nearest a random viewpoint —
    a crude visibility crop (reference functional.py:152-162)."""
    num_samples = int(math.floor(points.shape[0] * keep_ratio + 0.5))
    if viewpoint is None:
        viewpoint = random_sample_viewpoint(rng)
    distances = np.linalg.norm(viewpoint - points, axis=1)
    sel = np.argsort(distances)[:num_samples]
    return _with_normals(points, normals, sel)
