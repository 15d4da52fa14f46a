"""The port's augmentation library (gaussreg_tpu_torch/data/augment.py)
against the JAX package's (gaussreg_tpu/data/augment.py): each of the 14
public functions, with and without normals where it takes them, from the
same `np.random.default_rng(seed)` state. Both are numpy code, so the
outputs and the generators' states after the call must be equal bit for
bit (tolerance 0)."""

import numpy as np
import pytest

from gaussreg_tpu.data import augment as jax_aug
from gaussreg_tpu_torch.data import augment as port_aug


def _cloud():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)) * [2.0, 1.0, 0.5] + [5.0, -3.0, 1.0]
    normals = rng.normal(size=(300, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(size=(300, 4)).astype(np.float32)
    return pts, normals, feats


# (function, call): `call(fn, pts, normals, feats, rng)` runs one case
CASES = {
    "normalize_points": lambda f, p, n, x, r: f(p),
    "sample_points": lambda f, p, n, x, r: f(p, 100, normals=n),
    "random_sample_points": lambda f, p, n, x, r: f(p, 100, r, normals=n),
    "random_sample_points_tiled": lambda f, p, n, x, r: f(p[:40], 100, r),
    "random_scale_shift_points": lambda f, p, n, x, r: f(p, r, normals=n),
    "random_rotate_points_along_up_axis": lambda f, p, n, x, r: f(p, r, normals=n),
    "random_rescale_points": lambda f, p, n, x, r: f(p, r),
    "random_jitter_points": lambda f, p, n, x, r: f(p, r, 0.01),
    "random_shuffle_points": lambda f, p, n, x, r: f(p, r, normals=n),
    "random_dropout_points": lambda f, p, n, x, r: f(p, r, 0.5),
    "random_jitter_features": lambda f, p, n, x, r: f(x, r),
    "random_sample_plane": lambda f, p, n, x, r: f(r),
    "random_crop_points_with_plane": lambda f, p, n, x, r: f(p, r, normals=n),
    "random_sample_viewpoint": lambda f, p, n, x, r: f(r),
    "random_crop_points_from_viewpoint": lambda f, p, n, x, r: f(p, r, normals=n),
    "random_crop_points_from_viewpoint_no_normals": lambda f, p, n, x, r: f(p, r, keep_ratio=0.4),
}


def _function(case: str) -> str:
    for suffix in ("_tiled", "_no_normals"):
        case = case.removesuffix(suffix)
    return case


def test_cases_cover_every_public_function():
    public = {n for n in dir(jax_aug) if not n.startswith("_") and callable(getattr(jax_aug, n))
              and getattr(getattr(jax_aug, n), "__module__", "") == jax_aug.__name__}
    assert public == {_function(c) for c in CASES} and len(public) == 14


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 5])
def test_augment_function_bit_equal_to_jax(case, seed):
    name = _function(case)
    outs, states = [], []
    for module in (jax_aug, port_aug):
        pts, normals, feats = _cloud()
        rng = np.random.default_rng(seed)
        out = CASES[case](getattr(module, name), pts, normals, feats, rng)
        outs.append(out if isinstance(out, tuple) else (out,))
        states.append(rng.bit_generator.state)
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert states[0] == states[1]
