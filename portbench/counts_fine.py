"""Frozen count functions of the fine cell's kernels: the work a render's
function needs, from the plain reference's own pixel-gaussian work
(portbench/reference/fine.py `render(..., count=True)`), never from the
program's intermediates, so they count the same work whatever implements
it. A render's work: `pixel_pairs` (pixel-gaussian pairs composited, alpha
>= 1/255 before the pixel's stop), `tile_pairs` (gaussian-tile pairs with
any such pixel, on the 32x32 tile grid), `gaussians` (gaussians with any)
and `pixels`. Bytes count each input once and each output once: a gaussian's
six exponent coefficients and four colour channels (40 B), a pair's id
(4 B), a pixel's five output planes (20 B) or its seven cotangent planes
(28 B), a pair's or a gaussian's ten gradient channels (40 B). Operations
are float32 (peaks.F32_FLOPS)."""

from __future__ import annotations

from typing import Dict

# float32 operations per composited pixel-gaussian pair: K4 the exponent's
# five products and five sums, its exp, the cut and cap, T alpha, four
# colour products and sums, T's update (22); K5 the same exponent and alpha,
# the colour and transmittance cotangents, ten gradient products and sums
# (40); K6 ten sums per gaussian-tile row
K4_OPS, K5_OPS, K6_OPS = 22.0, 40.0, 10.0


def _scaled(work: Dict[str, float], renders: float) -> Dict[str, float]:
    return {k: v * renders for k, v in work.items()}


def k4_counts(work: Dict[str, float], renders: float = 1.0) -> Dict[str, float]:
    """K4 (rasterize forward) over `renders` renders of `work`."""
    w = _scaled(work, renders)
    return {"bytes": 40.0 * w["gaussians"] + 4.0 * w["tile_pairs"] + 20.0 * w["pixels"],
            "bf16_flops": 0.0, "f32_flops": K4_OPS * w["pixel_pairs"]}


def k5_counts(work: Dict[str, float], renders: float = 1.0) -> Dict[str, float]:
    """K5 (rasterize backward): the gaussians and the pixels' cotangents in,
    a gradient row per gaussian-tile pair out."""
    w = _scaled(work, renders)
    return {"bytes": 40.0 * w["gaussians"] + 28.0 * w["pixels"] + 40.0 * w["tile_pairs"],
            "bf16_flops": 0.0, "f32_flops": K5_OPS * w["pixel_pairs"]}


def k6_counts(work: Dict[str, float], renders: float = 1.0) -> Dict[str, float]:
    """K6 (per-gaussian accumulation): the gaussian-tile rows in, a gradient
    row per gaussian out."""
    w = _scaled(work, renders)
    return {"bytes": 40.0 * w["tile_pairs"] + 40.0 * w["gaussians"],
            "bf16_flops": 0.0, "f32_flops": K6_OPS * w["tile_pairs"]}


def mean_work(works) -> Dict[str, float]:
    """The mean of renders' work dicts."""
    works = list(works)
    return {k: sum(w[k] for w in works) / len(works) for k in works[0]}


def total_work(works) -> Dict[str, float]:
    works = list(works)
    return {k: sum(w[k] for w in works) for k in works[0]}


def add(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: a[k] + b[k] for k in a}
