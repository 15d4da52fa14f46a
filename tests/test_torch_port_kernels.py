"""The port's plain versions of the three TPU kernels on its path, against
the JAX package's Pallas kernels run in interpret mode on the same inputs
(made with numpy from a seed).

- K1 window_select_idx and K3 select_min_k: index-for-index and
  value-for-value (tolerance 0): both sides compute the same f32 d2 with
  the same operation order, and ties go to the smaller position. K1's
  in-place entry window_select_runs likewise, against the Pallas kernel on
  windows gathered from the same sorted planes.
- K2 kpconv_fused_apply: bf16 products are exact in f32 on both sides, but
  the f32 sums over the neighbor slots run in another order, so a weighted
  sum can round to the neighbouring bf16 value (one step = 2^-8 relative).
  Tolerance: 4e-3 of the output's max magnitude, one such step.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)  # several xdist workers share the cores


def _windows(seed, p=64, nruns=9, wspan=128):
    rng = np.random.default_rng(seed)
    w = nruns * wspan
    # coordinates on a coarse lattice: many exactly equal distances (ties)
    q = np.zeros((p, 8), np.float32)
    q[:, :3] = rng.integers(0, 8, size=(p, 3)) / 8.0
    planes = [(rng.integers(0, 8, size=(p, w)) / 8.0).astype(np.float32) for _ in range(3)]
    widx = rng.integers(0, 5000, size=(p, w)).astype(np.int32)
    ls = rng.integers(0, wspan + 1, size=(p, nruns))
    le = np.minimum(ls + rng.integers(0, 40, size=(p, nruns)), wspan)
    le[:4] = ls[:4]  # rows with no valid candidate at all
    le[4:8, 1:] = ls[4:8, 1:]  # rows with fewer valid candidates than limit
    lsle = np.concatenate([ls, le], axis=1).astype(np.int32)
    return q, lsle, planes, widx


@pytest.mark.parametrize("seed,limit", [(0, 35), (1, 4)])
def test_window_select_plain_matches_pallas(seed, limit):
    from gaussreg_tpu.ops.fused_select import window_select_idx as jax_select
    from gaussreg_tpu_torch.ops.fused_select import window_select_idx

    q, lsle, (wx, wy, wz), widx = _windows(seed)
    d2_j, idx_j = jax_select(
        jnp.asarray(q), jnp.asarray(lsle), jnp.asarray(wx), jnp.asarray(wy),
        jnp.asarray(wz), jnp.asarray(widx), limit, nruns=9, wspan=128, interpret=True,
    )
    t = torch.from_numpy
    d2_t, idx_t = window_select_idx(
        t(q), t(lsle), t(wx), t(wy), t(wz), t(widx), limit, nruns=9, wspan=128
    )
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))


def _sorted_planes(seed, b, m, nruns, window_rows, extra_rows=3):
    """Two batches of sorted (B, r_tot, 128) planes on a coarse lattice
    (ties), the padded order plane, and per query its runs' window rows and
    local bounds: windows that end at the planes' padded end, rows with no
    valid candidate and rows with fewer than most limits."""
    rng = np.random.default_rng(seed)
    wspan = window_rows * 128
    r_tot = window_rows + extra_rows
    planes = [(rng.integers(0, 8, size=(b, r_tot, 128)) / 8.0).astype(np.float32)
              for _ in range(3)]
    order = rng.integers(0, 5000, size=(b, r_tot, 128)).astype(np.int32)
    q = np.zeros((b * m, 8), np.float32)
    q[:, :3] = rng.integers(0, 8, size=(b * m, 3)) / 8.0
    wrow = rng.integers(0, r_tot - window_rows + 1, size=(b * m, nruns)).astype(np.int32)
    wrow[::4] = r_tot - window_rows  # windows that end at the padded end
    ls = rng.integers(0, 128, size=(b * m, nruns))
    le = np.minimum(ls + rng.integers(0, wspan, size=(b * m, nruns)), wspan)
    le[:3] = ls[:3]  # no valid candidate
    le[3:7, 1:] = np.minimum(ls[3:7, 1:] + 1, wspan)  # a few valid candidates
    lsle = np.concatenate([ls, le], axis=1).astype(np.int32)
    return q, lsle, wrow, planes, order, wspan


@pytest.mark.parametrize("seed,limit,window_rows,nruns",
                         [(0, 35, 2, 9), (1, 4, 1, 9), (2, 60, 2, 4), (3, 1, 1, 4)])
def test_window_select_runs_matches_pallas(seed, limit, window_rows, nruns):
    """K1 in place on the CPU (its plain version: the windows gathered from
    the sorted planes, then the selection) against the Pallas kernel run
    interpreted on windows gathered from the same planes as the JAX grid
    search gathers them (one whole-row gather per plane)."""
    from gaussreg_tpu.ops.fused_select import window_select_idx as jax_select
    from gaussreg_tpu_torch.ops.fused_select import window_select_runs

    b, m = 2, 70
    q, lsle, wrow, planes, order, wspan = _sorted_planes(seed, b, m, nruns, window_rows)
    r_tot = planes[0].shape[1]
    base = wrow + (np.arange(b * m) // m * r_tot)[:, None]
    ridx = (base[:, :, None] + np.arange(window_rows)).reshape(-1)
    gather = lambda plane: jnp.asarray(plane).reshape(b * r_tot, 128)[ridx].reshape(b * m, -1)
    d2_j, idx_j = jax_select(
        jnp.asarray(q), jnp.asarray(lsle), *(gather(pl) for pl in (*planes, order)), limit,
        nruns=nruns, wspan=wspan, interpret=True,
    )
    t = torch.from_numpy
    d2_t, idx_t = window_select_runs(
        t(q[:, :3].copy()), t(lsle), t(wrow), *(t(pl) for pl in planes), t(order), limit,
        nruns, wspan,
    )
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))
    assert (d2_t.numpy()[:3] == np.finfo(np.float32).max).all()  # the rows with no candidate


@pytest.mark.parametrize("bad", [-1, 4])
def test_window_select_runs_rejects_a_window_outside_the_planes(bad):
    """A window row below 0 or one whose window ends past the planes' r_tot
    rows (here r_tot = 5, window_rows = 2: the last start is 3) raises on
    the CPU, where the gather would read another batch's rows or fail."""
    from gaussreg_tpu_torch.ops.fused_select import window_select_runs

    q, lsle, wrow, planes, order, wspan = _sorted_planes(0, 2, 8, 9, 2)
    assert planes[0].shape[1] == 5
    t = torch.from_numpy
    ok = window_select_runs(t(q[:, :3].copy()), t(lsle), t(wrow), *(t(pl) for pl in planes),
                            t(order), 4, 9, wspan)
    assert ok[0].shape == (16, 4)
    wrow[-1, -1] = bad
    with pytest.raises(ValueError, match="outside the planes"):
        window_select_runs(t(q[:, :3].copy()), t(lsle), t(wrow), *(t(pl) for pl in planes),
                           t(order), 4, 9, wspan)


@pytest.mark.parametrize(
    "b,m,h,c,k,d",
    [
        (1, 64, 8, 4, 15, 64),  # the ConvBlock's 4 input channels
        (2, 48, 16, 64, 15, 64),  # rows not a multiple of the TPU block
        (1, 32, 8, 512, 15, 512),  # the widest stage
    ],
)
def test_kpconv_plain_matches_pallas_and_einsum(b, m, h, c, k, d):
    from gaussreg_tpu.ops.kpconv_kernel import _fused_apply_impl, _reference_apply
    from gaussreg_tpu_torch.ops.kpconv_kernel import kpconv_fused_apply

    rng = np.random.default_rng(c)
    nf = jnp.asarray(rng.normal(size=(b, m, h, c)), jnp.bfloat16)
    infl = jnp.asarray(np.maximum(rng.normal(size=(b, m, h, k)), 0), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(k, c, d)), jnp.float32)
    ref = np.asarray(_reference_apply(nf, infl, w))

    kp, dp = 16, ((d + 127) // 128) * 128
    infl_p = jnp.pad(infl, ((0, 0), (0, 0), (0, 0), (0, kp - k)))
    w2 = jnp.pad(w.astype(jnp.bfloat16), ((0, kp - k), (0, 0), (0, dp - d))).reshape(kp * c, dp)
    pallas = np.asarray(
        _fused_apply_impl(
            nf.reshape(b * m, h * c), infl_p.reshape(b * m, h * kp), w2,
            he=h, kp=kp, c=c, block_rows=128, interpret=True,
        )
    )[:, :d].reshape(b, m, d)

    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    out = kpconv_fused_apply(to_t(nf), to_t(infl), torch.from_numpy(np.asarray(w))).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=4e-3 * scale)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=4e-3 * scale)


@pytest.mark.parametrize("k", [3, 35])
def test_select_min_k_plain_matches_pallas(k):
    from gaussreg_tpu.ops.select_k import select_min_k as jax_select
    from gaussreg_tpu_torch.ops.select_k import select_min_k

    rng = np.random.default_rng(k)
    # negated positive scores, as the matching thresholds use, with ties
    x = -np.exp(rng.integers(-20, 5, size=(96, 128)) / 4.0).astype(np.float32)
    vj, pj = jax_select(jnp.asarray(x), k, interpret=True)
    vt, pt = select_min_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("k", [129, 300])
def test_select_min_k_plain_matches_pallas_past_128(k):
    """k past 128, where the Pallas kernel pads its outputs to 256 and 384
    lanes, on rows of many ties, zeros of both signs and a descending row:
    index for index and value for value."""
    from gaussreg_tpu.ops.select_k import select_min_k as jax_select
    from gaussreg_tpu_torch.ops.select_k import select_min_k_plain

    rng = np.random.default_rng(k)
    x = (rng.integers(0, 64, size=(16, 384)) / 8.0 - 4.0).astype(np.float32)
    x[0] = 0.0
    x[0, ::2] = -0.0
    x[1, ::3] = -0.0
    x[2] = np.arange(384, 0, -1)
    vj, pj = jax_select(jnp.asarray(x), k, block_rows=8, interpret=True)
    vt, pt = select_min_k_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_select_min_k_any_width():
    """The port takes widths that are not multiples of 128 (the tiny
    configuration's patches are 16 wide)."""
    from gaussreg_tpu_torch.ops.select_k import select_min_k

    x = torch.tensor([[3.0, 1.0, 2.0, 1.0, 0.5]])
    vals, pos = select_min_k(x, 3)
    assert vals.tolist() == [[0.5, 1.0, 1.0]]
    assert pos.tolist() == [[4, 1, 3]]
