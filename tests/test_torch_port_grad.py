"""K2's backward and K3's fused thresholds: the port's plain versions
against the JAX package on the same inputs (made with numpy from a seed).

- K2 `kpconv_fused_apply`: gradients with respect to nf, infl and weights
  against `jax.vjp` of the JAX einsum pair `_reference_apply` (the JAX
  backward, `_fused_bwd`) for the same cotangent. Both sides round the
  cotangents of the bf16 operands to bf16, but their f32 sums run in
  another order, so a gradient can land on a neighbouring bf16 value and
  carry that step into the next product. Tolerance: 8e-3 of each
  gradient's max magnitude, two bf16 steps (2^-8 relative each).
- K3 `kth_largest_rows_cols`: the k-th largest of every row and every
  column against the JAX `_rowwise_kth_largest` on the scores and on their
  transpose, bit for bit (tolerance 0): both select an input element.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch


@pytest.mark.parametrize(
    "b,m,h,c,k,d",
    [
        (1, 64, 8, 4, 15, 64),  # the ConvBlock's 4 input channels
        (2, 24, 16, 6, 15, 20),  # C and D that the card's wrapper pads
        (1, 32, 35, 64, 15, 128),  # the main path's neighbour count at level 0
    ],
)
def test_kpconv_gradients_match_jax_vjp(b, m, h, c, k, d):
    from gaussreg_tpu.ops.kpconv_kernel import _reference_apply
    from gaussreg_tpu_torch.ops.kpconv_kernel import kpconv_fused_apply

    rng = np.random.default_rng(h + c)
    nf = jnp.asarray(rng.normal(size=(b, m, h, c)), jnp.bfloat16)
    infl = jnp.asarray(np.maximum(rng.normal(size=(b, m, h, k)), 0), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(k, c, d)), jnp.float32)
    ct = rng.normal(size=(b, m, d)).astype(np.float32)
    _, vjp = jax.vjp(_reference_apply, nf, infl, w)
    grads_j = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(ct))]

    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    inputs = [to_t(nf).requires_grad_(), to_t(infl).requires_grad_(),
              torch.from_numpy(np.array(w)).requires_grad_()]
    out = kpconv_fused_apply(*inputs)
    assert out.grad_fn is not None
    grads_t = torch.autograd.grad(out, inputs, torch.from_numpy(ct))
    assert [g.dtype for g in grads_t] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for name, gt, gj in zip(("nf", "infl", "weights"), grads_t, grads_j):
        scale = np.abs(gj).max()
        np.testing.assert_allclose(gt.float().numpy(), gj, rtol=0, atol=8e-3 * scale,
                                   err_msg=name)


def test_kpconv_backward_only_where_asked():
    """With only the weights requiring grad (the backbone's case at its first
    layer), the backward returns that one gradient, equal to the one of a
    call where every input requires grad."""
    from gaussreg_tpu_torch.ops.kpconv_kernel import kpconv_fused_apply

    gen = torch.Generator().manual_seed(0)
    nf = torch.randn(2, 40, 12, 16, generator=gen).to(torch.bfloat16)
    infl = torch.rand(2, 40, 12, 15, generator=gen).to(torch.bfloat16)
    w = torch.randn(15, 16, 32, generator=gen)
    g = torch.randn(2, 40, 32, generator=gen)
    w1 = w.clone().requires_grad_()
    (gw,) = torch.autograd.grad(kpconv_fused_apply(nf, infl, w1), [w1], g)
    all_in = [nf.clone().requires_grad_(), infl.clone().requires_grad_(),
              w.clone().requires_grad_()]
    grads = torch.autograd.grad(kpconv_fused_apply(*all_in), all_in, g)
    assert torch.equal(gw, grads[2])
    with torch.no_grad():
        assert kpconv_fused_apply(nf, infl, w1).grad_fn is None


@pytest.mark.parametrize("needs_grad", [False, True])
def test_gather_bf16_values_and_gradient_sums(needs_grad):
    """KPConv's neighbour features: `gather_bf16` gives the bf16 values of
    the f32 gather (casting first or last rounds the same elements), the
    sentinel index N giving zeros. Under grad the gather's backward sums the
    features' gradients in f32: equal to an f32 index_add_ of the rounded
    cotangents. The A/B tool's gather by advanced indexing (the port's
    earlier `batched_gather`) gives the same values."""
    from gaussreg_tpu_torch.models.kpconv import batched_gather, gather_bf16
    from gaussreg_tpu_torch.tools.gather_cast_ab import gather_advanced

    gen = torch.Generator().manual_seed(3)
    b, n, m, h, c = 2, 50, 30, 9, 12
    feats = torch.randn(b, n, c, generator=gen)
    idx = torch.randint(0, n + 1, (b, m, h), generator=gen)  # n: the sentinel
    s = feats.clone().requires_grad_(needs_grad)
    nf = gather_bf16(s, idx)
    assert nf.dtype == torch.bfloat16
    assert torch.equal(nf, batched_gather(feats, idx).to(torch.bfloat16))
    assert torch.equal(batched_gather(feats, idx), gather_advanced(feats, idx))
    assert not bool(nf[(idx == n)].any())
    if needs_grad:
        g = torch.randn(b, m, h, c, generator=gen).to(torch.bfloat16)
        (grad,) = torch.autograd.grad(nf, [s], g)
        flat = (idx + n * torch.arange(b)[:, None, None]).reshape(-1)
        keep = (idx != n).reshape(-1)
        want = torch.zeros(b * n, c).index_add_(0, flat[keep], g.float().reshape(-1, c)[keep])
        assert grad.dtype == torch.float32
        assert torch.equal(grad, want.reshape(b, n, c))


def _scores(rng, p, kk, tied):
    if tied:  # few distinct values: many ties per row and column
        s = np.exp(rng.integers(-20, 5, size=(p, kk, kk)) / 4.0)
    else:
        s = np.exp(rng.normal(size=(p, kk, kk)) * 3.0)
    s[0, : kk // 2] = 0.0  # masked entries: exp of the log-domain floor
    s[-1, :, :3] = 0.0
    return s.astype(np.float32)


@pytest.mark.parametrize(
    "p,kk,k,tied",
    [(12, 16, 3, True), (12, 16, 1, False), (6, 128, 3, True), (6, 128, 4, False)],
)
def test_kth_largest_rows_cols_plain_matches_jax(p, kk, k, tied):
    from gaussreg_tpu.models.matching import _rowwise_kth_largest
    from gaussreg_tpu_torch.ops.select_k import kth_largest_rows_cols

    s = _scores(np.random.default_rng(kk + k), p, kk, tied)
    rows_j = np.asarray(_rowwise_kth_largest(jnp.asarray(s.reshape(p * kk, kk)), k))
    cols_j = np.asarray(_rowwise_kth_largest(
        jnp.asarray(s.swapaxes(1, 2).reshape(p * kk, kk)), k))
    rows_t, cols_t = kth_largest_rows_cols(torch.from_numpy(s), k)
    np.testing.assert_array_equal(rows_t.numpy().reshape(-1).view(np.uint32),
                                  rows_j.view(np.uint32))
    np.testing.assert_array_equal(cols_t.numpy().reshape(-1).view(np.uint32),
                                  cols_j.view(np.uint32))


def test_kth_largest_rows_cols_rejects_bad_shapes():
    from gaussreg_tpu_torch.ops.select_k import kth_largest_rows_cols

    with pytest.raises(ValueError, match="P, W, W"):
        kth_largest_rows_cols(torch.zeros(2, 8, 9), 3)
    with pytest.raises(ValueError, match="k <= W"):
        kth_largest_rows_cols(torch.zeros(2, 8, 8), 9)
