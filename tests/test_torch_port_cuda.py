"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips (from the `cuda` fixture, at run time)
where there is no CUDA card. On a machine with one:

    python -m pytest -q -m cuda tests/test_torch_port_cuda.py

K1 and K3 must equal their plain versions index for index and value for
value; K2 must lie within 4e-3 of the plain output's max magnitude (one
bf16 rounding step of a weighted sum, 2^-8 relative).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("limit", [1, 4, 35, 300])
def test_window_select_kernel_matches_plain(cuda, limit):
    from gaussreg_tpu_torch.ops import fused_select as fs

    rng = np.random.default_rng(limit)
    p, nruns, wspan = 1000, 9, 256
    w = nruns * wspan
    g = lambda *s: torch.from_numpy(rng.integers(0, 8, size=s) / 8.0).float().to(cuda)
    q, wx, wy, wz = g(p, 3), g(p, w), g(p, w), g(p, w)
    widx = torch.from_numpy(rng.integers(0, 10**6, size=(p, w))).int().to(cuda)
    ls = rng.integers(0, wspan + 1, size=(p, nruns))
    le = np.minimum(ls + rng.integers(0, 60, size=(p, nruns)), wspan)
    le[:10] = ls[:10]
    lsle = torch.from_numpy(np.concatenate([ls, le], 1)).int().to(cuda)
    before = fs.KERNEL.launches
    d2_k, idx_k = fs.window_select_idx(q, lsle, wx, wy, wz, widx, limit, nruns, wspan)
    d2_p, idx_p = fs.window_select_plain(q, lsle, wx, wy, wz, widx, limit, nruns, wspan)
    assert fs.KERNEL.launches == before + 1
    assert torch.equal(idx_k, idx_p)
    assert torch.equal(d2_k, d2_p)


@pytest.mark.parametrize("c,d", [(4, 64), (32, 32), (64, 64), (128, 128), (256, 256), (512, 512), (24, 40), (64, 1024)])
def test_kpconv_kernel_matches_plain(cuda, c, d):
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    gen = torch.Generator(device=cuda).manual_seed(c)
    b, m, h, k = 2, 333, 35, 15
    nf = torch.randn(b, m, h, c, device=cuda, generator=gen).to(torch.bfloat16)
    infl = torch.rand(b, m, h, k, device=cuda, generator=gen).to(torch.bfloat16)
    w = torch.randn(k, c, d, device=cuda, generator=gen)
    out = kk.kpconv_fused_apply(nf, infl, w)
    ref = kk.reference_apply(nf, infl, w)
    assert (out - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()


@pytest.mark.parametrize("w,k", [(128, 3), (16, 3), (1000, 35)])
def test_select_min_k_kernel_matches_plain(cuda, w, k):
    from gaussreg_tpu_torch.ops import select_k as sk

    gen = torch.Generator(device=cuda).manual_seed(w)
    x = -torch.exp(torch.randint(-20, 5, (777, w), device=cuda, generator=gen) / 4.0)
    x[:5, :] = 0.0  # rows of ties, -0.0 and +0.0 included
    x[0, ::2] = -0.0
    vk, pk = sk.select_min_k(x, k)
    vp, pp = sk.select_min_k_plain(x, k)
    assert torch.equal(pk, pp)
    assert torch.equal(vk, vp)


def test_wrappers_reject_bad_input(cuda):
    from gaussreg_tpu_torch.ops import select_k as sk

    with pytest.raises(ValueError):
        sk.select_min_k(torch.zeros(4, 8, device=cuda, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        sk.select_min_k(torch.zeros(4, 8, device=cuda), 9)
