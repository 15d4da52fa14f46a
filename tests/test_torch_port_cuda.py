"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips (from the `cuda` fixture, at run time)
where there is no CUDA card. On a machine with one:

    python -m pytest -q -m cuda tests/test_torch_port_cuda.py

K1 (both its entries: gathered windows and windows read in place from the
sorted planes) and K3 must equal their plain versions index for index and
value for value (K3's fused thresholds bit for bit), K6 bit for bit; K2 must lie
within 4e-3 of the plain output's max magnitude (one bf16 rounding step of
a weighted sum, 2^-8 relative), and its backward's gradients must equal
those of the plain version's autograd bit for bit.
The rasterizer's hand-built tiles come from test_torch_port_raster_state.py
(which imports no JAX at the top).
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


def _runs_case(dev, seed, nruns, window_rows, rows_per_batch, span):
    """In-place K1 inputs on two batches of sorted planes: lattice
    coordinates (ties), windows that end at the planes' padded end, rows
    with no valid candidate and rows with only a few."""
    rng = np.random.default_rng(seed)
    b, wspan = 2, window_rows * 128
    r_tot = window_rows + 3
    p = b * rows_per_batch
    lat = lambda *s: torch.from_numpy(rng.integers(0, 8, size=s) / 8.0).float().to(dev)
    px, py, pz = (lat(b, r_tot, 128) for _ in range(3))
    pidx = torch.from_numpy(rng.integers(0, 10**6, size=(b, r_tot, 128))).int().to(dev)
    wrow = rng.integers(0, r_tot - window_rows + 1, size=(p, nruns))
    wrow[::5] = r_tot - window_rows  # windows that end at the padded end
    ls = rng.integers(0, 128, size=(p, nruns))
    le = np.minimum(ls + rng.integers(0, span + 1, size=(p, nruns)), wspan)
    le[:3] = ls[:3]  # no valid candidate
    le[3:6, 1:] = ls[3:6, 1:]  # fewer valid candidates than most limits
    lsle = torch.from_numpy(np.concatenate([ls, le], 1)).int().to(dev)
    return lat(p, 3), lsle, torch.from_numpy(wrow).int().to(dev), px, py, pz, pidx, wspan


@pytest.mark.parametrize("limit", [1, 4, 35, 128, 300])
@pytest.mark.parametrize("window_rows,rows_per_batch", [(1, 300), (2, 300), (4, 200), (5, 200),
                                                         (48, 40)])
def test_window_select_runs_kernel_matches_plain(cuda, limit, window_rows, rows_per_batch):
    """K1 in place (W = 9 x 128 x window_rows: 1 152, 2 304, 4 608, 5 760,
    and 55 296, past the 51 200 columns the staged-row design refused) and
    the gathered entry on the same windows: both equal to the plain version
    index for index and value for value, each one launch of the one
    counter."""
    from gaussreg_tpu_torch.ops import fused_select as fs

    nruns = 9
    q, lsle, wrow, px, py, pz, pidx, wspan = _runs_case(
        cuda, limit * 100 + window_rows, nruns, window_rows, rows_per_batch,
        span=min(window_rows * 128, window_rows * 64 + limit))
    before = fs.KERNEL.launches
    d2_k, idx_k = fs.window_select_runs(q, lsle, wrow, px, py, pz, pidx, limit, nruns, wspan)
    torch.cuda.synchronize()
    assert fs.KERNEL.launches == before + 1
    d2_p, idx_p = fs.window_select_runs_plain(q, lsle, wrow, px, py, pz, pidx, limit, nruns,
                                              wspan)
    assert torch.equal(idx_k, idx_p)
    assert torch.equal(d2_k, d2_p)
    wins = fs.gather_windows(wrow, px, py, pz, pidx, wspan)
    d2_g, idx_g = fs.window_select_idx(q, lsle, *wins, limit, nruns, wspan)
    torch.cuda.synchronize()
    assert fs.KERNEL.launches == before + 2
    assert torch.equal(idx_g, idx_p)
    assert torch.equal(d2_g, d2_p)


def test_window_select_runs_rejects_bad_input(cuda):
    from gaussreg_tpu_torch.ops import fused_select as fs

    q, lsle, wrow, px, py, pz, pidx, wspan = _runs_case(cuda, 0, 9, 2, 10, 50)
    with pytest.raises(ValueError):  # a window span that is not whole plane rows
        fs.window_select_runs(q, lsle, wrow, px, py, pz, pidx, 4, 9, wspan - 56)
    with pytest.raises(ValueError):  # int64 window rows
        fs.window_select_runs(q, lsle, wrow.long(), px, py, pz, pidx, 4, 9, wspan)
    with pytest.raises(ValueError):  # a CPU plane beside CUDA queries
        fs.window_select_runs(q, lsle, wrow, px.cpu(), py, pz, pidx, 4, 9, wspan)


_TRAP_SCRIPT = """
import sys
import torch
from gaussreg_tpu_torch.ops import fused_select as fs
dev, b, r_tot, cw, nruns, m = torch.device("cuda"), 2, 5, 128, 9, 8
wspan = 2 * cw  # window_rows = 2: the last window start is 3
planes = [torch.zeros(b, r_tot, cw, device=dev) for _ in range(3)]
ids = torch.zeros(b, r_tot, cw, dtype=torch.int32, device=dev)
lsle = torch.zeros(b * m, 2 * nruns, dtype=torch.int32, device=dev)
lsle[:, nruns:] = wspan
wrow = torch.zeros(b * m, nruns, dtype=torch.int32, device=dev)
wrow[-1, -1] = int(sys.argv[1])
fs.window_select_runs(torch.zeros(b * m, 3, device=dev), lsle, wrow, *planes, ids, 4, nruns,
                      wspan)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
print("no error")
"""


@pytest.mark.parametrize("row,code", [(3, 0), (4, 3), (-1, 3)])
def test_window_select_runs_traps_on_a_window_outside_the_planes(cuda, row, code):
    """A window row whose window leaves the planes traps the kernel, so the
    next synchronisation raises (in a process of its own: the trap loses
    the CUDA context); the last valid start runs."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT, str(row)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == code, proc.stdout + proc.stderr


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


@pytest.mark.parametrize(
    "rows,h,k",
    [(50, 35, 15), (1000, 17, 15), (64 * 5 + 7, 1, 15), (130, 35, 1), (3, 17, 1), (777, 28, 16),
     (300, 44, 16)],
)
def test_kpconv_kernel_shapes(cuda, rows, h, k):
    """Neighbour counts that are not a multiple of 16 (1, 17, 35) and the
    largest at 64 rows per block (44, with sixteen kernel points), one or
    sixteen kernel points, fewer than 64 rows and row counts that are not a
    multiple of 64, at a narrow (C = 4) and a wide (C = D = 256) layer."""
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    for c, d in ((4, 64), (256, 256)):
        gen = torch.Generator(device=cuda).manual_seed(rows + h + k + c)
        nf = torch.randn(1, rows, h, c, device=cuda, generator=gen).to(torch.bfloat16)
        infl = torch.rand(1, rows, h, k, device=cuda, generator=gen).to(torch.bfloat16)
        w = torch.randn(k, c, d, device=cuda, generator=gen)
        before = kk.KERNEL.launches
        out = kk.kpconv_fused_apply(nf, infl, w)
        torch.cuda.synchronize()
        assert kk.KERNEL.launches == before + 1
        ref = kk.reference_apply(nf, infl, w)
        assert (out - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()


@pytest.mark.parametrize("rows,h,k", [(500, 45, 15), (333, 89, 15), (97, 96, 16), (40, 60, 1)])
def test_kpconv_kernel_wide_neighbourhoods(cuda, rows, h, k):
    """Past 48 neighbour slots (the reference checkpoint's limits reach 89 at
    level 0) the kernel takes blocks of 32 rows, still in one launch that
    sums all slots in f32 and rounds once: held to the same 4e-3 as the
    other shapes. Past 96 slots the wrapper raises."""
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    gen = torch.Generator(device=cuda).manual_seed(rows + h + k)
    for c, d in ((4, 64), (256, 256)):
        nf = torch.randn(1, rows, h, c, device=cuda, generator=gen).to(torch.bfloat16)
        infl = torch.rand(1, rows, h, k, device=cuda, generator=gen).to(torch.bfloat16)
        w = torch.randn(k, c, d, device=cuda, generator=gen)
        before = kk.KERNEL.launches
        out = kk.kpconv_fused_apply(nf, infl, w)
        torch.cuda.synchronize()
        assert kk.KERNEL.launches == before + 1
        ref = kk.reference_apply(nf, infl, w)
        assert (out - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()
    nf = torch.zeros(1, 8, kk.MAX_NEIGHBORS + 1, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H <="):
        kk.kpconv_fused_apply(nf, nf[..., :1].expand(-1, -1, -1, k), torch.zeros(k, 4, 8,
                                                                                  device=cuda))


@pytest.mark.parametrize("w,k", [(128, 3), (16, 3), (1000, 35)])
def test_select_min_k_kernel_matches_plain(cuda, w, k):
    from gaussreg_tpu_torch.ops import select_k as sk

    gen = torch.Generator(device=cuda).manual_seed(w)
    x = -torch.exp(torch.randint(-20, 5, (777, w), device=cuda, generator=gen) / 4.0)
    x[:5, :] = 0.0  # rows of ties, -0.0 and +0.0 included
    x[0, ::2] = -0.0
    before = sk.KERNEL.launches
    vk, pk = sk.select_min_k(x, k)
    torch.cuda.synchronize()
    assert sk.KERNEL.launches == before + 1
    vp, pp = sk.select_min_k_plain(x, k)
    assert torch.equal(pk, pp)
    assert torch.equal(vk, vp)


def select_rows(w, k, cuda, seed):
    """Rows that exercise every part of K3's routes: random values with
    ties, zeros of both signs, the radius search's 1e12 sentinel plateau
    with fewer than k real values, equal values on both sides of each warp
    slice's border of the wide filter route, and descending rows (every key
    enters a lane's queue; lanes run dry and are refilled, past k = 128
    from shorter refill queues that can run dry first)."""
    from gaussreg_tpu_torch.ops import select_k as sk

    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(0, 1 << 12, (40, w), device=cuda, generator=gen).float() / 64.0
    x[0] = 0.0
    x[0, ::2] = -0.0
    x[1] = torch.randint(0, 3, (w,), device=cuda, generator=gen).float() - 1.0
    x[1][x[1] == 0] = -0.0
    x[2:4] = 1e12  # the plateau, fewer than k real values after it
    x[2, w - max(1, k // 2):] = torch.arange(max(1, k // 2), device=cuda, dtype=torch.float32)
    x[3, :: max(1, w // max(1, k - 1))] = 5.0
    units = w // 4 if w % 4 == 0 and k <= 4 else w  # float4s where the kernel reads them so
    scale = w // units
    wpr = sk.FILTER_WIDE_WARPS  # the wide filter's slices
    borders = {(units // wpr * part + min(part, units % wpr)) * scale for part in range(1, wpr)}
    for b in sorted(borders):  # equal values astride each border
        if 0 < b < w:
            x[4:6, b - 1] = -2.0
            x[4:6, b] = -2.0
    x[6] = torch.arange(w, 0, -1, device=cuda, dtype=torch.float32)  # descending
    x[7] = torch.arange(w, 0, -1, device=cuda, dtype=torch.float32).div(8).floor()
    return x


ROUTE_WIDTHS = [16, 128, 2304, 25_600, 25_601, 30_720, 65_536]
ROUTE_KS = [1, 3, 35, 89, 128, 129, 700, 1706, 2048]


@pytest.mark.parametrize("w,k", [(w, k) for w in ROUTE_WIDTHS for k in ROUTE_KS if k <= w])
def test_select_min_k_routes_match_plain(cuda, w, k):
    """Every route of K3 (select_k.route) bit for bit against the plain
    stable sort, with only the route's own launch count moved by the call."""
    from gaussreg_tpu_torch.ops import select_k as sk

    x = select_rows(w, k, cuda, w * 1000 + k)
    name = sk.route(w, k, x.shape[0])
    before = {n: kern.launches for n, kern in sk.ROUTES.items()}
    vk, pk = sk.select_min_k(x, k)
    torch.cuda.synchronize()
    moved = {n: kern.launches - before[n] for n, kern in sk.ROUTES.items()}
    assert moved == {n: int(n == name) for n in sk.ROUTES}, (name, moved)
    vp, pp = sk.select_min_k_plain(x, k)
    assert torch.equal(pk, pp), (name, (pk != pp).nonzero()[:5].tolist())
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32)), name


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("w,k", [(2304, 35), (30_720, 35), (999, 89), (8192, 128), (4096, 3),
                                 (2304, 700), (30_720, 2048), (7000, 6400)])
def test_select_min_k_filter_both_forms_any_width(cuda, wide, w, k):
    """The filter entry in both its forms (one warp per row, and one block
    of FILTER_WIDE_WARPS = 4 warps per row) at widths on either side of
    FILTER_WIDE_MIN_WIDTH and k up to the wide form's list limit
    (FILTER_WIDE_LIST_MAX_K = 6 400: 200 KiB of shared memory), whichever
    the route would take, bit for bit, unaligned rows (a view one column
    in) included."""
    from gaussreg_tpu_torch.ops import select_k as sk

    x = select_rows(w + 1, k, cuda, int(wide))[:, 1:].contiguous()
    for rows in (x, select_rows(w + 1, k, cuda, int(wide)).reshape(-1)[1:1 + 40 * w].view(40, w)):
        vals = torch.empty((40, k), device=cuda)
        pos = torch.empty((40, k), device=cuda, dtype=torch.int32)
        sk.KERNEL.launch(rows.data_ptr(), vals.data_ptr(), pos.data_ptr(), 40, w, k, int(wide))
        vp, pp = sk.select_min_k_plain(rows, k)
        torch.cuda.synchronize()
        assert torch.equal(pos, pp)
        assert torch.equal(vals.view(torch.int32), vp.view(torch.int32))


@pytest.mark.parametrize("w,k", [(1, 1), (7, 7), (257, 1), (257, 257), (2304, 700),
                                 (30_720, 2048), (30_720, 8192), (49_000, 600)])
def test_select_min_k_radix_any_shape(cuda, w, k):
    """K3's radix entry (digit histograms to the k-th key, then a bitonic
    sort of the k keys at or below it), whatever route select_min_k would
    take, bit for bit against the plain stable sort: k = 1 and k = W, a
    width past 256 (two position digits), k up to 8 192 and a row near the
    200 KiB of shared memory; rows of ties, +-0.0, sentinel plateaus and
    descending values (every tie broken by position digits)."""
    from gaussreg_tpu_torch.ops import select_k as sk

    x = select_rows(w, k, cuda, w + k)
    assert sk.radix_fits(w, k)
    vals = torch.empty((40, k), device=cuda)
    pos = torch.empty((40, k), device=cuda, dtype=torch.int32)
    before = sk.RADIX_KERNEL.launches
    sk.RADIX_KERNEL.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), 40, w, k)
    vp, pp = sk.select_min_k_plain(x, k)
    torch.cuda.synchronize()
    assert sk.RADIX_KERNEL.launches == before + 1
    assert torch.equal(pos, pp), (pos != pp).nonzero()[:5].tolist()
    assert torch.equal(vals.view(torch.int32), vp.view(torch.int32))
    if w == 49_000:  # a wider row does not fit: refused, not launched
        assert not sk.radix_fits(52_000, k)
        with pytest.raises(RuntimeError):
            sk.RADIX_KERNEL.launch(x.data_ptr(), vals.data_ptr(), pos.data_ptr(), 1, 52_000, k)


def test_wrappers_reject_bad_input(cuda):
    from gaussreg_tpu_torch.ops import select_k as sk

    with pytest.raises(ValueError):
        sk.select_min_k(torch.zeros(4, 8, device=cuda, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        sk.select_min_k(torch.zeros(4, 8, device=cuda), 9)


@pytest.mark.parametrize("w", [16, 64, 128, 192])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("tied", [False, True])
def test_kth_largest_rows_cols_kernel_matches_plain(cuda, w, k, tied):
    """K3's fused entry against its plain version (the two select_min_k
    calls of the unfused path), bit for bit, on random scores and on
    scores with few distinct values, zeros of both signs included."""
    from gaussreg_tpu_torch.ops import select_k as sk

    gen = torch.Generator(device=cuda).manual_seed(w * 10 + k)
    p = 37
    if tied:
        s = torch.exp(torch.randint(-20, 5, (p, w, w), device=cuda, generator=gen) / 4.0)
        s[0, : w // 2] = 0.0
        s[1, :, ::3] = -0.0
        s[2] = 1.0
    else:
        s = torch.exp(3.0 * torch.randn(p, w, w, device=cuda, generator=gen))
    before = sk.FUSED_KERNEL.launches
    rk, ck = sk.kth_largest_rows_cols(s, k)
    torch.cuda.synchronize()
    assert sk.FUSED_KERNEL.launches == before + 1
    rp, cp = sk.kth_largest_rows_cols_plain(s, k)
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert torch.equal(ck.view(torch.int32), cp.view(torch.int32))


def test_kth_largest_rows_cols_kernel_limits(cuda):
    from gaussreg_tpu_torch.ops import select_k as sk

    with pytest.raises(ValueError, match="W <= 192"):
        sk.kth_largest_rows_cols(torch.zeros(2, 193, 193, device=cuda), 3)
    with pytest.raises(ValueError, match="k <= 4"):
        sk.kth_largest_rows_cols(torch.zeros(2, 16, 16, device=cuda), 5)
    with pytest.raises(ValueError):
        sk.kth_largest_rows_cols(torch.zeros(2, 16, 16, device=cuda, dtype=torch.float64), 3)


@pytest.mark.parametrize("rows,h,c,d", [(333, 35, 64, 64), (97, 17, 24, 40), (200, 89, 4, 64),
                                        (150, 29, 256, 512)])
def test_kpconv_backward_matches_plain_autograd(cuda, rows, h, c, d):
    """K2's backward on the card: the gradients of (out * g).sum() through
    the kernel path equal, bit for bit, those of `reference_apply`'s own
    autograd on the same CUDA inputs (the backward reads only the saved
    inputs and g, and runs the same operations)."""
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    gen = torch.Generator(device=cuda).manual_seed(rows + h)
    k = 15
    nf = torch.randn(1, rows, h, c, device=cuda, generator=gen).to(torch.bfloat16)
    infl = torch.rand(1, rows, h, k, device=cuda, generator=gen).to(torch.bfloat16)
    w = torch.randn(k, c, d, device=cuda, generator=gen)
    g = torch.randn(1, rows, d, device=cuda, generator=gen)

    def grads(fn):
        inputs = [t.clone().requires_grad_() for t in (nf, infl, w)]
        out = fn(*inputs)
        assert out.grad_fn is not None
        return torch.autograd.grad((out * g).sum(), inputs)

    before = kk.KERNEL.launches
    through_kernel = grads(kk.kpconv_fused_apply)
    assert kk.KERNEL.launches == before + 1
    plain = grads(kk.reference_apply)
    for a, b in zip(through_kernel, plain):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


# ---- the training path through K2 ----


def _train_forward_backward(cfg, batch, model, gumbel):
    """One train-mode forward and backward, the GT draw fed `gumbel`;
    returns the losses and the gradients by parameter name."""
    from gaussreg_tpu_torch.models import registration as treg
    from gaussreg_tpu_torch.models.losses import overall_loss
    from gaussreg_tpu_torch.models.matching import sample_gt_node_correspondences_from_gumbel

    model.zero_grad(set_to_none=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, "sample_gt_node_correspondences",
                   lambda gen, *a: sample_gt_node_correspondences_from_gumbel(gumbel, *a))
        out = model(batch, None, train=True, with_transform=False)
    losses = overall_loss(cfg, out, batch.transform)
    losses["loss"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()})


def _seeded_model(cfg, dev):
    from gaussreg_tpu_torch.models.registration import create_model

    model = create_model(cfg, dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def test_full_width_train_step_gets_every_gradient_through_k2(cuda):
    """make_cfg() on one 20 000-point pair: the train-mode forward launches
    K2 14 times, the losses are finite, and every parameter but the kernel
    points gets a finite gradient."""
    from gaussreg_tpu_torch.config import make_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    cfg = make_cfg()
    batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=20000), device=cuda)
    model = _seeded_model(cfg, cuda)
    nc = batch.pyramid.points[-1].shape[1]
    gumbel = torch.empty(nc, nc, device=cuda).exponential_().log_().neg_()
    before = kk.KERNEL.launches
    losses, grads = _train_forward_backward(cfg, batch, model, gumbel)
    assert kk.KERNEL.launches - before == 14
    assert all(np.isfinite(v) for v in losses.values()), losses
    for name, g in grads.items():
        if name.endswith("kernel_points"):
            assert g is None, name
        else:
            assert g is not None and bool(torch.isfinite(g).all()), name


# One train step's KPConv weight gradients through K2 against the plain K2,
# as a share of the plain gradient's max, per leaf
# (`python -m gaussreg_tpu_torch.tools.k2_grad_sensitivity` on one NVIDIA
# H100 80GB HBM3 at 700 W, the test's own inputs): the kernel path reads
# 3.7e-3 to 3.07e-2 (four pairs of runs; encoder5_1 and encoder5_2 the
# largest), the plain path against itself up to 7.3e-3 (the gathers'
# backward, index_add_, sums with atomics); with K2 faulty every leaf reads
# 8.7e-2 or more (the last neighbour column dropped: 8.7e-2 to 0.23; the
# last kernel point dropped: 0.35 to 2.3; the last 32 output rows zeroed:
# 0.33 to 1.3). The limit sits between the two, about 2x the largest sound
# reading. The 2e-2 of chip_smoke.py's "k2 backward", where the backbone
# alone is differentiated, does not hold through the whole loss: the
# forward's last bits move these gradients by up to 0.25 of their max when
# every weight moves by 1e-6 of itself.
K2_TRAIN_GRAD_LIMIT = 6e-2


def test_tiny_k2_weight_gradients_kernel_against_plain(cuda):
    """make_tiny_cfg(): one train step's KPConv weight gradients through K2
    against those with K2's plain version in its place, on the card, the
    same weights and GT draw: each within K2_TRAIN_GRAD_LIMIT of the plain
    gradient's max."""
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.models import kpconv as kpconv_mod
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    cfg = make_tiny_cfg()
    batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=500), device=cuda)
    model = _seeded_model(cfg, cuda)
    nc = batch.pyramid.points[-1].shape[1]
    gumbel = torch.from_numpy(np.random.default_rng(0).gumbel(size=(nc, nc)).astype(np.float32))
    gumbel = gumbel.to(cuda)
    before = kk.KERNEL.launches
    _, g_kernel = _train_forward_backward(cfg, batch, model, gumbel)
    assert kk.KERNEL.launches - before == 14
    names = [n for n in g_kernel if n.endswith("conv.weights")]
    g_kernel = {n: g_kernel[n].clone() for n in names}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kpconv_mod, "kpconv_fused_apply", kk.reference_apply)
        _, g_plain = _train_forward_backward(cfg, batch, model, gumbel)
    assert len(names) == 14
    for n in names:
        err = float((g_kernel[n] - g_plain[n]).abs().max() / g_plain[n].abs().max())
        assert err <= K2_TRAIN_GRAD_LIMIT, (n, err)


# ---- the rasterizer kernels (K4, K5, K6) ----
#
# K4: rgb and T within 5e-4, depth within 5e-3 (the limits of the JAX
# package's own kernel-against-reference test), kend equal: both versions
# round the exponent alike, so they differ only by the order of the colour
# sums and by exp's last bit. K5: rows within 2e-3 of each channel's max
# (sums over 1024 pixels in another order). K6: equal bit for bit (the same
# additions in the same order).


def _pairs_scene(cuda, n, seed, width, height, tile=32, opacity_boost=1.0, z_front=False):
    """A projected scene's rasterizer inputs on the card: gdata and the
    binning (sorted_gid, starts, the sort's order and row_gid), through the
    port's own projection and binning."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels
    from gaussreg_tpu_torch.gs.rasterizer.binning import bin_gaussians
    from gaussreg_tpu_torch.gs.rasterizer.camera import look_at_camera
    from gaussreg_tpu_torch.gs.rasterizer.project import project_gaussians

    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    if z_front:
        means[:, 2] = rng.uniform(-1.0, 0.5, size=n)
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(1.0, 1.0, size=n)))).astype(np.float32)
    opac = np.minimum(opac * opacity_boost, 0.99).astype(np.float32)
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-1, 1, size=(n, 3))
    t = lambda a: torch.from_numpy(a).to(cuda)
    cam = look_at_camera([0, 0, -4.0], [0, 0, 0], [0, 1, 0], 60, width, height)
    proj = project_gaussians(t(means), t(scales), t(quats), t(opac), t(sh), cam)
    b = bin_gaussians(proj.means2d, proj.radii, proj.depths, width, height,
                      tile_w=tile, tile_h=tile, max_tiles_per_gaussian=32,
                      extents=proj.extents, minor=proj.minor)
    coeffs = kernels.quadratic_coeffs(proj.means2d, proj.conics, proj.opacities)
    z2 = torch.zeros((n, 2), device=cuda)
    gdata = torch.cat([coeffs, z2, proj.colors, proj.depths[:, None], z2, z2], dim=1)
    sentinel = torch.zeros((1, 16), device=cuda)
    sentinel[0, 0] = -1e30
    return torch.cat([gdata, sentinel]).contiguous(), b


def _check_forward(gdata, gid, starts, height, width, tile):
    """K4 against its plain version, the chunk-start state included on the
    chunks both walked (same limits as the planes)."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    before = kernels.FWD_KERNEL.launches
    planes_k, kend_k, state_k = kernels.rasterize_forward(gdata, gid, starts, height, width, tile,
                                                          tile, save_state=True)
    torch.cuda.synchronize()
    assert kernels.FWD_KERNEL.launches == before + 1
    planes_p, kend_p, state_p = kernels.rasterize_forward_plain(gdata, gid, starts, height, width,
                                                                tile, tile, save_state=True)
    assert torch.equal(kend_k, kend_p)
    assert (planes_k[[0, 1, 2, 4]] - planes_p[[0, 1, 2, 4]]).abs().max().item() <= 5e-4
    assert (planes_k[3] - planes_p[3]).abs().max().item() <= 5e-3
    walked = kernels.written_state_slots(starts, kend_k, gid.shape[0])
    if walked.numel():
        diff = (state_k[walked] - state_p[walked]).abs()
        assert diff[:, :4].max() <= 5e-4 and diff[:, 4].max() <= 5e-3
    # without the state the kernel computes the same
    planes_n, kend_n = kernels.rasterize_forward(gdata, gid, starts, height, width, tile, tile)
    assert torch.equal(planes_n, planes_k) and torch.equal(kend_n, kend_k)
    return planes_k, kend_k, state_k


def _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile, bwd_blocks):
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    gen = torch.Generator(device=gdata.device).manual_seed(0)
    d = torch.randn(5, height, width, device=gdata.device, generator=gen)
    v = (d[:4] * planes[:4]).sum(0)
    ct = torch.cat([d, planes[4:5], v[None]]).contiguous()
    offs = kernels.compacted_offsets(kend, bwd_blocks)
    args = (gdata, gid, starts, offs, ct, bwd_blocks, height, width, tile, tile)
    before = kernels.BWD_KERNEL.launches
    rows_k = kernels.rasterize_backward(*args, state=state)
    torch.cuda.synchronize()
    assert kernels.BWD_KERNEL.launches == before + 1
    # against the chunk-parallel plain walk from the kernel's own state, and
    # against the sequential walk, which recomputes each chunk's start
    for rows_p in (kernels.rasterize_backward_plain(*args, state=state),
                   kernels.rasterize_backward_plain(*args)):
        scale = rows_p.abs().amax(dim=0).clamp_min(1e-20)
        assert ((rows_k - rows_p).abs() / scale).max().item() <= 2e-3
    assert torch.equal(rows_k[:, [6, 7, 12, 13, 14, 15]], torch.zeros_like(rows_k[:, :6]))
    assert torch.equal(rows_k, kernels.rasterize_backward(*args, state=state))  # repeats exactly
    return rows_k, offs


@pytest.mark.parametrize(
    "n,width,height,tile,boost,front",
    [
        (300, 128, 64, 32, 1.0, False),  # sparse: tiles inside one 128-block, empty tiles
        (4000, 128, 64, 32, 4.0, True),  # a saturating slab: early exits, kend < chunks
        (600, 64, 64, 16, 1.0, False),  # 16x16 tiles: 256 threads per block
    ],
)
def test_rasterize_kernels_match_plain(cuda, n, width, height, tile, boost, front):
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    gdata, b = _pairs_scene(cuda, n, n, width, height, tile, boost, front)
    gid, starts = b.sorted_gid, b.starts
    planes, kend, state = _check_forward(gdata, gid, starts, height, width, tile)
    if front:
        assert (kend < torch.div(starts[1:] - starts[:-1] + 127, 128, rounding_mode="floor")).any()
    full = gid.shape[0] // kernels.CHUNK + kend.shape[0]
    _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile, full)
    # a cap that clips: the last tiles lose their chunks, nothing past it is written
    clipped = max(1, int(kend.sum()) // 2)
    rows, offs = _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile,
                                 clipped)
    assert int(offs[-1]) == clipped and rows.shape[0] == clipped * kernels.CHUNK


def test_rasterize_empty_and_one_block_tiles(cuda):
    """An image whose gaussians all sit in one tile: every other tile is
    empty (kend 0, T = 1, colour 0) and the busy tile's range starts and
    ends inside one 128-block."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    g = 5
    gdata = torch.zeros((g + 1, 16), device=cuda)
    gdata[:g, 0] = -0.1  # a0
    gdata[:g, 3] = gdata[:g, 5] = -1e-3  # axx, ayy: wide blobs around the origin
    gdata[:g, 8:12] = torch.rand((g, 4), device=cuda)
    gdata[g, 0] = -1e30
    gid = torch.full((128,), g, dtype=torch.int32, device=cuda)
    gid[3:8] = torch.arange(g, dtype=torch.int32, device=cuda)
    starts = torch.tensor([3, 3, 8, 8, 8], dtype=torch.int32, device=cuda)  # tile 1 owns [3, 8)
    planes, kend, state = _check_forward(gdata, gid, starts, 32, 128, 32)
    assert kend.tolist() == [0, 1, 0, 0]
    assert torch.equal(planes[4, :, :32], torch.ones(32, 32, device=cuda))
    assert planes[:4, :, 64:].abs().max().item() == 0.0
    rows, _ = _check_backward(gdata, gid, starts, planes, kend, state, 32, 128, 32, 2)
    assert rows[3:8].abs().max().item() > 0 and rows[8:].abs().max().item() == 0


def test_rasterize_gradients_match_plain_path(cuda):
    """rasterize_gaussians end to end on the card (K4 + K5 + K6) against the
    same autograd.Function on the CPU (the plain versions)."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels

    gdata, b = _pairs_scene(cuda, 500, 3, 128, 64)
    outs = []
    for dev in ("cuda", "cpu"):
        x = gdata.detach().to(dev).clone().requires_grad_(True)
        rgb, depth, t, _ = kernels.rasterize_gaussians(
            x, type(b)(*(f.to(dev) for f in b)), 64, 128)
        w = torch.linspace(0.5, 1.5, rgb.numel(), device=dev).reshape(rgb.shape)
        ((rgb * w).sum() + 0.3 * t.sum() + 0.05 * depth.sum()).backward()
        outs.append(x.grad.cpu())
    scale = outs[1].abs().amax(dim=0).clamp_min(1e-20)
    assert ((outs[0] - outs[1]).abs() / scale).max().item() <= 2e-3


@pytest.mark.parametrize(
    "n,width,height,tile,boost,front",
    [
        (300, 128, 64, 32, 1.0, False),
        (4000, 128, 64, 32, 4.0, True),
        (600, 64, 64, 16, 1.0, False),
    ],
)
def test_segment_accumulate_kernel_matches_plain(cuda, n, width, height, tile, boost, front):
    """K6 on the three scenes of test_rasterize_kernels_match_plain, with the
    full backward buffer and one that clips: equal bit for bit to its plain
    version (the same additions in the same order), to index_add_ on the
    compacted ids on the CPU (sequential, in row order), and to itself on a
    second launch."""
    from gaussreg_tpu_torch.gs.rasterizer import accumulate as acc
    from gaussreg_tpu_torch.gs.rasterizer import kernels
    from gaussreg_tpu_torch.gs.rasterizer.binning import slot_positions

    gdata, b = _pairs_scene(cuda, n, n, width, height, tile, boost, front)
    table = slot_positions(b.order, b.row_gid.shape[0], 32)
    planes, kend, state = kernels.rasterize_forward(gdata, b.sorted_gid, b.starts, height, width,
                                                    tile, tile, save_state=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    d = torch.randn(5, height, width, device=cuda, generator=gen)
    ct = torch.cat([d, planes[4:5], (d[:4] * planes[:4]).sum(0)[None]]).contiguous()
    cap, g1 = b.sorted_gid.shape[0], gdata.shape[0]
    full = b.sorted_gid.shape[0] // kernels.CHUNK + kend.shape[0]
    for bwd_blocks in (full, max(1, int(kend.sum()) // 2)):
        offs = kernels.compacted_offsets(kend, bwd_blocks)
        rows = kernels.rasterize_backward(gdata, b.sorted_gid, b.starts, offs, ct, bwd_blocks,
                                          height, width, tile, tile, state=state)
        args = (rows, table, b.row_gid, b.starts, offs, cap, g1)
        before = acc.KERNEL.launches
        out_k = acc.accumulate_pairs(*args)
        torch.cuda.synchronize()
        assert acc.KERNEL.launches == before + 1
        assert torch.equal(out_k, acc.accumulate_pairs_plain(*args))
        ids = kernels.compacted_gids(b.sorted_gid, b.starts, offs, bwd_blocks, drop_id=g1)
        oracle = acc.segment_accumulate_plain(rows.cpu(), ids.cpu(), g1)
        oracle[g1 - 1] = 0.0
        assert torch.equal(out_k.cpu(), oracle)
        assert torch.equal(out_k, acc.accumulate_pairs(*args))  # repeats exactly


@pytest.mark.parametrize("scene", ["silhouette", "staggered"])
def test_rasterize_kernels_hand_built_tiles(cuda, scene):
    """The hand-built tiles of test_torch_port_raster_state.py on the card.
    Silhouette: a tile half covered and half empty walks all of its nine
    chunks (kend = chunk count), so the backward's blocks start from eight
    saved states. Staggered: the cluster blocks holding the top rows fall
    under T_EPS chunks before those holding the bottom rows; the exit
    agreement must stop the tile after the plain version's kend, which is
    below the chunk count. K4, its state and K5 against their plain
    versions (limits above); two K5 runs equal bit for bit."""
    from test_torch_port_raster_state import chunk_counts, silhouette_pairs, staggered_pairs

    gdata, gid, starts, height, width, tile = (
        silhouette_pairs if scene == "silhouette" else staggered_pairs)(cuda)
    planes, kend, state = _check_forward(gdata, gid, starts, height, width, tile)
    nch = chunk_counts(starts, gid.shape[0])
    if scene == "silhouette":
        assert nch[0] >= 8 and int(kend[0]) == nch[0]
    else:
        assert 0 < int(kend[0]) < nch[0]
    full = gid.shape[0] // 128 + kend.shape[0]
    _check_backward(gdata, gid, starts, planes, kend, state, height, width, tile, full)


def test_forward_refuses_a_cluster_it_cannot_place(cuda):
    """A cluster of 16 blocks per tile (over the portable 8) is refused by
    the card: the launch raises, is not counted and is not retried without
    a cluster."""
    from gaussreg_tpu_torch.gs.rasterizer import kernels
    from test_torch_port_raster_state import silhouette_pairs

    gdata, gid, starts, height, width, tile = silhouette_pairs(cuda)
    nty, ntx = height // tile, width // tile
    planes = torch.empty((5, height, width), device=cuda)
    kend = torch.empty((nty * ntx,), dtype=torch.int32, device=cuda)
    before = kernels.FWD_KERNEL.launches
    with pytest.raises(RuntimeError):
        kernels.FWD_KERNEL.launch(gdata.data_ptr(), gid.data_ptr(), starts.data_ptr(),
                                  planes.data_ptr(), kend.data_ptr(), 0, gid.shape[0], ntx, nty,
                                  tile, tile, 16)
    torch.cuda.synchronize()
    assert kernels.FWD_KERNEL.launches == before
    with pytest.raises(ValueError):  # the kernel walks from the state: it must be given
        kernels.rasterize_backward(gdata, gid, starts, torch.zeros(3, dtype=torch.int32,
                                   device=cuda), torch.zeros(7, height, width, device=cuda), 4,
                                   height, width, tile, tile)


# ---- the probes' kernels (P1, P2) ----
#
# P1: every gather equals table[idx] bit for bit. P2: kend equal; rgb and T
# within 1e-5 for A, C and D (kernel and plain version compute the same
# alpha, rounding each product and sum of the exponent alike, and sum the
# prefix and the colours in another order) and within 5e-4 for B (one bf16
# step of one lg, should the two log1p differ in the last bit).


@pytest.mark.parametrize("g,k", [(4096, 128), (1000, 77), (16, 1), (7264, 300), (9, 40),
                                 (58_104, 5000)])
def test_probe_gathers_are_exact(cuda, g, k):
    from gaussreg_tpu_torch.tools import probe_vmem_gather as p1

    table, idx = p1.make_inputs(g + k, g=g, k=k, device=cuda)
    idx[0] = g - 1
    slice_rows = -(-g // p1.CLUSTER_BLOCKS)  # the shared variant's slices
    for r in range(p1.CLUSTER_BLOCKS):  # an index in every block's slice, first and last row
        if r * slice_rows < g and 2 * r + 2 < k:
            idx[1 + 2 * r] = r * slice_rows
            idx[2 + 2 * r] = min(g, (r + 1) * slice_rows) - 1
    ref = table[idx.long()]
    for variant, kernel in p1.KERNELS.items():
        before = kernel.launches
        out = p1.gather(variant, table, idx)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(out, ref), variant
        assert torch.equal(p1.PLAIN[variant](table, idx), ref), variant


def test_probe_gather_rejects_a_table_past_shared_memory(cuda):
    """The shared variant stages the table across a cluster: the largest
    table that fits gathers exactly, one row more is refused."""
    from gaussreg_tpu_torch.tools import probe_vmem_gather as p1

    table, idx = p1.make_inputs(0, g=p1.MAX_TABLE_ROWS + 1, k=8, device=cuda)
    idx[0] = p1.MAX_TABLE_ROWS
    with pytest.raises(ValueError, match="shared memory"):
        p1.gather("shared", table, idx)
    assert torch.equal(p1.gather("global", table, idx), table[idx.long()])
    fits, idx = table[:-1].contiguous(), idx.clamp_max(p1.MAX_TABLE_ROWS - 1)
    assert torch.equal(p1.gather("shared", fits, idx), fits[idx.long()])


def _p2_case(case):
    """P2's inputs by name: blocks, ragged saturating ranges, tiles of which
    one half saturates first (the halves of a tile's cluster), and the
    probe's full shape."""
    from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2
    from test_torch_port_probes import half_saturating_blocks, ragged_saturating_blocks

    if case == "blocks":
        blocks, starts, _ = p2.make_blocks(num_tiles=40, blocks_per_tile=3, seed=2)
        return blocks, starts, 40
    if case == "full":
        blocks, starts, _ = p2.make_blocks()
        return blocks, starts, starts.shape[0] - 1
    return ragged_saturating_blocks() if case == "ragged" else half_saturating_blocks()


@pytest.mark.parametrize("case", ["blocks", "ragged", "half", "full"])
def test_probe_composite_cores_match_plain(cuda, case):
    from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2

    blocks, starts, tiles = _p2_case(case)
    blocks, starts = torch.from_numpy(blocks).to(cuda), torch.from_numpy(starts).to(cuda)
    limits = {"A": 1e-5, "B": 5e-4, "C": 1e-5, "D": 1e-5}
    for core, kernel in p2.KERNELS.items():
        before = kernel.launches
        out = p2.run_fwd(blocks, starts, core, tiles)
        ref = p2.composite_plain(blocks, starts, core, tiles)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(out[:, 5], ref[:, 5]), core
        err = (out[:, :5] - ref[:, :5]).abs().max().item()
        assert err <= limits[core], (core, err)


def test_probe_composite_log1p_is_the_library_s(cuda):
    """The kernels' branch-free log1p equals the library's log1pf at every
    f32 alpha in [0, 0.99], up to the sign of a zero."""
    from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2

    assert p2.log1p_mismatches(cuda) == 0


@pytest.mark.parametrize("case", ["ragged", "half"])
def test_probe_composite_cluster_sizes_agree(cuda, case, tmp_path):
    """A tile composited by a cluster of 1, 2, 4 or 8 blocks (the cluster
    sweep's copies of the source beside the shipped build): every pixel's
    arithmetic and the tile's exit are the same, so every bit is."""
    from gaussreg_tpu_torch.tools import probe_kernels_r5 as p2

    blocks, starts, tiles = _p2_case(case)
    blocks, starts = torch.from_numpy(blocks).to(cuda), torch.from_numpy(starts).to(cuda)
    copies = {cl: p2.cluster_copy(cl, str(tmp_path)) for cl in (1, 4, 8)}
    for core in p2.CORES:
        ref = p2.run_fwd(blocks, starts, core, tiles)
        for cluster, kernels in copies.items():
            out = p2.run_fwd(blocks, starts, core, tiles, kernel=kernels[core])
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (core, cluster)


@pytest.mark.parametrize("w,k", [(25_600, 35), (25_601, 35), (2048 * 13 + 1, 89),
                                 (30_720, 35), (30_720, 89), (26_000, 700)])
def test_select_min_k_wide_mode_matches_plain(cuda, w, k):
    """K3 on wide rows against the plain stable sort, bit for bit: the
    filter's wide route (one block of FILTER_WIDE_WARPS warps per row) for
    k <= FILTER_WIDE_MAX_K, its narrow route (one warp per row) past it,
    the radix route at k = 700; at the level-0 brute-force width 30 720 at
    make_cfg()'s and the reference's level-0 limits, and k = 700 past
    25 600 columns. Rows of ties (+-0.0), of the radius search's sentinel
    plateau, and equal values far apart."""
    from gaussreg_tpu_torch.ops import select_k as sk

    gen = torch.Generator(device=cuda).manual_seed(w + k)
    x = torch.randint(0, 1 << 20, (96, w), device=cuda, generator=gen).float() / 64.0
    x[:3] = 0.0
    x[0, ::2] = -0.0
    x[3:6, : w - 50] = 1e12  # mostly sentinel, the few real ones at the end
    x[6, 5] = x[6, 4097] = x[6, w - 1] = -1.0  # one value in three chunks
    name = sk.route(w, k, x.shape[0])
    assert name == ("select_min_k_radix" if k >= sk.RADIX_ANY_WIDTH_K else
                    "select_min_k_wide" if k <= sk.FILTER_WIDE_MAX_K else "select_min_k")
    before = sk.ROUTES[name].launches
    vk, pk = sk.select_min_k(x, k)
    vp, pp = sk.select_min_k_plain(x, k)
    torch.cuda.synchronize()
    assert sk.ROUTES[name].launches == before + 1
    assert torch.equal(pk, pp)
    assert torch.equal(vk, vp)


def test_select_min_k_wide_mode_limits(cuda):
    """k = 2 000 on 30 720 columns, past the 200 KiB of chunk winners that
    the card once refused: answered, bit for bit against the plain stable
    sort, on a row of zeros of both signs and a row of ties."""
    from gaussreg_tpu_torch.ops import select_k as sk

    x = torch.zeros(2, 30_720, device=cuda)
    x[0, ::2] = -0.0
    x[1] = torch.arange(30_720, device=cuda).remainder(7).float()
    vk, pk = sk.select_min_k(x, 2000)
    vp, pp = sk.select_min_k_plain(x, 2000)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))


def test_knn_search_past_the_old_limit_matches_plain(cuda, monkeypatch):
    """knn_search at k = 2 048 on 30 720 points (30 blocks of (1 024, 30 720)
    distance rows, which the card refused before the filter took every k)
    against the same search with K3's plain version on the card: the same
    distances, so equal index for index and value for value."""
    from gaussreg_tpu_torch.ops import neighbors as nb
    from gaussreg_tpu_torch.ops import select_k as sk

    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.uniform(0, 2.0, size=(30_720, 3)).astype(np.float32)).to(cuda)
    m = torch.ones(s.shape[0], dtype=torch.bool, device=cuda)
    m[-100:] = False
    route = sk.ROUTES[sk.route(30_720, 2048, 1024)]
    before = route.launches
    idx, d2 = nb.knn_search(s, s, m, m, 2048)
    torch.cuda.synchronize()
    assert route.launches - before == 30
    monkeypatch.setattr(nb, "select_min_k", sk.select_min_k_plain)
    idx_p, d2_p = nb.knn_search(s, s, m, m, 2048)
    assert torch.equal(idx, idx_p)
    assert torch.equal(d2.view(torch.int32), d2_p.view(torch.int32))


def test_radius_search_wide_rows_matches_plain(cuda):
    """The brute-force radius search at a level-0 width (N = 30 720 support
    points: the wide mode) on the card against the same search on the
    card's inputs moved to the CPU (the plain stable sort): the card and
    the CPU form the gram distances with other roundings, so equal up to
    last-bit swaps, which must be rare."""
    from gaussreg_tpu_torch.ops import neighbors as nb
    from gaussreg_tpu_torch.ops import select_k as sk

    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.uniform(0, 2.0, size=(30_720, 3)).astype(np.float32))
    q = s[::10].clone()
    qm = torch.ones(q.shape[0], dtype=torch.bool)
    sm = torch.ones(s.shape[0], dtype=torch.bool)
    sm[-100:] = False
    before = sk.WIDE_KERNEL.launches
    got = nb.radius_search(q.to(cuda), s.to(cuda), qm.to(cuda), sm.to(cuda), 0.0625, 35)
    torch.cuda.synchronize()
    assert sk.WIDE_KERNEL.launches - before == -(-q.shape[0] // 1024)
    want = nb.radius_search(q, s, qm, sm, 0.0625, 35)
    assert (got.cpu() != want).float().mean().item() < 1e-3


GENERIC_CASES = ["unsorted", "empty_segments", "dropped", "one_id", "boundary_runs", "descending",
                 "all_dropped", "num_out_1", "no_rows"]


def generic_case(case, rng):
    """(rows (R, 16) f32, gid (R,) int32, num_out) on the CPU for one case of
    K6's generic entry."""
    r, num_out = 200_000, 30_001
    gid = rng.integers(0, num_out, size=r)
    if case == "empty_segments":
        gid = gid - gid % 5  # four of five rows of the table empty
    elif case == "dropped":
        gid[::7] = num_out + rng.integers(0, 3, size=gid[::7].shape)
        gid[1::7] = -1 - rng.integers(0, 3, size=gid[1::7].shape)
    elif case == "one_id":
        gid = np.full(r, 12_345)  # one run of every row: the block's row-order walk
    elif case == "boundary_runs":
        # runs of 15-17 and 31-33 rows (either side of the register path's
        # 32 and of its 16-row batches) on distinct ids, shuffled
        lengths = np.resize([15, 16, 17, 31, 32, 33, 1, 2], 6_000)
        ids = rng.permutation(num_out)[:lengths.size]
        gid = rng.permutation(np.repeat(ids, lengths))
        r = gid.size
    elif case == "descending":
        gid = np.sort(gid)[::-1].copy()
    elif case == "all_dropped":
        gid = num_out + rng.integers(0, 100, size=r)
    elif case == "num_out_1":
        num_out = 1
        gid = rng.integers(-1, 2, size=r)
    elif case == "no_rows":
        r, gid = 0, np.zeros(0)
    rows = torch.from_numpy(rng.normal(size=(r, 16)).astype(np.float32))
    return rows, torch.from_numpy(gid.astype(np.int32)), num_out


@pytest.mark.parametrize("case", GENERIC_CASES)
def test_segment_accumulate_generic_entry_matches_plain(cuda, case):
    """K6's own signature on the card (the counting-sort entry of
    csrc/segment_accumulate.cu). Equal bit for bit to segment_accumulate_plain
    on the CPU (a sequential index_add_ in row order) with unsorted ids,
    empty segments, ids past the table and below 0, one id holding all
    200 000 rows, runs of 15-17 and 31-33 rows, ids in descending row order,
    every id dropped, num_out = 1 and no rows; one launch counted per call,
    and a second call on the same inputs equal bit for bit (the atomics'
    order must not show)."""
    from gaussreg_tpu_torch.gs.rasterizer import accumulate as acc

    rows, gid, num_out = generic_case(case, np.random.default_rng(7))
    rows_d, gid_d = rows.to(cuda), gid.to(cuda)
    before = acc.GENERIC_KERNEL.launches
    out = acc.segment_accumulate(rows_d, gid_d, num_out)
    again = acc.segment_accumulate(rows_d, gid_d, num_out)
    torch.cuda.synchronize()
    assert acc.GENERIC_KERNEL.launches == before + 2
    assert out.shape == (num_out, 16)
    assert torch.equal(out.cpu(), acc.segment_accumulate_plain(rows, gid, num_out))
    assert torch.equal(again, out)


@pytest.mark.parametrize("kernel_size", [20, 36])
def test_kpconv_past_16_kernel_points_on_the_card(cuda, kernel_size):
    """A make_tiny_cfg() KPConvFPN at kernel_size 20 and 36 on the card
    takes the einsum route (14 calls, no K2 launch) and agrees with the same
    model on the CPU within K2's 4e-3 of the max; kpconv_fused_apply still
    refuses K > 16 on the card."""
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.pipeline import make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.models import kpconv as kp
    from gaussreg_tpu_torch.models.backbone import KPConvFPN
    from gaussreg_tpu_torch.ops import kpconv_kernel as kk

    cfg = make_tiny_cfg()
    batch = make_pair_batch(cfg, *random_pair(cfg, 0, num_points=600), device="cpu")
    bc = cfg.backbone
    model = KPConvFPN(batch.features.shape[-1], bc.output_dim, bc.init_dim, kernel_size,
                      bc.init_radius, bc.init_sigma, bc.group_norm)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(batch.features, batch.pyramid)
        gpu = model.to(cuda)
        pyr = type(batch.pyramid)(*[tuple(a.to(cuda) for a in f) if isinstance(f, tuple)
                                    else f.to(cuda) for f in batch.pyramid])
        einsum, k2 = kp.EinsumRoute.calls, kk.KERNEL.launches
        got = gpu(batch.features.to(cuda), pyr)
        torch.cuda.synchronize()
    assert (kp.EinsumRoute.calls - einsum, kk.KERNEL.launches - k2) == (14, 0)
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert (g.cpu() - w).abs().max().item() <= 4e-3 * scale
    nf = torch.zeros(1, 4, 8, 16, device=cuda, dtype=torch.bfloat16)
    infl = torch.zeros(1, 4, 8, kernel_size, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K <= 16"):
        kk.kpconv_fused_apply(nf, infl, torch.zeros(kernel_size, 16, 8, device=cuda))
