"""Probe P2 on the card: the rasterizer forward's compositing loop with four
interchangeable math cores (port of tools/probe_kernels_r5.py).

    python -m gaussreg_tpu_torch.tools.probe_kernels_r5 [--tiles 300] [--blocks 7]

One launch per core (csrc/probe_composite.cu, one kernel template per core)
walks each 32x32 tile's 128-pair chunks of channel-major blocks
(nblk, 16, 128) f32 and composites colour rows 8:12 with the core's
transmittance, exiting tile-wide once T < 1e-4 after a chunk:

  A  log-space prefix: lg = log1p(-alpha), a running f32 sum per pixel
  B  the prefix of bf16-rounded lg on mma.sync tensor cores (f32 sums)
  C  lg split into bf16 hi and lo, two tensor-core prefixes, f32 sums
  D  linear space: the running product of (1 - alpha), no log, no 2nd exp

`run_fwd` takes the probe's arguments; for CPU tensors it runs
`composite_plain`, the plain PyTorch version (vectorised over tiles, the
prefix as the JAX core takes it: a triangular product for B and C). main()
prints per core kend's mean, the max difference from A, and the time per
call and per block, a slope over graph-replayed launches with inputs
perturbed per repetition (`utils.timing.slope`, the probe's timer).
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from gaussreg_tpu_torch.ops import _cuda
from gaussreg_tpu_torch.utils.timing import slope

CHUNK = 128
NCHAN = 16
T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
IMAGE_WIDTH = 640
CORES = ("A", "B", "C", "D")

KERNELS = {
    core: _cuda.register(
        f"probe_composite_{core}",
        _cuda.CudaKernel(
            "probe_composite.cu", f"gaussreg_probe_composite_{core.lower()}",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int],
        ),
    )
    for core in CORES
}

# f32 operations per pair and pixel, counted from csrc/probe_composite.cu:
# the exponent 10 (5 products, 5 sums), min 1, exp 1, cut and cap 2, row
# mask 1, four colour multiply-adds 8 -> 23 in every core; then
# A: log1p, prefix sum, exp, T x, alpha x -> 28; B: log1p, bf16 rounding,
# exp, T x, alpha x (the prefix on tensor cores) -> 28; C: log1p, hi, lo
# (difference and rounding), cum_hi + cum_lo, exp, T x, alpha x -> 31;
# D: 1 - alpha, the product, the difference, T x -> 27.
OPS_PER_PAIR_PIXEL = {"A": 28.0, "B": 28.0, "C": 31.0, "D": 27.0}
# exp, log1p and exp in A-C; exp in D
TRANSCENDENTALS_PER_PAIR_PIXEL = {"A": 3, "B": 3, "C": 3, "D": 1}


def make_blocks(num_tiles: int = 300, blocks_per_tile: int = 7, seed: int = 0):
    """Synthetic channel-major pair blocks with a realistic alpha mix, drawn
    from numpy's generator as the JAX probe draws them (the same arrays for
    the same seed). Low opacity (0.01-0.05), yet many tiles still fall below
    T = 1e-4 before their last block and leave early: at the default shape
    1 768 of the 2 100 chunks are walked, kend mean 5.89 of 7 (PERF.md,
    section 6). Returns (blocks (nblk, 16, 128) f32 numpy,
    starts (num_tiles + 1,) int32 numpy, number of pairs)."""
    nblk = num_tiles * blocks_per_tile
    rng = np.random.default_rng(seed)
    g = nblk * CHUNK
    blocks = np.zeros((nblk, NCHAN, CHUNK), np.float32)
    tile_w = tile_h = 32
    ntx = IMAGE_WIDTH // tile_w
    for b in range(nblk):
        t = b // blocks_per_tile
        tx, ty = t % ntx, t // ntx
        cx = rng.uniform(0, tile_w, CHUNK) + tx * tile_w
        cy = rng.uniform(0, tile_h, CHUNK) + ty * tile_h
        inv_s2 = 1.0 / rng.uniform(2.0, 40.0, CHUNK) ** 2
        op = rng.uniform(0.01, 0.05, CHUNK)
        a0 = -0.5 * inv_s2 * (cx * cx + cy * cy) + np.log(op)
        blocks[b, 0] = a0
        blocks[b, 1] = inv_s2 * cx
        blocks[b, 2] = inv_s2 * cy
        blocks[b, 3] = -0.5 * inv_s2
        blocks[b, 4] = 0.0
        blocks[b, 5] = -0.5 * inv_s2
        blocks[b, 8:12] = rng.uniform(0, 1, (4, CHUNK))
    starts = np.arange(num_tiles + 1, dtype=np.int32) * blocks_per_tile * CHUNK
    return blocks, starts, g


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def composite_plain(pair_blocks: torch.Tensor, starts: torch.Tensor, variant: str,
                    num_tiles: int, tile_h: int = 32, tile_w: int = 32) -> torch.Tensor:
    """The probe's function in plain PyTorch, all tiles at once, chunk by
    chunk; tiles that have left (walked all their chunks, or T < 1e-4
    everywhere after a chunk) keep their state. The exponent is summed in
    the kernel's order with every product and sum rounded to f32."""
    dev = pair_blocks.device
    nblk, _, chunk_n = pair_blocks.shape
    npix = tile_h * tile_w
    cap = nblk * chunk_n
    s = starts.to(torch.int64).clamp_max(cap)
    c0, c1 = s[:num_tiles], s[1:num_tiles + 1]
    start_blk = c0 // chunk_n
    num_chunks = torch.where(c1 > c0, (c1 - 1) // chunk_n - start_blk + 1, 0)
    t = torch.arange(num_tiles, device=dev)
    lane = torch.arange(npix, device=dev)
    ntx = IMAGE_WIDTH // tile_w
    x = ((lane % tile_w).float()[None] + (t % ntx).float()[:, None] * tile_w) + 0.5
    y = ((lane // tile_w).float()[None] + (t // ntx).float()[:, None] * tile_h) + 0.5
    phi = [x[:, None], y[:, None], (x * x)[:, None], (x * y)[:, None], (y * y)[:, None]]
    rows = torch.arange(chunk_n, device=dev)
    l_strict = (rows[:, None] > rows[None, :]).float()

    rgb = torch.zeros((num_tiles, 4, npix), device=dev)
    t_row = torch.ones((num_tiles, 1, npix), device=dev)
    kend = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    alive = num_chunks > 0
    for k in range(int(num_chunks.max()) if num_tiles else 0):
        active = alive & (k < num_chunks)
        if not bool(active.any()):
            break
        coeffs = pair_blocks[(start_blk + k).clamp_max(nblk - 1)]  # (tiles, 16, chunk)
        gpos = (start_blk + k)[:, None] * chunk_n + rows[None]
        rowmask = ((gpos >= c0[:, None]) & (gpos < c1[:, None])).float()[:, :, None]
        c = coeffs[:, :6, :, None]  # (tiles, 6, chunk, 1)
        power = c[:, 0]
        for i in range(5):
            power = power + c[:, i + 1] * phi[i]
        raw = torch.exp(torch.clamp_max(power, 0.0))
        alpha = torch.where(raw < ALPHA_MIN, 0.0, torch.clamp_max(raw, ALPHA_MAX)) * rowmask
        if variant in ("A", "B", "C"):
            lg = torch.log1p(-alpha)
            if variant == "A":
                incl = torch.cumsum(lg, dim=1)
                cum = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
            elif variant == "B":
                cum = torch.matmul(l_strict, _bf16(lg))
            else:
                hi = _bf16(lg)
                cum = torch.matmul(l_strict, hi) + torch.matmul(l_strict, _bf16(lg - hi))
            w = alpha * (t_row * torch.exp(cum))
            new_t = t_row * torch.exp(cum[:, -1:] + lg[:, -1:])
        elif variant == "D":
            incl = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
            w = t_row * (excl - incl)
            new_t = t_row * incl[:, -1:]
        else:
            raise ValueError(f"unknown core {variant!r}")
        sel = active[:, None, None]
        rgb = torch.where(sel, rgb + torch.matmul(coeffs[:, 8:12], w), rgb)
        t_row = torch.where(sel, new_t, t_row)
        kend = kend + active.long()
        alive = active & (new_t.amax(dim=(1, 2)) >= T_EPS)
    out = torch.empty((num_tiles, 6, npix), device=dev)
    out[:, :4] = rgb
    out[:, 4:5] = t_row
    out[:, 5] = kend.float()[:, None]
    return out


def run_fwd(pair_blocks: torch.Tensor, starts: torch.Tensor, variant: str, num_tiles: int,
            tile_h: int = 32, tile_w: int = 32) -> torch.Tensor:
    """Composite `num_tiles` 32x32 tiles with core `variant` (A, B, C or D).

    pair_blocks: (nblk, 16, 128) f32; starts: (num_tiles + 1,) int32 pair
    offsets. Returns (num_tiles, 6, 1024) f32: rgb+a (4), T, kend."""
    if variant not in CORES:
        raise ValueError(f"run_fwd: unknown core {variant!r}")
    if pair_blocks.dim() != 3 or pair_blocks.shape[1:] != (NCHAN, CHUNK):
        raise ValueError(f"run_fwd: need (nblk, {NCHAN}, {CHUNK}) blocks, got "
                         f"{tuple(pair_blocks.shape)}")
    if starts.shape != (num_tiles + 1,):
        raise ValueError(f"run_fwd: need {num_tiles + 1} starts, got {tuple(starts.shape)}")
    if pair_blocks.device.type == "cpu":
        return composite_plain(pair_blocks, starts, variant, num_tiles, tile_h, tile_w)
    if (tile_h, tile_w) != (32, 32):
        raise ValueError(f"run_fwd: the kernels take 32x32 tiles, got {tile_h}x{tile_w}")
    _cuda.check_cuda_tensor(pair_blocks, "pair_blocks", torch.float32, 3)
    _cuda.check_cuda_tensor(starts, "starts", torch.int32, 1)
    out = torch.empty((num_tiles, 6, tile_h * tile_w), dtype=torch.float32,
                      device=pair_blocks.device)
    KERNELS[variant].launch(pair_blocks.data_ptr(), starts.data_ptr(), out.data_ptr(),
                            num_tiles, pair_blocks.shape[0], IMAGE_WIDTH // tile_w)
    return out


def pair_pixels(out: torch.Tensor, starts: torch.Tensor, chunk_n: int = CHUNK) -> float:
    """Pair-pixels the call composites: per tile its own rows of the chunks
    it walked (kend, out[:, 5]) times the tile's pixels."""
    s = starts.to(torch.int64)
    c0, c1 = s[:-1], s[1:]
    walked_end = (c0 // chunk_n + out[:, 5, 0].to(torch.int64)) * chunk_n
    return float((torch.minimum(c1, walked_end) - c0).clamp_min(0).sum()) * out.shape[2]


def perturbed(blocks: torch.Tensor, n: int):
    """n copies of the blocks, copy i with 1e-9 * i added to every value
    (the probe's per-repetition perturbation)."""
    return [blocks + 1e-9 * i for i in range(n)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiles", type=int, default=300)
    parser.add_argument("--blocks", type=int, default=7, help="blocks per tile")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels_r5: needs a CUDA card")
    blocks_np, starts_np, _ = make_blocks(args.tiles, args.blocks, args.seed)
    blocks = torch.from_numpy(blocks_np).cuda()
    starts = torch.from_numpy(starts_np).cuda()
    print(f"blocks {tuple(blocks.shape)} tiles {args.tiles}")
    ref = None
    for v in CORES:
        out = run_fwd(blocks, starts, v, args.tiles)
        if ref is None:
            ref = out
            print(f"{v}: reference; kend mean {out[:, 5, 0].mean().item():.2f} "
                  f"of {args.blocks} per tile: low-opacity tiles still leave early)")
        else:
            diff = (out[:, :5] - ref[:, :5]).abs().max().item()
            print(f"{v}: maxdiff vs A = {diff:.3e}")
    copies = perturbed(blocks, 16)
    for v in CORES:
        dt = slope(lambda i, v=v: run_fwd(copies[i], starts, v, args.tiles))
        print(f"variant {v}: {dt * 1e3:.4f} ms  ({dt * 1e9 / blocks.shape[0]:.0f} ns/blk)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
