"""Probe P2 on the card: the rasterizer forward's compositing loop with four
interchangeable math cores (port of tools/probe_kernels_r5.py).

    python -m gaussreg_tpu_torch.tools.probe_kernels_r5 [--tiles 300] [--blocks 7]
        [--source copy.cu ...]

One launch per core (csrc/probe_composite.cu, one kernel template per core)
walks each 32x32 tile's 128-pair chunks of channel-major blocks
(nblk, 16, 128) f32 and composites colour rows 8:12 with the core's
transmittance, exiting tile-wide once T < 1e-4 after a chunk:

  A  log-space prefix: lg = log1p(-alpha), a running f32 sum per pixel
  B  the prefix of bf16-rounded lg, summed in f32
  C  lg split into bf16 hi and lo, two prefixes summed in f32
  D  linear space: the running product of (1 - alpha), no log, no 2nd exp

The kernel composites each tile with a cluster of CLUSTER blocks (the
source's kCluster) that agree on the tile's exit through distributed
shared memory.

`run_fwd` takes the probe's arguments; for CPU tensors it runs
`composite_plain`, the plain PyTorch version (vectorised over tiles, the
prefix as the JAX core takes it: a triangular product for B and C). main()
prints per core kend's mean, the max difference from the plain version and
from A, the time per call (a slope over graph-replayed launches with inputs
perturbed per repetition, `utils.timing.slope`, the probe's timer) beside
its bound and the special-function unit's time; then the cluster sweep
(copies of the source with 1 and 4 blocks a tile, `cluster_copy`) and each
--source copy: each copy's cores timed beside the shipped build, their
bits compared with the shipped build's. The last line is all of it as
JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

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
# blocks per tile's cluster: csrc/probe_composite.cu's kCluster; main()
# times copies with the others of the sweep
CLUSTER = 2
CLUSTER_SWEEP = (1, 4)

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int]
KERNELS = {
    core: _cuda.register(
        f"probe_composite_{core}",
        _cuda.CudaKernel("probe_composite.cu", f"gaussreg_probe_composite_{core.lower()}", _ARGS),
    )
    for core in CORES
}
# counts the f32 alpha in [0, 0.99] at which the kernels' branch-free log1p
# differs from the library's log1pf (not registered: no core's launch)
LOG1P_CHECK = _cuda.CudaKernel("probe_composite.cu", "gaussreg_probe_composite_log1p_check",
                               [ctypes.c_void_p])

# f32 operations per pair and pixel, counted from the function (the JAX
# probe's math), whatever a kernel executes: the exponent 10 (5 products,
# 5 sums), min 1, exp 1, cut and cap 2, row mask 1, four colour
# multiply-adds 8 -> 23 in every core; then A: log1p, prefix sum, exp, T x,
# alpha x -> 28; B: log1p, bf16 rounding, exp, T x, alpha x (the prefix's
# sum) -> 28; C: log1p, hi, lo (difference and rounding), cum_hi + cum_lo,
# exp, T x, alpha x -> 31; D: 1 - alpha, the product, the difference,
# T x -> 27.
OPS_PER_PAIR_PIXEL = {"A": 28.0, "B": 28.0, "C": 31.0, "D": 27.0}
# the transcendentals that need the special-function unit: alpha's exp and
# the transmittance's exp in A-C, alpha's exp in D (log1p is a polynomial
# on the FMA pipe, counted above as an f32 operation)
TRANSCENDENTALS_PER_PAIR_PIXEL = {"A": 2, "B": 2, "C": 2, "D": 1}
# H100 SXM: the data sheet's f32 peak (outside the tensor cores) and memory
# rate; 16 special-function (MUFU) results per SM and clock (the CUDA
# programming guide's throughput table, compute capability 9.0)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
MUFU_PER_SM_CLOCK = 16


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
            tile_h: int = 32, tile_w: int = 32, *,
            kernel: _cuda.CudaKernel | None = None) -> torch.Tensor:
    """Composite `num_tiles` 32x32 tiles with core `variant` (A, B, C or D).

    pair_blocks: (nblk, 16, 128) f32; starts: (num_tiles + 1,) int32 pair
    offsets. Returns (num_tiles, 6, 1024) f32: rgb+a (4), T, kend. On the
    card through `kernel` (default: the core's registered kernel; main()
    and the card tests pass copies' builds)."""
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
    (kernel or KERNELS[variant]).launch(pair_blocks.data_ptr(), starts.data_ptr(),
                                        out.data_ptr(), num_tiles, pair_blocks.shape[0],
                                        IMAGE_WIDTH // tile_w)
    return out


def cluster_copy(cluster: int, directory: str):
    """The cores of a copy of csrc/probe_composite.cu, written into
    `directory`, whose tiles are clusters of `cluster` blocks (1, 2, 4 or
    8): {core: kernel}, for run_fwd(kernel=...)."""
    source = KERNELS["A"].source
    with open(source) as f:
        text, n = re.subn(r"constexpr int kCluster = \d+;", f"constexpr int kCluster = {cluster};",
                          f.read())
    if n != 1:
        raise RuntimeError(f"cluster_copy: no kCluster in {source}")
    path = os.path.join(directory, f"probe_composite_cluster{cluster}.cu")
    with open(path, "w") as f:
        f.write(text)
    return {c: _cuda.CudaKernel(path, k.symbol, k.argtypes) for c, k in KERNELS.items()}


def log1p_mismatches(device) -> int:
    """The alpha in [0, 0.99] (every f32 value) at which the kernels' log1p
    and the library's log1pf differ other than by the sign of a zero."""
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    LOG1P_CHECK.launch(bad.data_ptr())
    return int(bad.item())


def pair_pixels(out: torch.Tensor, starts: torch.Tensor, chunk_n: int = CHUNK) -> float:
    """Pair-pixels the call composites: per tile its own rows of the chunks
    it walked (kend, out[:, 5]) times the tile's pixels."""
    s = starts.to(torch.int64)
    c0, c1 = s[:-1], s[1:]
    walked_end = (c0 // chunk_n + out[:, 5, 0].to(torch.int64)) * chunk_n
    return float((torch.minimum(c1, walked_end) - c0).clamp_min(0).sum()) * out.shape[2]


def walked_blocks(starts: torch.Tensor, kend: torch.Tensor, nblk: int) -> int:
    """Distinct blocks the tiles walked: tile t reads blocks
    starts[t] // 128 .. + kend[t] - 1."""
    first = starts[:-1].long().clamp_max(nblk * CHUNK) // CHUNK
    span = torch.arange(int(kend.max()) if kend.numel() else 0, device=kend.device)
    ids = first[:, None] + span[None]
    return int(torch.unique(ids[span[None] < kend.long()[:, None]]).numel())


def sm_clock_mhz() -> float:
    """The SM clock's maximum, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def bound(out: torch.Tensor, starts: torch.Tensor, nblk: int, core: str, sms: int,
          clock_mhz: float):
    """The least time the call could take: the largest of its f32
    operations at PEAK_F32_FLOPS, its transcendentals at MUFU_PER_SM_CLOCK
    results per SM and clock on `sms` SMs at `clock_mhz`, and its bytes (the
    walked blocks once, the starts and the output) at PEAK_BYTES_PER_S. The
    counts are the function's (OPS_PER_PAIR_PIXEL,
    TRANSCENDENTALS_PER_PAIR_PIXEL) over the walked pair-pixels. Returns
    (ms, what sets it: "f32 operations", "transcendentals" or "bytes", the
    three times in ms by name)."""
    pp = pair_pixels(out, starts)
    nbytes = (walked_blocks(starts, out[:, 5, 0], nblk) * NCHAN * CHUNK * 4
              + starts.numel() * 4 + out.numel() * 4)
    times = {
        "f32 operations": pp * OPS_PER_PAIR_PIXEL[core] / PEAK_F32_FLOPS * 1e3,
        "transcendentals": pp * TRANSCENDENTALS_PER_PAIR_PIXEL[core]
        / (MUFU_PER_SM_CLOCK * sms * clock_mhz * 1e6) * 1e3,
        "bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by, times


def perturbed(blocks: torch.Tensor, n: int):
    """n copies of the blocks, copy i with 1e-9 * i added to every value
    (the probe's per-repetition perturbation)."""
    return [blocks + 1e-9 * i for i in range(n)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiles", type=int, default=300)
    parser.add_argument("--blocks", type=int, default=7, help="blocks per tile")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--source", action="append", default=[],
                        help="another copy of csrc/probe_composite.cu to time beside the shipped one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels_r5: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_mhz()
    print(f"{card}; {sms} SMs at up to {clock:.0f} MHz", flush=True)
    with tempfile.TemporaryDirectory(prefix="probe_composite_") as copies_dir:
        sources = {f"cluster of {cl}": cluster_copy(cl, copies_dir) for cl in CLUSTER_SWEEP}
        sources.update({os.path.splitext(os.path.basename(p))[0]: {
            c: _cuda.CudaKernel(os.path.abspath(p), k.symbol, k.argtypes)
            for c, k in KERNELS.items()} for p in args.source})
        _cuda._build([KERNELS["A"]] + [ks["A"] for ks in sources.values()])
        for kernels in sources.values():  # loaded while the copies exist
            for k in kernels.values():
                k._load()
    blocks_np, starts_np, _ = make_blocks(args.tiles, args.blocks, args.seed)
    blocks = torch.from_numpy(blocks_np).cuda()
    starts = torch.from_numpy(starts_np).cuda()
    nblk = blocks.shape[0]
    copies = perturbed(blocks, 16)
    print(f"blocks {tuple(blocks.shape)} tiles {args.tiles}, a cluster of {CLUSTER} blocks per "
          f"tile", flush=True)
    result = {"card": card, "sms": sms, "clock_mhz": clock, "cluster": CLUSTER, "cores": {},
              "log1p_mismatches": log1p_mismatches(blocks.device)}
    print(f"the kernels' log1p against log1pf at every f32 alpha in [0, 0.99]: "
          f"{result['log1p_mismatches']} differ", flush=True)
    outs = {}
    for v in CORES:
        out = outs[v] = run_fwd(blocks, starts, v, args.tiles)
        ref = composite_plain(blocks, starts, v, args.tiles)
        torch.cuda.synchronize()
        err = (out[:, :5] - ref[:, :5]).abs().max().item()
        vs_a = (out[:, :5] - outs["A"][:, :5]).abs().max().item()
        kend_equal = torch.equal(out[:, 5], ref[:, 5])
        ms = slope(lambda i, v=v: run_fwd(copies[i], starts, v, args.tiles)) * 1e3
        b_ms, by, parts = bound(out, starts, nblk, v, sms, clock)
        result["cores"][v] = {"ms": ms, "err_vs_plain": err, "vs_a": vs_a,
                              "kend_equal": kend_equal, "bound_ms": b_ms, "bound_by": by,
                              "parts_ms": parts, "kend_mean": out[:, 5, 0].mean().item(),
                              "pair_pixels": pair_pixels(out, starts)}
        print(f"{v}: kend mean {out[:, 5, 0].mean().item():.2f} of {args.blocks}, kend "
              f"{'equal to' if kend_equal else 'DIFFERS from'} the plain version's, max diff "
              f"{err:.3e} from it, {vs_a:.3e} from A; {ms:.4f} ms ({ms * 1e6 / nblk:.0f} ns/blk); "
              f"bound {b_ms:.4f} ms by {by} (f32 operations {parts['f32 operations']:.4f}, "
              f"transcendentals at {MUFU_PER_SM_CLOCK} MUFU results per SM and clock "
              f"{parts['transcendentals']:.4f}, bytes {parts['bytes']:.4f}): "
              f"{100 * b_ms / ms:.1f}% of the bound", flush=True)
    result["sources"] = {}
    for name, kernels in sources.items():
        result["sources"][name] = {}
        for v in CORES:
            out = run_fwd(blocks, starts, v, args.tiles, kernel=kernels[v])
            ref = composite_plain(blocks, starts, v, args.tiles)
            err = (out[:, :5] - ref[:, :5]).abs().max().item()
            same = torch.equal(out, outs[v])
            ms = slope(lambda i, v=v: run_fwd(copies[i], starts, v, args.tiles,
                                              kernel=kernels[v])) * 1e3
            shipped = slope(lambda i, v=v: run_fwd(copies[i], starts, v, args.tiles)) * 1e3
            result["sources"][name][v] = {"ms": ms, "shipped_ms": shipped, "err_vs_plain": err,
                                          "kend_equal": torch.equal(out[:, 5], ref[:, 5]),
                                          "equal_to_shipped": same}
            print(f"{name} {v}: {ms:.4f} ms beside the shipped build's {shipped:.4f}, max diff "
                  f"{err:.3e} from the plain version, bits "
                  f"{'equal to' if same else 'differing from'} the shipped build's", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
