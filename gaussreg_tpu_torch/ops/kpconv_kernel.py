"""Fused KPConv aggregation: influence-weighted neighbor-feature aggregation
plus kernel-weight contraction (port of gaussreg_tpu/ops/kpconv_kernel.py,
TPU kernel K2).

`kpconv_fused_apply` launches the CUDA kernel csrc/kpconv_fused.cu for CUDA
tensors and runs `reference_apply` (the plain version) for CPU tensors.
Numerics of the Pallas kernel and of the JAX einsum pair: bf16 products
(exact in f32), f32 accumulation over the neighbor slots, the sum rounded
to bf16, then contracted with the bf16-rounded weights in f32. Forward
only: the port runs inference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gaussreg_tpu_torch.ops import _cuda

KERNEL = _cuda.register(
    "kpconv_fused_apply",
    _cuda.CudaKernel(
        "kpconv_fused.cu",
        "gaussreg_kpconv_fused",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    ),
)

MAX_KERNEL_POINTS = 16
# csrc/kpconv_fused.cu: 64 rows per block up to 48 neighbour slots (44 at
# K = 16), 32 past that (the reference checkpoint's limits, 89 at level 0)
MAX_NEIGHBORS = 96


def reference_apply(nf: torch.Tensor, infl: torch.Tensor, weights: torch.Tensor):
    """Plain version: nf (..., H, C) bf16, infl (..., H, K) bf16,
    weights (K, C, D) -> (..., D) f32, as two f32 einsums on bf16 values."""
    weighted = torch.einsum("...hk,...hc->...kc", infl.float(), nf.float())
    weighted = weighted.to(torch.bfloat16).float()
    w = weights.to(torch.bfloat16).float()
    lead = weighted.shape[:-2]
    out = weighted.reshape(-1, w.shape[0] * w.shape[1]) @ w.reshape(-1, w.shape[2])
    return out.reshape(lead + (w.shape[2],))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernel's copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kpconv_fused_apply(nf: torch.Tensor, infl: torch.Tensor, weights: torch.Tensor):
    """out[b,m,d] = sum_{h,k,c} infl[b,m,h,k] nf[b,m,h,c] weights[k,c,d].

    nf: (B, M, H, C) bf16 gathered neighbor features (zeros at sentinels).
    infl: (B, M, H, K) bf16 kernel influences.
    weights: (K, C, D) f32, rounded to bf16 for the contraction.
    Returns (B, M, D) f32."""
    b, m, h, c = nf.shape
    k = infl.shape[-1]
    d = weights.shape[-1]
    if infl.shape[:3] != (b, m, h) or weights.shape[:2] != (k, c):
        raise ValueError(
            f"kpconv_fused_apply: shapes {tuple(nf.shape)}, {tuple(infl.shape)}, "
            f"{tuple(weights.shape)} do not agree"
        )
    if nf.device.type == "cpu":
        return reference_apply(nf, infl, weights)
    if k > MAX_KERNEL_POINTS or h > MAX_NEIGHBORS:
        raise ValueError(f"kpconv_fused_apply: needs K <= {MAX_KERNEL_POINTS} and H <= "
                         f"{MAX_NEIGHBORS}, got K={k}, H={h}")
    # the kernel copies nf in 8- or 16-byte pieces and W in 16-byte pieces:
    # C a multiple of 4 (the backbone's widths are; others are padded to 8)
    # and D a multiple of 8. Zero channels (features and weights) and zero
    # output columns are exact padding.
    cp = c if c % 4 == 0 else -(-c // 8) * 8
    dp = -(-d // 8) * 8
    nf2 = nf.reshape(b * m, h, c)
    w2 = weights.to(torch.bfloat16)
    if (cp, dp) != (c, d):
        nf2 = F.pad(nf2, (0, cp - c))
        w2 = F.pad(w2, (0, dp - d, 0, cp - c))
    nf2, w2 = _aligned(nf2), _aligned(w2)
    infl2 = _aligned(infl.reshape(b * m, h, k))
    _cuda.check_cuda_tensor(nf2, "nf", torch.bfloat16, 3)
    _cuda.check_cuda_tensor(infl2, "infl", torch.bfloat16, 3)
    _cuda.check_cuda_tensor(w2, "weights", torch.bfloat16, 3)
    out = torch.empty((b * m, dp), dtype=torch.float32, device=nf.device)
    if b * m:
        KERNEL.launch(
            nf2.data_ptr(), infl2.data_ptr(), w2.data_ptr(), out.data_ptr(),
            b * m, h, k, cp, dp,
        )
    return out[:, :d].reshape(b, m, d)
