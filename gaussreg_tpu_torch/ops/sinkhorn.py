"""Log-domain Sinkhorn optimal transport with a learnable dustbin
(port of gaussreg_tpu/ops/sinkhorn.py)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

_INF = 1e12


def log_optimal_transport(
    scores: torch.Tensor,  # (B, M, N)
    row_masks: torch.Tensor,  # (B, M) bool
    col_masks: torch.Tensor,  # (B, N) bool
    alpha: torch.Tensor,  # () dustbin score
    num_iterations: int = 100,
) -> torch.Tensor:
    """Returns the (B, M+1, N+1) log transport plan. Under grad each
    iteration's body is checkpointed (`torch.utils.checkpoint`), as the JAX
    package's scan body is `jax.checkpoint`ed."""
    b, m, n = scores.shape
    dtype = scores.dtype
    false = torch.zeros((b, 1), dtype=torch.bool, device=scores.device)
    pad_row_invalid = torch.cat([~row_masks, false], dim=1)
    pad_col_invalid = torch.cat([~col_masks, false], dim=1)
    score_invalid = pad_row_invalid[:, :, None] | pad_col_invalid[:, None, :]

    alpha = alpha.to(dtype)
    padded = torch.cat([scores, alpha.expand(b, m, 1)], dim=2)
    padded = torch.cat([padded, alpha.expand(b, 1, n + 1)], dim=1)
    padded = padded.masked_fill(score_invalid, -_INF)

    num_valid_row = row_masks.sum(dim=1).to(dtype)
    num_valid_col = col_masks.sum(dim=1).to(dtype)
    norm = -torch.log(num_valid_row + num_valid_col)  # (B,)

    log_mu = torch.cat(
        [norm[:, None].expand(b, m), (torch.log(num_valid_col) + norm)[:, None]], dim=1
    ).masked_fill(pad_row_invalid, -_INF)
    log_nu = torch.cat(
        [norm[:, None].expand(b, n), (torch.log(num_valid_row) + norm)[:, None]], dim=1
    ).masked_fill(pad_col_invalid, -_INF)

    def body(u, v):
        u = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded + u[:, :, None], dim=1)
        return u, v

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    # under grad each iteration is recomputed in the backward: only the
    # (u, v) carries are saved, not 2 * num_iterations (B, M+1, N+1)
    # logsumexp residuals (3+ GB at make_cfg() sizes)
    remat = torch.is_grad_enabled() and (padded.requires_grad or alpha.requires_grad)
    for _ in range(num_iterations):
        if remat:
            u, v = checkpoint(body, u, v, use_reentrant=False)
        else:
            u, v = body(u, v)

    out = padded + u[:, :, None] + v[:, None, :]
    return out - norm[:, None, None]
