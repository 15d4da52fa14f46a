"""Transformer layers: vanilla and geometric-RPE attention, conditional stack
(port of the parts of gaussreg_tpu/models/transformer.py the model runs).

Masks use the valid convention (True = keep). LayerNorm eps is 1e-6, flax's
default. Attention is einsum + softmax, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussreg_tpu_torch.models import initializers as init


def sinusoidal_embedding(indices: torch.Tensor, d_model: int) -> torch.Tensor:
    """Continuous-index sinusoidal embedding with interleaved [sin, cos]."""
    div = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=indices.device)
        * (-np.log(10000.0) / d_model)
    )
    omega = indices[..., None] * div
    emb = torch.stack([torch.sin(omega), torch.cos(omega)], dim=-1)
    return emb.reshape(indices.shape + (d_model,))


def _masked_softmax(scores, key_valid):
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[..., None, None, :], float("-inf"))
    return torch.softmax(scores, dim=-1)


class AttentionOutput(nn.Module):
    """d -> 2d -> d feed-forward + residual LayerNorm."""

    def __init__(self, d_model):
        super().__init__()
        self.expand = nn.Linear(d_model, d_model * 2)
        self.squeeze = nn.Linear(d_model * 2, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-6)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # the squeeze kernel starts at zero: the residual branch is a no-op
        # at init, as in the JAX package
        init.dense_(self.expand, generator)
        init.dense_(self.squeeze, generator, zero_kernel=True)
        init.norm_(self.norm)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


class MultiHeadAttention(nn.Module):
    """Vanilla scaled dot-product MHA."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for proj in (self.proj_q, self.proj_k, self.proj_v):
            init.dense_(proj, generator)

    def forward(self, q_in, k_in, v_in, key_valid=None):
        h = self.num_heads
        q = self.proj_q(q_in).unflatten(-1, (h, -1))
        k = self.proj_k(k_in).unflatten(-1, (h, -1))
        v = self.proj_v(v_in).unflatten(-1, (h, -1))
        scores = torch.einsum("...nhc,...mhc->...hnm", q, k) / np.sqrt(q.shape[-1])
        attn = _masked_softmax(scores, key_valid)
        out = torch.einsum("...hnm,...mhc->...nhc", attn, v)
        return out.flatten(-2)


class RPEMultiHeadAttention(nn.Module):
    """MHA with pairwise relative positional embeddings added to the logits;
    the embedding projection is applied to q (<q, Wp e + bp> =
    <Wp^T q, e> + <q, bp>), as in the JAX package."""

    def __init__(self, d_model, num_heads, d_embed=None):
        super().__init__()
        self.num_heads = num_heads
        d_embed = d_embed or d_model
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        # flax layout (d_embed, d_model), kept as in the JAX parameter tree
        self.proj_p_kernel = nn.Parameter(torch.zeros(d_embed, d_model))
        self.proj_p_bias = nn.Parameter(torch.zeros(d_model))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for proj in (self.proj_q, self.proj_k, self.proj_v):
            init.dense_(proj, generator)
        init.lecun_normal_(self.proj_p_kernel, self.proj_p_kernel.shape[0], generator)
        init.constant_(self.proj_p_bias, 0.0)

    def forward(self, q_in, k_in, v_in, embed_qk, key_valid=None):
        h = self.num_heads
        d_embed = embed_qk.shape[-1]
        q = self.proj_q(q_in).unflatten(-1, (h, -1))
        k = self.proj_k(k_in).unflatten(-1, (h, -1))
        v = self.proj_v(v_in).unflatten(-1, (h, -1))
        dh = q.shape[-1]
        scores_e = torch.einsum("...nhc,...mhc->...hnm", q, k)
        qp = torch.einsum("...nhc,Dhc->...nhD", q, self.proj_p_kernel.reshape(d_embed, h, dh))
        scores_p = torch.einsum("...nmD,...nhD->...hnm", embed_qk, qp)
        qb = torch.einsum("...nhc,hc->...nh", q, self.proj_p_bias.reshape(h, dh))
        scores_p = scores_p + qb.transpose(-1, -2)[..., None]
        scores = (scores_e + scores_p) / np.sqrt(dh)
        attn = _masked_softmax(scores, key_valid)
        out = torch.einsum("...hnm,...mhc->...nhc", attn, v)
        return out.flatten(-2)


class TransformerLayer(nn.Module):
    """attention -> linear -> residual LN -> FFN."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, num_heads)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-6)
        self.output = AttentionOutput(d_model)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # zero kernel: the attention branch is a no-op at init
        self.attention.reset_parameters(generator)
        init.dense_(self.linear, generator, zero_kernel=True)
        init.norm_(self.norm)
        self.output.reset_parameters(generator)

    def forward(self, x, memory, key_valid=None):
        h = self.linear(self.attention(x, memory, memory, key_valid))
        return self.output(self.norm(x + h))


class RPETransformerLayer(nn.Module):
    def __init__(self, d_model, num_heads):
        super().__init__()
        self.attention = RPEMultiHeadAttention(d_model, num_heads)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-6)
        self.output = AttentionOutput(d_model)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # zero kernel: the attention branch is a no-op at init
        self.attention.reset_parameters(generator)
        init.dense_(self.linear, generator, zero_kernel=True)
        init.norm_(self.norm)
        self.output.reset_parameters(generator)

    def forward(self, x, memory, embed_qk, key_valid=None):
        h = self.linear(self.attention(x, memory, memory, embed_qk, key_valid))
        return self.output(self.norm(x + h))


class RPEConditionalTransformer(nn.Module):
    """Alternating self (RPE) / cross (vanilla) blocks over (ref, src)."""

    def __init__(self, blocks, d_model, num_heads):
        super().__init__()
        self.blocks = tuple(blocks)
        self.layers = nn.ModuleList(
            RPETransformerLayer(d_model, num_heads) if b == "self"
            else TransformerLayer(d_model, num_heads)
            for b in self.blocks
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, feats0, feats1, embed0, embed1, valid0=None, valid1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, embed0, valid0)
                feats1 = layer(feats1, feats1, embed1, valid1)
            else:
                feats0 = layer(feats0, feats1, valid1)
                feats1 = layer(feats1, feats0, valid0)
        return feats0, feats1
