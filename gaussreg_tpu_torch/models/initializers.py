"""The parameter initialisers that the JAX package's flax modules use, drawn
from a torch.Generator, so that a model trained from scratch starts from
the same distributions:

- `lecun_normal_`: flax's `lecun_normal`, variance_scaling(1, fan_in,
  truncated_normal): a normal truncated at two standard deviations, its
  scale raised by 1 / 0.87962566103423978 so that the variance is
  1 / fan_in;
- `variance_scaling_uniform_`: variance_scaling(scale, fan_in, uniform),
  uniform in +-sqrt(3 * scale / fan_in);
- `dense_`: an nn.Linear as flax's nn.Dense draws it (kernel lecun_normal
  or zeros, bias zeros). The torch weight is the flax kernel transposed,
  so its fan-in is the weight's last axis.

The draws run on the CPU and are copied to the parameter's device, so a
model on the card starts where the same model on the CPU starts.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax/jax: stddev of the standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def fill_(param: torch.Tensor, values: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(values.to(param.device, param.dtype))


def lecun_normal_(param: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    values = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(values, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    fill_(param, values)


def variance_scaling_uniform_(param: torch.Tensor, scale: float, fan_in: int,
                              generator: torch.Generator) -> None:
    limit = math.sqrt(3.0 * scale / fan_in)
    values = torch.empty(param.shape, dtype=torch.float32)
    nn.init.uniform_(values, -limit, limit, generator=generator)
    fill_(param, values)


def constant_(param: torch.Tensor, value: float) -> None:
    with torch.no_grad():
        param.fill_(value)


def dense_(linear: nn.Linear, generator: torch.Generator, zero_kernel: bool = False) -> None:
    """flax nn.Dense: kernel lecun_normal (or zeros), bias zeros."""
    if zero_kernel:
        constant_(linear.weight, 0.0)
    else:
        lecun_normal_(linear.weight, linear.weight.shape[1], generator)
    constant_(linear.bias, 0.0)


def norm_(norm: nn.Module) -> None:
    """flax GroupNorm / LayerNorm: scale ones, bias zeros."""
    constant_(norm.weight, 1.0)
    constant_(norm.bias, 0.0)
