"""Elementwise activations, the same formulas as ``l3ac_tpu/ops/activations.py``.

- snake: ``x + sin(alpha * x)^2 / (alpha + eps)``
- gelu: the exact (erf) form, ``torch.nn.GELU()``'s default
- geglu: split the last axis in half, ``a * gelu(b)``
"""

import torch
import torch.nn.functional as F

EPS = 1e-8


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake with per-channel ``alpha``, already shaped to broadcast over x."""
    return x + torch.sin(alpha * x) ** 2 / (alpha + EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def geglu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * gelu(b)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
