"""Normalizations over a chosen channel axis, the math of ``l3ac_tpu/ops/norms.py``.

- channel_norm: eps inside the sqrt, eps = 1e-8.
- layer_norm: the same with torch's LayerNorm eps, 1e-5.
- grn: Global Response Norm with the reference's per-batch scalar norm,
  ``g = ||x||_2`` over all of (C, T) for each batch element, so
  ``n = g / (g + eps)``. Kept as it is; do not make it per-channel.

``dim`` names the channel axis: -1 for (B, T, C), 1 for (B, C, T). fp32 only.
"""

import torch

EPS = 1e-8
LAYER_NORM_EPS = 1e-5


def _along(v: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reshape a (C,) vector to broadcast along axis ``dim`` of x."""
    shape = [1] * x.dim()
    shape[dim] = -1
    return v.reshape(shape)


def channel_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = EPS, dim: int = -1) -> torch.Tensor:
    u = x.mean(dim=dim, keepdim=True)
    s = ((x - u) ** 2).mean(dim=dim, keepdim=True)
    xn = (x - u) / torch.sqrt(s + eps)
    return _along(weight, x, dim) * xn + _along(bias, x, dim)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LAYER_NORM_EPS) -> torch.Tensor:
    return channel_norm(x, weight, bias, eps=eps, dim=-1)


def grn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        eps: float = EPS, dim: int = -1) -> torch.Tensor:
    g = torch.sqrt((x * x).sum(dim=tuple(range(1, x.dim())), keepdim=True))
    n = g / (g + eps)
    return _along(gamma, x, dim) * (x * n) + _along(beta, x, dim) + x
