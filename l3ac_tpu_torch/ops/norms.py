"""Normalizations over a chosen channel axis, the math of ``l3ac_tpu/ops/norms.py``.

- channel_norm: eps inside the sqrt, eps = 1e-8.
- layer_norm: the same with torch's LayerNorm eps, 1e-5.
- grn: Global Response Norm with the reference's per-batch scalar norm,
  ``g = ||x||_2`` over all of (C, T) for each batch element, so
  ``n = g / (g + eps)``. Kept as it is; do not make it per-channel.
- instance_norm: per (batch, channel) over time, eps = 1e-5 inside the sqrt,
  ``torch.nn.InstanceNorm1d(affine=True)`` as the EnhanceBlock uses it
  (``l3ac_tpu/ops/norms.py:instance_norm``, ``transposed.py:instance_norm_t``).

``dim`` names the channel axis: -1 for (B, T, C), 1 for (B, C, T).

bf16 input (``l3ac_tpu/ops/norms.py:_stat_dtype``): the moments and the
normalization run in fp32, the normalized value is cast back to the input
dtype, and the affine step runs in that dtype; GRN's scalar ``n`` likewise.
fp32 input takes exactly the fp32 steps.

Under sequence parallelism (``parallel.sp``) GRN's norm and the instance
norm's moments are summed over the sp group, the instance norm's in JAX's
one-pass form. GRN of a tensor-parallel shard of the hidden axis
(``hidden_split``, ``parallel.tp``) sums its norm over the tp group too. Both
sums are differentiable (``parallel.comm.psum``).
"""

import torch

from ..parallel import sp, tp

EPS = 1e-8
LAYER_NORM_EPS = 1e-5
INSTANCE_NORM_EPS = 1e-5


def _along(v: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reshape a (C,) vector to broadcast along axis ``dim`` of x."""
    shape = [1] * x.dim()
    shape[dim] = -1
    return v.reshape(shape)


def _stat(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype its moments are computed in: fp32 for narrower floats."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def channel_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = EPS, dim: int = -1) -> torch.Tensor:
    xs = _stat(x)
    u = xs.mean(dim=dim, keepdim=True)
    s = ((xs - u) ** 2).mean(dim=dim, keepdim=True)
    xn = ((xs - u) / torch.sqrt(s + eps)).to(x.dtype)
    return _along(weight, x, dim) * xn + _along(bias, x, dim)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LAYER_NORM_EPS) -> torch.Tensor:
    return channel_norm(x, weight, bias, eps=eps, dim=-1)


def grn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        eps: float = EPS, dim: int = -1, hidden_split: bool = False) -> torch.Tensor:
    """``hidden_split``: x is this rank's tensor-parallel shard of the hidden
    axis, and the norm is taken over the whole axis."""
    xs = _stat(x)
    s = (xs * xs).sum(dim=tuple(range(1, x.dim())), keepdim=True)
    if hidden_split:
        s = tp.psum_if_active(s)
    g = torch.sqrt(sp.psum_if_active(s))
    n = (g / (g + eps)).to(x.dtype)
    return _along(gamma, x, dim) * (x * n) + _along(beta, x, dim) + x


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = INSTANCE_NORM_EPS, dim: int = -1) -> torch.Tensor:
    """Normalize over time: the axis of (B, ., .) that is not the channel
    axis ``dim``."""
    t_dim = 1 if dim in (-1, 2) else 2
    xs = _stat(x)
    if sp.active():
        # the moments over the global time axis, in one pass (JAX's formula);
        # cancellation can take the variance below 0, clamped
        n = x.shape[t_dim] * sp.size()
        u = sp.psum_if_active(xs.sum(dim=t_dim, keepdim=True)) / n
        s2 = sp.psum_if_active((xs * xs).sum(dim=t_dim, keepdim=True)) / n
        s = torch.clamp(s2 - u * u, min=0.0)
    else:
        u = xs.mean(dim=t_dim, keepdim=True)
        s = ((xs - u) ** 2).mean(dim=t_dim, keepdim=True)
    xn = ((xs - u) / torch.sqrt(s + eps)).to(x.dtype)
    return _along(weight, x, dim) * xn + _along(bias, x, dim)
