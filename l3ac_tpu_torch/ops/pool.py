"""Trend pooling: ``avg_pool(max_pool(|x|, k, stride 1), k, stride 1)``.

torch's padding semantics, as in ``l3ac_tpu/ops/pool.py``: max pooling pads
with -inf; average pooling pads with 0 and always divides by k. Each pool is
k shifted slices reduced in order, the same summation order as the JAX
package and as the ``first_block`` kernel.
"""

import torch
import torch.nn.functional as F


def _pool(x: torch.Tensor, k: int, op, pad_value: float) -> torch.Tensor:
    p = k // 2
    T = x.shape[-1]
    xp = F.pad(x, (p, p), value=pad_value)
    out = xp[..., :T]
    for j in range(1, k):
        out = op(out, xp[..., j:j + T])
    return out


def trend_pool(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Pool over the last (time) axis. Identity when kernel_size <= 1."""
    if kernel_size <= 1:
        return x
    k = kernel_size
    m = _pool(x.abs(), k, torch.maximum, float("-inf"))
    s = _pool(m, k, torch.add, 0.0)
    return s / k
