"""Block-local causal attention: each window of n queries attends to the
[previous | current] windows' 2n keys.

Replaces ``l3ac_tpu/ops/pallas/local_attention.py:local_attention`` (body
``_attn_kernel``) with ``csrc/local_attention.cu``. Same signature as the JAX
wrapper: ``(q, k, v, window_size, bias)`` with q, k, v of shape (B, H, T, D)
and bias (H, n, 2n) or None.

The TPU wrapper folds the causal mask and window 0's missing previous block
into two stored additive planes, ``bias + mask``, indexed by min(w, 1). This
kernel adds the same bias and applies the same two masks from the indices
(key j of [prev | cur] is valid iff j <= n + i, and j >= n in window 0), so
it reads no mask planes. A masked key gets weight 0, as NEG_INF does in the
plain version.

Bound on the H100: per valid (query, key) pair 4 D fp32 operations against
the bias element it reads, so at D = 32 (every released config) the fp32 rate
bounds it. The kernel takes any head dim up to 32. Design: one
block per (batch * head, window, 64-query tile), 8 warps of 8 query rows.
Keys and values stream through shared memory 64 at a time, only as far as the
causal mask reaches for the tile's last row; each row keeps an online softmax
in fp32 (max, sum and its 32-wide output, one element per lane), so the
(n, 2n) score matrix never reaches device memory. Products are SIMT fp32
FMAs; no SDPA and no cuDNN.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from ..attention import local_attention as local_attention_plain
from . import _build

MAX_HEAD_DIM = 32  # one lane per output element


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window_size: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D), T a multiple of window_size; bias (H, n, 2n) or
    None. Returns (B, H, T, D). Kernel on CUDA, plain on CPU."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.check_input(t, f"local_attention {name}", ndim=4)
    if not K.route(q, "local_attention"):
        return local_attention_plain(q, k, v, window_size=window_size, bias=bias)
    B, H, T, D = q.shape
    n = window_size
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("local_attention: q, k, v shapes differ")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"local_attention: the kernel takes D <= {MAX_HEAD_DIM}, got {D}")
    if n < 1 or T % n:
        raise ValueError(f"local_attention: T = {T} is not a multiple of n = {n}")
    if bias is not None and bias.shape != (H, n, 2 * n):
        raise ValueError(f"local_attention: bias {tuple(bias.shape)} is not "
                         f"{(H, n, 2 * n)}")
    K.check_cuda({"q": q, "k": k, "v": v, "bias": bias}, q.device)
    out = torch.empty_like(q)
    fn = _build.function("l3ac_local_attention", [ctypes.c_void_p] * 5 +
                         [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(bias),
             out.data_ptr(), B * H, H, T, n, D, D ** -0.5, _build.stream_ptr())
    _build.check(err, "local_attention")
    K.LAUNCHES["local_attention"] += 1
    return out
