"""Causal block-local windowed attention, plain PyTorch.

The semantics of ``l3ac_tpu/ops/attention.py`` (the pinned
``local-attention==1.11.2`` call site of the reference: causal,
look_backward=1, look_forward=0, exact_windowsize=False, scale
``dim_head ** -0.5``). The sequence, padded to a window multiple by the
caller, is cut into windows of n; each query window attends to its own
window and the previous one (2n keys) under a causal mask on absolute
positions. Window 0's previous block is zeros whose logits are masked.

Masked logits are set to ``NEG_INF = finfo(float32).min``, not -inf, as in
the JAX package.
"""

import torch
import torch.nn.functional as F

NEG_INF = float(torch.finfo(torch.float32).min)


def local_attention_mask(window_size: int, device=None) -> torch.Tensor:
    """(n, 2n) bool, True where query i may attend to key j of [prev | cur]:
    ``j <= n + i``."""
    n = window_size
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(2 * n, device=device)[None, :]
    return j <= (i + n)


def dynamic_position_bias(params: dict, window_size: int) -> torch.Tensor:
    """DynamicPositionBias MLP -> (heads, n, 2n) additive bias.

    ``params`` holds torch-layout Linear weights ``w0`` (d, 1), ``w1`` (d, d),
    ``w2`` (heads, d) and biases ``b0``, ``b1``, ``b2``. The MLP (Linear,
    SiLU, Linear, SiLU, Linear) runs over the distances 0..2n-1 into a
    (2n, heads) table; the bias is Toeplitz,
    ``bias[h, i, j] = table[|n + i - j|, h]``.
    """
    n = window_size
    w0 = params["w0"]
    rel = torch.arange(2 * n, dtype=torch.float32, device=w0.device)[:, None]
    h = F.silu(F.linear(rel, w0, params["b0"]))
    h = F.silu(F.linear(h, params["w1"], params["b1"]))
    table = F.linear(h, params["w2"], params["b2"])          # (2n, heads)
    i = torch.arange(n, device=w0.device)[:, None]
    j = torch.arange(2 * n, device=w0.device)[None, :]
    return table[(n + i - j).abs()].permute(2, 0, 1).contiguous()


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window_size: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D), T a multiple of window_size; bias: (H, n, 2n)
    or None. Returns (B, H, T, D)."""
    B, H, T, D = q.shape
    n = window_size
    if T % n:
        raise ValueError(f"T = {T} is not a multiple of the window {n}")
    W = T // n
    scale = D ** -0.5

    bq = q.reshape(B, H, W, n, D) * scale
    bk = k.reshape(B, H, W, n, D)
    bv = v.reshape(B, H, W, n, D)
    prev_k = torch.cat([torch.zeros_like(bk[:, :, :1]), bk[:, :, :-1]], dim=2)
    prev_v = torch.cat([torch.zeros_like(bv[:, :, :1]), bv[:, :, :-1]], dim=2)
    kk = torch.cat([prev_k, bk], dim=3)                       # (B, H, W, 2n, D)
    vv = torch.cat([prev_v, bv], dim=3)

    sim = torch.einsum("bhwid,bhwjd->bhwij", bq, kk)
    if bias is not None:
        sim = sim + bias[None, :, None].to(sim.dtype)
    mask = local_attention_mask(n, q.device)[None, None, None]
    first = ((torch.arange(W, device=q.device)[:, None, None] == 0)
             & (torch.arange(2 * n, device=q.device)[None, None, :] < n))
    mask = mask & ~first[None, None]
    sim = sim.masked_fill(~mask, NEG_INF)
    attn = sim.softmax(dim=-1)
    out = torch.einsum("bhwij,bhwjd->bhwid", attn.to(vv.dtype), vv)
    return out.reshape(B, H, T, D)
