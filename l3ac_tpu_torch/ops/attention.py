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

bf16 q / k / v, in the order of ``l3ac_tpu/ops/attention.py``'s jnp path:
q is scaled by D^-1/2 in bf16 (the scale itself rounded to bf16, as JAX's
weakly typed scalar is); the scores are accumulated in fp32 and the bias
and the mask added in fp32; the softmax is fp32; P is rounded to bf16 and
P V summed in fp32, then rounded to bf16 once.

Rotary position embeddings (the reference's path when the dynamic position
bias is off): :func:`rotary_operands` rotates q and k by window positions
before the attention, k twice (as a current-window and as a previous-window
key), and the attention reads the second as its ``kp`` operand.
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


def dynamic_position_table(params: dict, window_size: int) -> torch.Tensor:
    """DynamicPositionBias MLP over the distances 0..2n-1 -> (2n, heads).

    ``params`` holds torch-layout Linear weights ``w0`` (d, 1), ``w1`` (d, d),
    ``w2`` (heads, d) and biases ``b0``, ``b1``, ``b2``: Linear, SiLU,
    Linear, SiLU, Linear.
    """
    n = window_size
    p = {k: v.float() for k, v in params.items()}  # fp32 from bf16 weights, as JAX promotes
    rel = torch.arange(2 * n, dtype=torch.float32, device=p["w0"].device)[:, None]
    h = F.silu(F.linear(rel, p["w0"], p["b0"]))
    h = F.silu(F.linear(h, p["w1"], p["b1"]))
    return F.linear(h, p["w2"], p["b2"])


def expand_position_table(table: torch.Tensor) -> torch.Tensor:
    """(2n, heads) table -> the (heads, n, 2n) Toeplitz bias
    ``bias[h, i, j] = table[|n + i - j|, h]``."""
    n = table.shape[0] // 2
    i = torch.arange(n, device=table.device)[:, None]
    j = torch.arange(2 * n, device=table.device)[None, :]
    return table[(n + i - j).abs()].permute(2, 0, 1).contiguous()


def dynamic_position_bias(params: dict, window_size: int) -> torch.Tensor:
    """DynamicPositionBias MLP -> (heads, n, 2n) additive bias: the
    expansion of :func:`dynamic_position_table`."""
    return expand_position_table(dynamic_position_table(params, window_size))


def rotary_freqs(window_size: int, dim: int, device=None) -> torch.Tensor:
    """The sinusoidal rotary angles over the [prev | cur] key extent, (2n,
    dim) fp32 (local-attention 1.11.2's SinusoidalEmbeddings, as
    ``l3ac_tpu/ops/attention.py:rotary_freqs``): ``inv_freq = 10000^(-2i/d)``
    at window-relative positions 0..2n-1, duplicated over the head dim."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(2 * window_size, dtype=torch.float32, device=device)
    fr = t[:, None] * inv[None, :]
    return torch.cat([fr, fr], dim=-1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., P, D) rotated by ``angles`` (P, D) (half-split rotation, the
    cos and sin cast to x's dtype first, as JAX casts them)."""
    c, s = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    return x * c + _rotate_half(x) * s


def apply_rotary(q_w: torch.Tensor, k_w: torch.Tensor,
                 freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed q (..., n, d) by positions n..2n-1 and the looked-around k
    (..., 2n, d) by 0..2n-1 (``l3ac_tpu/ops/attention.py:apply_rotary``)."""
    n = q_w.shape[-2]
    return rotate(q_w, freqs[-n:]), rotate(k_w, freqs)


def rotary_operands(q: torch.Tensor, k: torch.Tensor, window_size: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rotary path's kernel operands from q, k (B, H, T, D): q and k
    rotated by their window position plus n (queries and current-window
    keys), and k rotated by its window position alone (the same keys read as
    the next window's previous-window keys, the ``kp`` operand). JAX rotates
    each key twice in the same way (``l3ac_tpu/ops/attention.py:162-165``).
    Elementwise work in q's dtype; the results are contiguous (B, H, T, D)."""
    B, H, T, D = q.shape
    n = window_size
    fr = rotary_freqs(n, D, q.device)

    def by(x, angles):
        return rotate(x.reshape(B, H, T // n, n, D), angles).reshape(B, H, T, D)

    return by(q, fr[n:]), by(k, fr[n:]), by(k, fr[:n])


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window_size: int, bias: torch.Tensor | None = None,
                    bias_table: torch.Tensor | None = None, kp: torch.Tensor | None = None,
                    prev_k: torch.Tensor | None = None, prev_v: torch.Tensor | None = None,
                    left_edge: int | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D), T a multiple of window_size; bias: (H, n, 2n),
    or its (2n, H) Toeplitz ``bias_table`` (at most one of the two), or
    neither. Returns (B, H, T, D).

    The previous-window operands of ``l3ac_tpu/ops/pallas/local_attention.py``:
    ``kp`` (B, H, T, D), the keys as the next window reads them as its
    previous half (default k; the rotary path's keys rotated as
    previous-window keys); ``prev_k`` / ``prev_v`` (B, H, n, D), window 0's
    previous half (under SP the left shard's last window; default zeros);
    ``left_edge``: 1 on the globally first shard. Window 0's previous half is
    masked when there is no ``prev_k`` or ``left_edge`` is 1."""
    B, H, T, D = q.shape
    n = window_size
    if T % n:
        raise ValueError(f"T = {T} is not a multiple of the window {n}")
    if (prev_k is None) != (prev_v is None):
        raise ValueError("local_attention: prev_k and prev_v go together")
    for name, t, shape in (("kp", kp, (B, H, T, D)), ("prev_k", prev_k, (B, H, n, D)),
                           ("prev_v", prev_v, (B, H, n, D))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"local_attention: {name} {tuple(t.shape)} is not {shape}")
    mask_first = prev_k is None or bool(left_edge)
    if bias_table is not None:
        if bias is not None:
            raise ValueError("local_attention: pass bias or bias_table, not both")
        if bias_table.shape != (2 * n, H):
            raise ValueError(f"local_attention: bias_table {tuple(bias_table.shape)} "
                             f"is not {(2 * n, H)}")
        bias = expand_position_table(bias_table)
    W = T // n
    scale = D ** -0.5
    low = q.dtype == torch.bfloat16
    if low:
        scale = torch.tensor(scale, dtype=q.dtype)

    bq = q.reshape(B, H, W, n, D) * scale
    bk = k.reshape(B, H, W, n, D)
    bv = v.reshape(B, H, W, n, D)
    bkp = bk if kp is None else kp.reshape(B, H, W, n, D)
    p0k = torch.zeros_like(bk[:, :, :1]) if prev_k is None else prev_k[:, :, None].to(k.dtype)
    p0v = torch.zeros_like(bv[:, :, :1]) if prev_v is None else prev_v[:, :, None].to(v.dtype)
    pk = torch.cat([p0k, bkp[:, :, :-1]], dim=2)
    pv = torch.cat([p0v, bv[:, :, :-1]], dim=2)
    kk = torch.cat([pk, bk], dim=3)                           # (B, H, W, 2n, D)
    vv = torch.cat([pv, bv], dim=3)

    if low:
        bq, kk = bq.float(), kk.float()  # bf16 products are exact in fp32: fp32 sums
    sim = torch.einsum("bhwid,bhwjd->bhwij", bq, kk)
    if bias is not None:
        sim = sim + bias[None, :, None].to(sim.dtype)
    mask = local_attention_mask(n, q.device)[None, None, None]
    first = ((torch.arange(W, device=q.device)[:, None, None] == 0)
             & (torch.arange(2 * n, device=q.device)[None, None, :] < n))
    if mask_first:
        mask = mask & ~first[None, None]
    sim = sim.masked_fill(~mask, NEG_INF)
    attn = sim.softmax(dim=-1)
    if low:
        out = torch.einsum("bhwij,bhwjd->bhwid", attn.to(vv.dtype).float(), vv.float())
        return out.to(vv.dtype).reshape(B, H, T, D)
    out = torch.einsum("bhwij,bhwjd->bhwid", attn.to(vv.dtype), vv)
    return out.reshape(B, H, T, D)
