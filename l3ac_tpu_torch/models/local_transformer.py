"""Local-window transformer stacks of the encode and decode paths
(``l3ac_tpu/models/local_transformer.py``).

Per layer ``x = LocalMHA(x) + x; x = FF(x) + x`` with pre-LayerNorms (eps
1e-5), a GEGLU feed-forward and one DynamicPositionBias shared by the
stack's layers. dim_head = dim // 4, heads = 6, ff inner = int(dim * 4 * 2 / 3).
The attention is the ``local_attention`` kernel (plain version on the CPU),
which reads the heads of the qkv projection in place (no head copies) and
the position bias from its (2n, heads) Toeplitz table.
The linear layers are called as modules, so that an ``Int8Linear`` that
``ops.quantized.quantize_params`` put in their place runs the ``int8_matmul``
kernel.

All released configs use the dynamic position bias. Without it
(``dynamic_pos = false``) the stack has no position MLP, as JAX's params do,
and takes the reference's rotary position embeddings: q and k rotated by
window positions in plain PyTorch (``ops.attention.rotary_operands``; k
twice, as a current-window and as a previous-window key), then the kernel
with the second as its ``kp`` operand.

Sequence parallelism (``parallel.sp``): each shard's first window reads the
left shard's last K / V window as the kernel's ``prev_k`` / ``prev_v``, the
globally first shard masks it (``left_edge``), and a shard's length must be
a window multiple (JAX asserts both). Rotary under SP raises, as JAX asserts.

Tensor parallelism (``parallel.tp``): an Attention that
``parallel.tp.shard_codec`` split (``tp_shard``: (rank, size), where
heads % size == 0) holds its heads' rows of q, k and v and their columns of
the out-projection, runs the kernel on its heads with their columns of the
stack's position table (the kernel's ``head_offset`` mode), and sums the
out-projection's shares over the tp group; a split FeedForward
(ff_inner % size == 0) holds the same rows of both GEGLU halves of ``w1`` and
their columns of ``w2``. The normalized input and the table enter through
``copy_to_tp``; the second product of a split pair is an fp32 share (its
bf16 operands are exact in fp32), the shares are summed in fp32 and rounded
to the model dtype once, where the single-device product rounds.

Activations are channels-last (B, T, C). In a bf16 model the linears are
bf16 ``torch.matmul`` products, as in the JAX package, the norms follow
``ops.norms``' bf16 rule, and the position-bias table is in bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv1d_strided_matmul, geglu, layer_norm, upsample_linear
from ..ops.attention import dynamic_position_table, rotary_operands
from ..ops.kernels.local_attention import local_attention
from ..ops.norms import LAYER_NORM_EPS
from ..parallel import sp, tp
from ..utils import init as pinit
from .layers import ChannelNorm

HEADS = 6
FF_MULT = 4


@dataclasses.dataclass(frozen=True)
class TransConfig:
    dim: int
    depth: int
    window_size: int
    heads: int = HEADS
    dynamic_pos: bool = True

    @property
    def dim_head(self) -> int:
        return self.dim // 4

    @property
    def inner_dim(self) -> int:
        return self.dim_head * self.heads

    @property
    def ff_inner(self) -> int:
        return int(self.dim * FF_MULT * 2 / 3)


class DynamicPositionBias(nn.Module):
    """MLP 1 -> d -> d -> heads over |relative distance|, d = dim // 2;
    torch-layout weights ``w0`` (d, 1), ``w1`` (d, d), ``w2`` (heads, d)."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        d = dim // 2
        self.w0 = nn.Parameter(torch.empty(d, 1, device=device))
        self.b0 = nn.Parameter(torch.empty(d, device=device))
        self.w1 = nn.Parameter(torch.empty(d, d, device=device))
        self.b1 = nn.Parameter(torch.empty(d, device=device))
        self.w2 = nn.Parameter(torch.empty(heads, d, device=device))
        self.b2 = nn.Parameter(torch.empty(heads, device=device))

    def init_weights(self, gen: torch.Generator) -> None:
        for w, b in ((self.w0, self.b0), (self.w1, self.b1), (self.w2, self.b2)):
            pinit.torch_default_(w, b, gen, w.shape[1])

    def forward(self, window_size: int) -> torch.Tensor:
        """-> the (2n, heads) table of the additive bias, bias[h, i, j] =
        table[|n + i - j|, h] (``ops.attention.expand_position_table``),
        computed in fp32 and stored in the model dtype."""
        return dynamic_position_table(dict(self.named_parameters()),
                                      window_size).to(self.w0.dtype)


class Attention(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.tc = tc
        self.norm = ChannelNorm(tc.dim, LAYER_NORM_EPS, device=device)
        self.qkv = nn.Linear(tc.dim, 3 * tc.inner_dim, bias=False, device=device)
        self.out = nn.Linear(tc.inner_dim, tc.dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, bias_table: torch.Tensor | None) -> torch.Tensor:
        """Pre-norm local MHA; x: (B, T, C), T a window multiple; bias_table
        (2n, heads). The heads are views of the projection, and the kernel's
        (B, T, heads, dim_head) output merges them as a view."""
        B, T, _ = x.shape
        tc = self.tc
        shard = getattr(self, "tp_shard", None)
        h = layer_norm(x, self.norm.weight, self.norm.bias)
        n_heads, tp_extra = tc.heads, {}
        if shard is not None:
            tp.context("Attention", shard)
            n_heads = tc.heads // shard[1]
            h, bias_table = tp.copy_to_tp(h), tp.copy_to_tp(bias_table)
            tp_extra = {"head_offset": shard[0] * n_heads}
        q, k, v = self.qkv(h).chunk(3, dim=-1)

        def heads(t):
            return t.view(B, T, n_heads, tc.dim_head).permute(0, 2, 1, 3)

        n = tc.window_size
        qh, kh, vh = heads(q), heads(k), heads(v)
        extra = {}
        if not tc.dynamic_pos:
            if sp.active():
                raise NotImplementedError("rotary position embeddings are not supported "
                                          "under sequence parallelism (as in JAX)")
            qh, kh, extra["kp"] = rotary_operands(qh, kh, n)
        elif sp.active():
            # the left shard's last K / V window, one exchange for both
            (pk, _), (pv, _) = sp.halo_blocks_many([kh, vh], n, 0, axis=2)
            extra = {"prev_k": pk, "prev_v": pv, "left_edge": sp.edge_flags()[0]}
        out = local_attention(qh, kh, vh, window_size=n, bias_table=bias_table, **extra,
                              **tp_extra)
        out = out.permute(0, 2, 1, 3).reshape(B, T, n_heads * tc.dim_head)
        return self.out(out) if shard is None else _sum_shares(self.out, out, x.dtype)


class FeedForward(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.norm = ChannelNorm(tc.dim, LAYER_NORM_EPS, device=device)
        self.w1 = nn.Linear(tc.dim, 2 * tc.ff_inner, bias=False, device=device)
        self.w2 = nn.Linear(tc.ff_inner, tc.dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = getattr(self, "tp_shard", None)
        h = layer_norm(x, self.norm.weight, self.norm.bias)
        if shard is None:
            return self.w2(geglu(self.w1(h)))
        tp.context("FeedForward", shard)
        return _sum_shares(self.w2, geglu(self.w1(tp.copy_to_tp(h))), x.dtype)


def _sum_shares(lin: nn.Linear, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A split pair's second product (no bias) as an fp32 share (a bf16
    model's operands are exact in fp32, so the share is its products' fp32
    sum, unrounded), summed over the tp group and rounded once to ``dtype``:
    the single-device bf16 product's rounding point."""
    return tp.reduce_from_tp(F.linear(h.float(), lin.weight.float())).to(dtype)


class Layer(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.attn = Attention(tc, device=device)
        self.ff = FeedForward(tc, device=device)


class LocalTrans(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.tc = tc
        self.dyn_bias = (DynamicPositionBias(tc.dim, tc.heads, device=device)
                         if tc.dynamic_pos else None)
        self.layers = nn.ModuleList(Layer(tc, device=device) for _ in range(tc.depth))
        self.register_buffer("bias_cache", None, persistent=False)

    def init_weights(self, gen: torch.Generator) -> None:
        if self.dyn_bias is not None:
            self.dyn_bias.init_weights(gen)
        for layer in self.layers:
            for lin in (layer.attn.qkv, layer.attn.out, layer.ff.w1, layer.ff.w2):
                pinit.torch_linear_(lin, gen)

    @torch.no_grad()
    def attach_bias_cache(self) -> None:
        """Precompute the (2n, heads) position-bias table from the current MLP
        weights. Recomputed on every call, so a cache never outlives the
        weights it came from. A rotary stack has no bias."""
        if self.dyn_bias is not None:
            self.bias_cache = self.dyn_bias(self.tc.window_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) -> (B, T, C). Right-pads T to a window multiple and
        crops back, which the causal mask makes exact."""
        T = x.shape[1]
        pad = (-T) % self.tc.window_size
        if pad:
            if sp.active():
                raise ValueError(
                    "under sequence parallelism the per-shard length must be a window "
                    f"multiple (got T={T}, window={self.tc.window_size}) so the global "
                    "window grid stays aligned across shards")
            x = F.pad(x, (0, 0, 0, pad))
        table = self.bias_cache
        if table is None and self.dyn_bias is not None:
            table = self.dyn_bias(self.tc.window_size)
        for layer in self.layers:
            x = layer.attn(x, table) + x
            x = layer.ff(x) + x
        return x[:, :T] if pad else x


class UpTransV1(nn.Module):
    """The token upsampler UpTransV1 (``l3ac_tpu/models/local_transformer.py:
    init_up_trans_v1`` / ``up_trans_v1_apply``; reference
    ``l3ac/local_trans.py:97-111``): ``rate - 1`` learned tokens interleaved
    after every input token, ``stack([x, tok_1, ..., tok_{rate-1}], dim=2)
    .reshape(B, T * rate, C)``, then a :class:`LocalTrans` whose
    ``window_size`` is the post-interleave window. No released config
    selects it (they all take UpTransV2's linear upsample, as the JAX package
    does); it is part of the component surface. On the card its stack runs
    the ``local_attention`` kernel at that window, once per layer; the
    interleave is a torch op, as it is jnp in JAX."""

    def __init__(self, tc: TransConfig, rate: int, device=None):
        super().__init__()
        if rate < 1 or tc.window_size % rate:
            raise ValueError(f"UpTransV1: the window {tc.window_size} is not a multiple of the "
                             f"rate {rate} (JAX asserts it)")
        self.rate = rate
        self.tokens = nn.Parameter(torch.empty(rate - 1, tc.dim, device=device))
        self.trans = LocalTrans(tc, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        pinit.normal_(self.tokens, gen)  # torch.randn(1, 1, C) per learned token
        self.trans.init_weights(gen)

    def attach_bias_cache(self) -> None:
        self.trans.attach_bias_cache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) -> (B, T * rate, C)."""
        B, T, C = x.shape
        cols = [x] + [self.tokens[i].to(x.dtype).expand(B, T, C) for i in range(self.rate - 1)]
        return self.trans(torch.stack(cols, dim=2).reshape(B, T * self.rate, C))


def plain_encoder_config(mc) -> TransConfig:
    # reference: LocalEncoder(depth=1)
    return TransConfig(dim=mc.feature_dim, depth=1,
                       window_size=mc.en_coder_window_size,
                       dynamic_pos=mc.en_coder_dynamic_pos)


def plain_decoder_config(mc) -> TransConfig:
    # reference: LocalDecoder(depth=en_coder_depth)
    return TransConfig(dim=mc.feature_dim, depth=mc.en_coder_depth,
                       window_size=mc.en_coder_window_size,
                       dynamic_pos=mc.en_coder_dynamic_pos)


def compressed_encoder_configs(mc) -> dict:
    """DownTrans(window = (win + cache) * rate, depth 1), then
    LocalTrans(window = win + cache, depth 2)."""
    depth = 3
    first = depth // 2
    win = mc.en_coder_window_size + mc.en_coder_cache_size
    rate = mc.en_coder_compress_rate
    return {
        "down": TransConfig(dim=mc.feature_dim, depth=first, window_size=win * rate,
                            dynamic_pos=mc.en_coder_dynamic_pos),
        "post": TransConfig(dim=mc.feature_dim, depth=depth - first,
                            window_size=win, dynamic_pos=mc.en_coder_dynamic_pos),
    }


class CompressedEncoder(nn.Module):
    """down_trans -> strided conv (k = s = compress rate) -> post_trans."""

    def __init__(self, mc, device=None):
        super().__init__()
        cfgs = compressed_encoder_configs(mc)
        rate = mc.en_coder_compress_rate
        self.down_trans = LocalTrans(cfgs["down"], device=device)
        self.down_conv = nn.Conv1d(mc.feature_dim, mc.feature_dim, rate,
                                   stride=rate, device=device)
        self.post_trans = LocalTrans(cfgs["post"], device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.down_trans.init_weights(gen)
        pinit.weight_norm_layer_(self.down_conv, gen)
        self.post_trans.init_weights(gen)

    def attach_bias_cache(self) -> None:
        self.down_trans.attach_bias_cache()
        self.post_trans.attach_bias_cache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down_trans(x)
        x = conv1d_strided_matmul(x, self.down_conv.weight, self.down_conv.bias,
                                  channels_last=True)
        return self.post_trans(x)


def compressed_decoder_configs(mc) -> dict:
    """LocalTrans(window = win + cache, depth = en_coder_depth - 2), then
    UpTransV2 = linear upsample x rate -> LocalTrans(window = (win + cache) *
    rate, depth 2)."""
    win = mc.en_coder_window_size + mc.en_coder_cache_size
    rate = mc.en_coder_compress_rate
    return {
        "pre": TransConfig(dim=mc.feature_dim, depth=mc.en_coder_depth - 2,
                           window_size=win, dynamic_pos=mc.en_coder_dynamic_pos),
        "up": TransConfig(dim=mc.feature_dim, depth=2, window_size=win * rate,
                          dynamic_pos=mc.en_coder_dynamic_pos),
    }


class CompressedDecoder(nn.Module):
    """pre_trans -> linear upsample x compress rate -> up_trans."""

    def __init__(self, mc, device=None):
        super().__init__()
        cfgs = compressed_decoder_configs(mc)
        self.rate = mc.en_coder_compress_rate
        self.pre_trans = LocalTrans(cfgs["pre"], device=device)
        self.up_trans = LocalTrans(cfgs["up"], device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.pre_trans.init_weights(gen)
        self.up_trans.init_weights(gen)

    def attach_bias_cache(self) -> None:
        self.pre_trans.attach_bias_cache()
        self.up_trans.attach_bias_cache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_trans(x)
        return self.up_trans(upsample_linear(x, self.rate, dim=1))
