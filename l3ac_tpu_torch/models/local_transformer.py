"""Local-window transformer stacks of the encode path
(``l3ac_tpu/models/local_transformer.py``).

Per layer ``x = LocalMHA(x) + x; x = FF(x) + x`` with pre-LayerNorms (eps
1e-5), a GEGLU feed-forward and one DynamicPositionBias shared by the
stack's layers. dim_head = dim // 4, heads = 6, ff inner = int(dim * 4 * 2 / 3).
The attention is the ``local_attention`` kernel (plain version on the CPU).

All released configs use the dynamic position bias; the rotary path the
reference takes without it is not ported yet.

Activations are channels-last (B, T, C).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv1d_strided_matmul, geglu, layer_norm, linear
from ..ops.attention import dynamic_position_bias
from ..ops.kernels.local_attention import local_attention
from ..ops.norms import LAYER_NORM_EPS
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
        """-> (heads, n, 2n) additive bias."""
        return dynamic_position_bias(dict(self.named_parameters()), window_size)


class Attention(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.tc = tc
        self.norm = ChannelNorm(tc.dim, LAYER_NORM_EPS, device=device)
        self.qkv = nn.Linear(tc.dim, 3 * tc.inner_dim, bias=False, device=device)
        self.out = nn.Linear(tc.inner_dim, tc.dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """Pre-norm local MHA; x: (B, T, C), T a window multiple."""
        B, T, _ = x.shape
        tc = self.tc
        h = layer_norm(x, self.norm.weight, self.norm.bias)
        q, k, v = linear(h, self.qkv.weight).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(B, T, tc.heads, tc.dim_head).permute(0, 2, 1, 3).contiguous()

        out = local_attention(heads(q), heads(k), heads(v),
                              window_size=tc.window_size, bias=bias)
        out = out.permute(0, 2, 1, 3).reshape(B, T, tc.inner_dim)
        return linear(out, self.out.weight)


class FeedForward(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.norm = ChannelNorm(tc.dim, LAYER_NORM_EPS, device=device)
        self.w1 = nn.Linear(tc.dim, 2 * tc.ff_inner, bias=False, device=device)
        self.w2 = nn.Linear(tc.ff_inner, tc.dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.norm.weight, self.norm.bias)
        return linear(geglu(linear(h, self.w1.weight)), self.w2.weight)


class Layer(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        self.attn = Attention(tc, device=device)
        self.ff = FeedForward(tc, device=device)


class LocalTrans(nn.Module):
    def __init__(self, tc: TransConfig, device=None):
        super().__init__()
        if not tc.dynamic_pos:
            raise NotImplementedError("rotary position embeddings (dynamic_pos "
                                      "= false) are not ported yet")
        self.tc = tc
        self.dyn_bias = DynamicPositionBias(tc.dim, tc.heads, device=device)
        self.layers = nn.ModuleList(Layer(tc, device=device) for _ in range(tc.depth))
        self.register_buffer("bias_cache", None, persistent=False)

    def init_weights(self, gen: torch.Generator) -> None:
        self.dyn_bias.init_weights(gen)
        for layer in self.layers:
            for lin in (layer.attn.qkv, layer.attn.out, layer.ff.w1, layer.ff.w2):
                pinit.torch_linear_(lin, gen)

    @torch.no_grad()
    def attach_bias_cache(self) -> None:
        """Precompute the (heads, n, 2n) position bias from the current MLP
        weights. Recomputed on every call, so a cache never outlives the
        weights it came from."""
        self.bias_cache = self.dyn_bias(self.tc.window_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) -> (B, T, C). Right-pads T to a window multiple and
        crops back, which the causal mask makes exact."""
        T = x.shape[1]
        pad = (-T) % self.tc.window_size
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        bias = self.bias_cache
        if bias is None:
            bias = self.dyn_bias(self.tc.window_size)
        for layer in self.layers:
            x = layer.attn(x, bias) + x
            x = layer.ff(x) + x
        return x[:, :T] if pad else x


def plain_encoder_config(mc) -> TransConfig:
    # reference: LocalEncoder(depth=1)
    return TransConfig(dim=mc.feature_dim, depth=1,
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
