"""Conv encoder: audio (B, T) -> features (B, T / conv_hop, feature_dim)
(``l3ac_tpu/models/encoder.py:54-119``).

FirstBlock stem, then per stage ``depth`` residual ConvUnits, a strided
downsampling conv (kernel == stride, a reshape + matmul) and an optional
ChannelNorm; then the final ConvUnits and a k3 projection to feature_dim.
Not causal: symmetric padding throughout.

Layout: the stem emits (B, C, T), torch's native conv layout, and stages
whose input width is at most ``NARROW_MAX_C`` stay there (the ``conv_unit_ct``
kernel); wider stages and the last units run on (B, T, C) (the ``conv_unit``
kernel), the same switching as the JAX encoder.

Sequence parallelism (``parallel.sp``): the stem takes 47-sample halos and
the shard flags as operands; the units, the k3 projection and the norms
exchange their own halos or sums; the strided convs need none (each shard
holds whole hops).

Training: a ``(drop_path_rate, generator)`` gives every ConvUnit stochastic
depth on an ascending linspace ramp over ``sum(encoder_depths)`` units
(``l3ac_tpu/models/encoder.py:55-70``).
"""

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv1d, conv1d_strided_matmul
from ..ops.droppath import schedule
from ..ops.kernels.first_block import HALO as STEM_HALO
from ..parallel import sp
from ..utils import init as pinit
from .layers import ChannelNorm, ConvUnit
from .tconv import FirstBlock

NARROW_MAX_C = 96  # l3ac_tpu/models/decoder.py:34


class Stage(nn.Module):
    def __init__(self, i_d: int, o_d: int, stride: int, depth: int,
                 mc: ModelConfig, device=None):
        super().__init__()
        self.units = nn.ModuleList(
            ConvUnit(i_d, snake_act=mc.use_snake_act, use_norm=mc.use_norm,
                     device=device) for _ in range(depth))
        self.down = nn.Conv1d(i_d, o_d, stride, stride=stride, device=device)
        self.down_norm = ChannelNorm(o_d, device=device) if mc.use_norm else None


class Encoder(nn.Module):
    def __init__(self, mc: ModelConfig, device=None):
        super().__init__()
        dims = mc.encoder_dims
        self.depths = tuple(mc.encoder_depths)
        self.first = FirstBlock(dims[0], device=device)
        self.stages = nn.ModuleList(
            Stage(i_d, o_d, s, depth, mc, device=device)
            for i_d, o_d, s, depth in zip(dims[:-1], dims[1:], mc.compress_rates,
                                          mc.encoder_depths))
        self.last_units = nn.ModuleList(
            ConvUnit(dims[-1], snake_act=mc.use_snake_act, use_norm=mc.use_norm,
                     device=device) for _ in range(mc.encoder_depths[-1]))
        self.out_conv = nn.Conv1d(dims[-1], mc.feature_dim, 3, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.first.init_weights(gen)
        for st in self.stages:
            for u in st.units:
                u.init_weights(gen)
            pinit.weight_norm_layer_(st.down, gen)
        for u in self.last_units:
            u.init_weights(gen)
        pinit.weight_norm_layer_(self.out_conv, gen)

    def forward(self, audio: torch.Tensor, *, drop_path_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """audio: (B, T), T a multiple of conv_hop -> (B, T', feature_dim).
        ``drop_path_rate`` / ``generator``: train-only stochastic depth."""
        drops = iter(schedule(drop_path_rate, sum(self.depths), generator, ascending=True))
        if sp.active():
            # the stem's receptive field: 47 samples a side (JAX stages 25, ROADMAP C)
            lh, rh = sp.halo_blocks(audio, STEM_HALO, STEM_HALO, axis=1)
            h = self.first(audio, lh=lh, rh=rh, edges=sp.edge_flags())
        else:
            h = self.first(audio)                              # (B, C, T)
        in_t = True
        for st in self.stages:
            narrow = st.down.in_channels <= NARROW_MAX_C
            if narrow != in_t:
                h = h.transpose(1, 2).contiguous()
                in_t = narrow
            for u in st.units:
                h = u(h, channels_last=not in_t, drop=next(drops))
            h = conv1d_strided_matmul(h, st.down.weight, st.down.bias,
                                      channels_last=not in_t)
            if st.down_norm is not None:
                h = st.down_norm(h, dim=1 if in_t else -1)
            h = h.contiguous()
        if in_t:
            h = h.transpose(1, 2).contiguous()                 # (B, T, C)
        for u in self.last_units:
            h = u(h, channels_last=True, drop=next(drops))
        y = conv1d(h.transpose(1, 2), self.out_conv.weight, self.out_conv.bias,
                   padding=1)
        return y.transpose(1, 2)
