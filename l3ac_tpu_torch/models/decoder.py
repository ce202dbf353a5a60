"""Conv decoder: features (B, T', feature_dim) -> audio (B, T' * prod(rates))
(``l3ac_tpu/models/decoder.py``).

A k3 head conv, then per stage ``depth`` residual ConvUnits -> EnhanceBlock ->
up path (1x1 conv -> linear upsample x rate -> optional ChannelNorm, the
``up_fused`` / ``up_fused_ct`` kernels, from buffers prepared once,
``up_prepared``), then the tail:
- ``legacy``: 3 LegacyUnits at dilations 1 / 3 / 9 -> snake -> conv k7 ->
  tanh, one kernel. When the last rate is 2 the last up path hands the tail
  its two phase arrays (``legacy_tail_poly_ct``) and the interleaved
  activation is never stored; otherwise the tail reads the interleaved one
  (``legacy_tail_ct``). The tail's weights are stacked and packed for the
  kernel once (``tail_prepared``), not on every decode;
- ``dilation``: 3 ConvUnits at dilations 1 / 3 / 9; ``None``: 2 ConvUnits;
  both followed by snake -> conv k7 -> tanh in plain PyTorch.

Training: a ``(drop_path_rate, generator)`` gives the stage units stochastic
depth on a descending linspace ramp over ``sum(decoder_depths)`` units, the
tail at rate 0 (``l3ac_tpu/models/decoder.py:131-150``). Under autograd the
tail takes its live stacked weights (``tail_weights``), with the cached pack
only as the kernel's operand, so that its parameters get their gradient on
the card and on the CPU.

Wide stages run on (B, T, C); once a stage's width is at most
``NARROW_MAX_C`` the activation flips to (B, C, T) once and stays there, the
same switch as the JAX decoder. The reference's fp64 tail flag is not ported
(ROADMAP).

A bf16 decoder runs in bf16 throughout, each kernel's bf16 variant, and
returns bf16 audio (JAX casts the tail's tanh back to the ambient dtype,
``l3ac_tpu/models/decoder.py:decoder_apply``); the prepared buffers are
keyed on the weights' dtype, so a model moved with ``.to()`` rebuilds them.
"""

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv1d, snake
from ..ops import kernels as K
from ..ops.droppath import schedule
from ..ops.kernels import autograd
from ..ops.kernels.conv_unit import cached_prepare
from ..ops.kernels.legacy_tail import (DILATIONS, PreparedTail, TailWeights, legacy_tail_ct,
                                       legacy_tail_poly_ct, pack)
from ..ops.kernels.up_fused import UpPrepared, UpWeights, up_fused, up_fused_ct
from ..utils import init as pinit
from .layers import ChannelNorm, ConvUnit, LegacyUnit
from .tconv import EnhanceBlock

NARROW_MAX_C = 96  # l3ac_tpu/models/decoder.py:34


class Stage(nn.Module):
    def __init__(self, i_d: int, o_d: int, depth: int, mc: ModelConfig, device=None):
        super().__init__()
        self.units = nn.ModuleList(
            ConvUnit(i_d, snake_act=mc.use_snake_act, use_norm=mc.use_norm,
                     device=device) for _ in range(depth))
        self.enhance = EnhanceBlock(i_d, device=device)
        self.up_conv = nn.Conv1d(i_d, o_d, 1, device=device)
        self.up_norm = ChannelNorm(o_d, device=device) if mc.use_norm else None

    def init_weights(self, gen: torch.Generator) -> None:
        for u in self.units:
            u.init_weights(gen)
        self.enhance.init_weights(gen)
        pinit.weight_norm_layer_(self.up_conv, gen)

    def up_weights(self) -> UpWeights:
        n = self.up_norm
        return UpWeights(self.up_conv.weight[:, :, 0], self.up_conv.bias,
                         None if n is None else n.weight, None if n is None else n.bias)

    def up_prepared(self) -> UpPrepared:
        """The up path's kernel buffers (one per route, each built at its
        first use), cached on the conv and norm parameters
        (``cached_prepare``: rebuilt after ``load_state_dict`` or an in-place
        change; built on every call, never cached, where a parameter is an
        inference tensor)."""
        n = self.up_norm
        src = (self.up_conv.weight, self.up_conv.bias)
        src += () if n is None else (n.weight, n.bias)
        return cached_prepare(self.up_conv.weight, src, UpPrepared)


class Decoder(nn.Module):
    def __init__(self, mc: ModelConfig, device=None):
        super().__init__()
        self.mc = mc
        dims = mc.decoder_dims
        self.in_conv = nn.Conv1d(mc.feature_dim, dims[0], 3, device=device)
        self.stages = nn.ModuleList(
            Stage(i_d, o_d, depth, mc, device=device)
            for i_d, o_d, depth in zip(dims[:-1], dims[1:], mc.decoder_depths))
        tail = dims[-1]
        mode = mc.decoder_last_layer
        if mode == "legacy":
            units = [LegacyUnit(tail, device=device) for _ in DILATIONS]
        elif mode == "dilation":
            units = [ConvUnit(tail, snake_act=mc.use_snake_act, use_norm=mc.use_norm,
                              dilation=d, device=device) for d in DILATIONS]
        elif mode is None:
            units = [ConvUnit(tail, snake_act=mc.use_snake_act, use_norm=mc.use_norm,
                              device=device) for _ in range(2)]
        else:
            raise NotImplementedError(f"decoder_last_layer = {mode!r}")
        self.tail_units = nn.ModuleList(units)
        self.tail_alpha = nn.Parameter(torch.ones(tail, device=device))
        self.out_conv = nn.Conv1d(tail, 1, 7, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        pinit.weight_norm_layer_(self.in_conv, gen)
        for st in self.stages:
            st.init_weights(gen)
        for u in self.tail_units:
            u.init_weights(gen)
        pinit.weight_norm_layer_(self.out_conv, gen)

    def tail_weights(self) -> TailWeights:
        us = self.tail_units
        return TailWeights(
            torch.stack([u.alpha1 for u in us]), torch.stack([u.conv1.weight for u in us]),
            torch.stack([u.conv1.bias for u in us]), torch.stack([u.alpha2 for u in us]),
            torch.stack([u.conv2.weight[:, :, 0] for u in us]),
            torch.stack([u.conv2.bias for u in us]),
            self.tail_alpha, self.out_conv.weight, self.out_conv.bias)

    def tail_prepared(self) -> PreparedTail:
        """The stacked tail weights and the kernel's buffer, built once and
        cached on the tail's parameters (``cached_prepare``: rebuilt after
        ``load_state_dict`` or an in-place change; built on every call,
        never cached, where a parameter is an inference tensor)."""
        src = self.tail_parameters()

        def build() -> PreparedTail:
            with torch.no_grad():
                w = self.tail_weights()
                return PreparedTail(w, pack(w))

        return cached_prepare(self.tail_alpha, src, build)

    def tail(self, x: torch.Tensor) -> TailWeights | PreparedTail:
        """The tail's operands for input ``x``: the cached
        :meth:`tail_prepared`, or under autograd the live stacked weights
        (where x takes the kernel, beside the cached pack)."""
        if not autograd.needs_grad(*self.tail_parameters()):
            return self.tail_prepared()
        w = self.tail_weights()
        return PreparedTail(w, self.tail_prepared().packed) if K.route(x, "legacy_tail") else w

    def tail_parameters(self) -> tuple[torch.Tensor, ...]:
        us = self.tail_units
        return tuple(t for u in us for t in (u.alpha1, u.conv1.weight, u.conv1.bias,
                                             u.alpha2, u.conv2.weight, u.conv2.bias)) + \
            (self.tail_alpha, self.out_conv.weight, self.out_conv.bias)

    def forward(self, x: torch.Tensor, *, drop_path_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, T', feature_dim) -> audio (B, T' * prod(decode_rates)).
        ``drop_path_rate`` / ``generator``: train-only stochastic depth."""
        mc = self.mc
        drops = iter(schedule(drop_path_rate, sum(mc.decoder_depths), generator,
                              ascending=False))
        h = conv1d(x.transpose(1, 2), self.in_conv.weight, self.in_conv.bias, padding=1)
        h = h.transpose(1, 2).contiguous()                     # (B, T, C)
        in_t = False
        poly = mc.decoder_last_layer == "legacy" and mc.decode_rates[-1] == 2
        phases = None
        last = len(self.stages) - 1
        for si, (st, rate, i_d) in enumerate(zip(self.stages, mc.decode_rates,
                                                 mc.decoder_dims[:-1])):
            if not in_t and i_d <= NARROW_MAX_C:
                h = h.transpose(1, 2).contiguous()             # (B, C, T) from here
                in_t = True
            for u in st.units:
                h = u(h, channels_last=not in_t, drop=next(drops))
            h = st.enhance(h, channels_last=not in_t).contiguous()
            uw, prep = st.up_weights(), st.up_prepared()
            if not in_t:
                h = up_fused(h, uw, scale=rate, prepared=prep)
            elif poly and si == last:
                phases = up_fused_ct(h, uw, scale=rate, phase_split=True, prepared=prep)
            else:
                h = up_fused_ct(h, uw, scale=rate, prepared=prep)
        if phases is not None:
            return legacy_tail_poly_ct(*phases, self.tail(phases[0]))
        if not in_t:                                           # geometries that never narrow
            h = h.transpose(1, 2).contiguous()
        if mc.decoder_last_layer == "legacy":
            return legacy_tail_ct(h, self.tail(h))
        for u in self.tail_units:
            h = u(h, channels_last=False)
        h = conv1d(snake(h, self.tail_alpha[:, None]), self.out_conv.weight,
                   self.out_conv.bias, padding=3)
        return torch.tanh(h)[:, 0]
