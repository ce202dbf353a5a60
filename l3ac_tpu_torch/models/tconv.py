"""Trend-conv stem blocks (``l3ac_tpu/models/tconv.py``).

- BaseBlock: parallel [TrendPool(pk) -> Conv1d(1 -> target_dim / len, k=ck,
  dil = pk // dilation_rate + 1, centered pad)] branches, channel-concat.
- FirstBlock: BaseBlock(20, pk = (1, 5, 11, 21, 45), all dilations 1) ->
  1x1 Conv(20 -> 80) -> GELU -> concat the raw input -> 1x1 Conv(81 -> dim).
  Its forward is the ``first_block`` kernel on weights prepared once
  (``FirstBlock.prepared``), or on the CPU the plain version on the live
  parameters.
- EnhanceBlock: BaseBlock(4, pk = (1, 3, 5, 9), dilations (1, 2, 3, 5)) on
  **channel 0 only** -> InstanceNorm(4, affine) -> plain 1x1 Conv(4 -> dim),
  and the gate ``x * (1 + g)``. Plain PyTorch in both layouts: the JAX package
  runs it outside any Pallas kernel too. In bf16 every step runs in bf16
  (``enhance_block_apply`` / ``_t`` on bf16 parameters), the instance norm by
  ``ops.norms``' bf16 rule (fp32 statistics), and the gate in bf16.

Activations are (B, C, T) unless a forward says otherwise. Under sequence
parallelism the EnhanceBlock's branch pads (``ops.conv1d``, ``trend_pool``)
exchange halos and its instance norm sums its moments over the shards
(``ops.norms``); the stem takes its halos as operands.
"""

import torch
from torch import nn

from ..ops import conv1d, trend_pool
from ..ops import kernels as K
from ..ops.kernels import autograd
from ..ops.kernels.conv_unit import cached_prepare
from ..ops.kernels.first_block import (POOLS, FirstBlockWeights, PreparedStem, first_block,
                                      first_block_plain, pack)
from ..utils import init as pinit
from .layers import InstanceNorm

FIRST_BLOCK_POOLS = POOLS
FIRST_BLOCK_CONVS = (7, 7, 7, 7, 7)
FIRST_BLOCK_DILATION_RATE = 99  # all dilations collapse to 1


def _branch_meta(conv_kernels, pool_kernels, dilation_rate):
    return [{"pool_k": pk, "conv_k": ck, "dilation": pk // dilation_rate + 1,
             "padding": (ck - 1) * (pk // dilation_rate + 1) // 2}
            for ck, pk in zip(conv_kernels, pool_kernels)]


class BaseBlock(nn.Module):
    def __init__(self, target_dim: int, conv_kernels=(7, 7, 7, 7),
                 pool_kernels=(1, 3, 5, 9), dilation_rate=2, device=None):
        super().__init__()
        if target_dim % len(pool_kernels):
            raise ValueError("target_dim must split evenly over the branches")
        each = target_dim // len(pool_kernels)
        self.metas = _branch_meta(conv_kernels, pool_kernels, dilation_rate)
        self.branches = nn.ModuleList(
            nn.Conv1d(1, each, m["conv_k"], device=device) for m in self.metas)

    def init_weights(self, gen: torch.Generator) -> None:
        for br in self.branches:
            pinit.weight_norm_layer_(br, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, T) -> (B, target_dim, T)."""
        return torch.cat([
            conv1d(trend_pool(x, m["pool_k"]), br.weight, br.bias,
                   padding=m["padding"], dilation=m["dilation"])
            for br, m in zip(self.branches, self.metas)], dim=1)


class FirstBlock(nn.Module):
    def __init__(self, target_dim: int, device=None):
        super().__init__()
        h_dim = len(FIRST_BLOCK_POOLS) * 4  # 20
        self.base = BaseBlock(h_dim, FIRST_BLOCK_CONVS, FIRST_BLOCK_POOLS,
                              FIRST_BLOCK_DILATION_RATE, device=device)
        self.conv1 = nn.Conv1d(h_dim, h_dim * 4, 1, device=device)
        self.conv2 = nn.Conv1d(h_dim * 4 + 1, target_dim, 1, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.base.init_weights(gen)
        pinit.weight_norm_layer_(self.conv1, gen)
        pinit.weight_norm_layer_(self.conv2, gen)

    def kernel_weights(self) -> FirstBlockWeights:
        br = self.base.branches
        return FirstBlockWeights(
            torch.stack([b.weight[:, 0, :] for b in br]),
            torch.stack([b.bias for b in br]),
            self.conv1.weight[:, :, 0].contiguous(), self.conv1.bias,
            self.conv2.weight[:, :, 0].contiguous(), self.conv2.bias)

    def prepared(self) -> PreparedStem:
        """The stacked stem weights and the kernel's buffer, built once and
        cached on the stem's parameters (``cached_prepare``: rebuilt after
        ``load_state_dict`` or an in-place change; built on every call,
        never cached, where a parameter is an inference tensor)."""
        src = tuple(t for b in self.base.branches for t in (b.weight, b.bias))
        src += (self.conv1.weight, self.conv1.bias, self.conv2.weight, self.conv2.bias)

        def build() -> PreparedStem:
            with torch.no_grad():
                w = self.kernel_weights()
                return PreparedStem(w, pack(w))

        return cached_prepare(self.conv1.weight, src, build)

    def forward(self, audio: torch.Tensor, *, lh: torch.Tensor | None = None,
                rh: torch.Tensor | None = None,
                edges: tuple[int, int] | None = None) -> torch.Tensor:
        """audio: (B, T) -> (B, target_dim, T). The kernel takes the cached
        pack; on the CPU the plain version takes the live parameters, so its
        output keeps their autograd graph. Under autograd the kernel's
        backward differentiates the plain version on the live parameters too
        (the pack is only the launch's operand). ``lh`` / ``rh`` / ``edges``:
        the SP halos (B, HALO) and shard flags, as ``first_block`` takes them."""
        halos = {} if lh is None and rh is None else {"lh": lh, "rh": rh, "edges": edges}
        if not K.route(audio, "first_block"):
            return first_block_plain(audio, self.kernel_weights(), **halos)
        if autograd.needs_grad(audio, *self.parameters()):
            return first_block(audio, PreparedStem(self.kernel_weights(), self.prepared().packed),
                               **halos)
        return first_block(audio, self.prepared(), **halos)


ENHANCE_POOLS = (1, 3, 5, 9)
ENHANCE_CONVS = (7, 7, 7, 7)
ENHANCE_DILATION_RATE = 2


class EnhanceBlock(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.base = BaseBlock(4, ENHANCE_CONVS, ENHANCE_POOLS, ENHANCE_DILATION_RATE,
                              device=device)
        self.in_norm = InstanceNorm(4, device=device)
        self.merge = nn.Conv1d(4, dim, 1, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        """Weight-normed branch convs; the merge conv is a plain torch Conv1d
        (torch's default init); the norm keeps 1 / 0."""
        self.base.init_weights(gen)
        pinit.torch_default_(self.merge.weight, self.merge.bias, gen, 4)

    def forward(self, x: torch.Tensor, *, channels_last: bool) -> torch.Tensor:
        """x: (B, T, C) if ``channels_last`` else (B, C, T); same shape out."""
        c_dim = 2 if channels_last else 1
        xi = x.narrow(c_dim, 0, 1)
        y = self.base(xi.transpose(1, 2) if channels_last else xi)  # (B, 4, T)
        y = self.in_norm(y)
        g = torch.einsum("oc,bct->bot", self.merge.weight[:, :, 0], y) + \
            self.merge.bias[:, None]
        if channels_last:
            g = g.transpose(1, 2)
        return x * (1.0 + g)
