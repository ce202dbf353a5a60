"""Trend-conv stem blocks (``l3ac_tpu/models/tconv.py``).

- BaseBlock: parallel [TrendPool(pk) -> Conv1d(1 -> target_dim / len, k=ck,
  dil = pk // dilation_rate + 1, centered pad)] branches, channel-concat.
- FirstBlock: BaseBlock(20, pk = (1, 5, 11, 21, 45), all dilations 1) ->
  1x1 Conv(20 -> 80) -> GELU -> concat the raw input -> 1x1 Conv(81 -> dim).
  Its forward is the ``first_block`` kernel (plain version on the CPU).

Activations are (B, C, T).
"""

import torch
from torch import nn

from ..ops import conv1d, trend_pool
from ..ops.kernels.first_block import POOLS, FirstBlockWeights, first_block
from ..utils import init as pinit

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

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio: (B, T) -> (B, target_dim, T)."""
        return first_block(audio, self.kernel_weights())
