"""Norm holders and the residual ConvUnit (``l3ac_tpu/models/layers.py:19-130``).

ConvUnit: ``x + pw2(GRN(act(pw1(ChannelNorm(dwconv7(x))))))``, act = snake or
exact GELU. Its forward is the ``conv_unit_ct`` kernel on (B, C, T) or the
``conv_unit`` kernel on (B, T, C) (plain versions on the CPU).
"""

import torch
from torch import nn

from ..ops import channel_norm
from ..ops.kernels.conv_unit import ConvUnitWeights, conv_unit, conv_unit_ct
from ..ops.norms import EPS
from ..utils import init as pinit


class ChannelNorm(nn.Module):
    """Affine normalization over the channel axis, eps inside the sqrt
    (1e-8; the transformer's pre-norms pass torch's LayerNorm eps, 1e-5)."""

    def __init__(self, dim: int, eps: float = EPS, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return channel_norm(x, self.weight, self.bias, self.eps, dim)


class GRN(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))


class ConvUnit(nn.Module):
    def __init__(self, dim: int, *, snake_act: bool = True, use_norm: bool = False,
                 kernel_size: int = 7, dilation: int = 1, device=None):
        super().__init__()
        self.dilation = dilation
        self.dw = nn.Conv1d(dim, dim, kernel_size, groups=dim, device=device)
        self.norm = ChannelNorm(dim, device=device) if use_norm else None
        self.pw1 = nn.Linear(dim, 4 * dim, device=device)
        self.alpha = (nn.Parameter(torch.ones(4 * dim, device=device))
                      if snake_act else None)
        self.grn = GRN(4 * dim, device=device)
        self.pw2 = nn.Linear(4 * dim, dim, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        """Draw the conv and linear weights; norms, GRN and alpha keep their
        construction values (1 / 0, 0, 1)."""
        pinit.weight_norm_layer_(self.dw, gen)
        pinit.weight_norm_layer_(self.pw1, gen)
        pinit.weight_norm_layer_(self.pw2, gen)

    def kernel_weights(self) -> ConvUnitWeights:
        n = self.norm
        return ConvUnitWeights(
            self.dw.weight, self.dw.bias,
            None if n is None else n.weight, None if n is None else n.bias,
            self.pw1.weight, self.pw1.bias, self.alpha,
            self.grn.gamma, self.grn.beta, self.pw2.weight, self.pw2.bias)

    def forward(self, x: torch.Tensor, *, channels_last: bool) -> torch.Tensor:
        """Residual unit: x (B, T, C) if ``channels_last`` else (B, C, T)."""
        fn = conv_unit if channels_last else conv_unit_ct
        return fn(x, self.kernel_weights(), dilation=self.dilation)
