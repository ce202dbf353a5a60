"""Norm holders, the residual ConvUnit and the LegacyUnit
(``l3ac_tpu/models/layers.py:19-170``).

ConvUnit: ``x + pw2(GRN(act(pw1(ChannelNorm(dwconv7(x))))))``, act = snake or
exact GELU. Its forward is the ``conv_unit_ct`` kernel on (B, C, T) or the
``conv_unit`` kernel on (B, T, C) (plain versions on the CPU), in the
activations' dtype (fp32 or bf16). With int8 weights
(``ops.quantized.quantize_params``) it follows the JAX dispatch
(``l3ac_tpu/models/layers.py:74-130``), whose fused kernels take dense
weights only: on (B, T, C) the unfused body runs, its two products through
the ``int8_matmul`` kernel (bf16 too). On (B, C, T) JAX runs the unfused
body on dense weights made from the int8 ones (``_dense_w``: ``q`` and the
scale cast to the activation dtype, then multiplied); the port's CPU path
does the same (``conv_unit_ct``'s plain version on weights made per call,
no dense copy kept), and on the card ``conv_unit_ct``'s kernel runs on
operands prepared once from the int8 weights (:meth:`ConvUnit.prepared`),
which differ from that body only by the GRN fold
(``ops/kernels/conv_unit.py``).

Training: under autograd the CUDA kernels run through ``ops/kernels/autograd``
(the backward differentiates their plain versions on the dense weights), and
the unit takes a ``(drop_rate, generator)`` pair for stochastic depth,
applied as ``x + drop_path(out - x)`` around the fused unit, as JAX's
``_maybe_drop`` does (``l3ac_tpu/models/layers.py:63-71``). int8 units do not
train: on the card their kernels raise under autograd.

LegacyUnit: snake -> conv k7 at dilation d -> snake -> conv k1, residual
outside. It holds the weights of one unit of the decoder's legacy tail, which
runs as one kernel with its plain version beside it
(``ops/kernels/legacy_tail.py``).
"""

import torch
from torch import nn

from ..ops import channel_norm, instance_norm
from ..ops.droppath import drop_path
from ..ops.kernels.conv_unit import (ConvUnitWeights, PreparedWeights, cached_prepare,
                                     conv_unit, conv_unit_ct, prepare_weights, prepared_weights,
                                     unit_body)
from ..ops.norms import EPS
from ..ops.quantized import Int8Linear
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


class InstanceNorm(nn.Module):
    """Affine normalization over time per channel, eps 1e-5 (the EnhanceBlock's
    ``InstanceNorm1d(affine=True)``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T)."""
        return instance_norm(x, self.weight, self.bias, dim=1)


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

    def kernel_weights(self, dense: bool = True) -> ConvUnitWeights:
        """The fused kernels' weights, int8 layers made dense in the unit's
        dtype (:meth:`Int8Linear.dense`); with ``dense=False`` the two
        product weights are left out (None)."""
        n = self.norm
        dtype = self.dw.weight.dtype
        pw1_w, pw2_w = ((_dense_weight(self.pw1, dtype), _dense_weight(self.pw2, dtype))
                        if dense else (None, None))
        return ConvUnitWeights(
            self.dw.weight, self.dw.bias,
            None if n is None else n.weight, None if n is None else n.bias,
            pw1_w, self.pw1.bias, self.alpha,
            self.grn.gamma, self.grn.beta, pw2_w, self.pw2.bias)

    def prepared(self) -> PreparedWeights:
        """The tensor-core kernels' product operands (``prepare_weights``),
        cached. Dense layers: on their weights (``prepared_weights``). int8
        layers: on the ``w_q`` / ``w_scale`` buffers of both and every other
        weight of the unit (a bf16 unit's operands hold them all, and their
        dtype is the unit's), prepared from the dense weights on a miss, so
        no call dequantizes once the set is cached."""
        if not isinstance(self.pw1, Int8Linear):
            return prepared_weights(self.kernel_weights())
        src = (self.pw1.w_q, self.pw1.w_scale, self.pw2.w_q, self.pw2.w_scale)
        src += tuple(t for t in self.kernel_weights(dense=False) if t is not None)
        return cached_prepare(self.pw1.w_q, src, lambda: prepare_weights(self.kernel_weights()))

    def forward(self, x: torch.Tensor, *, channels_last: bool,
                drop: tuple[float, torch.Generator | None] = (0.0, None)) -> torch.Tensor:
        """Residual unit: x (B, T, C) if ``channels_last`` else (B, C, T).
        ``drop``: the unit's (drop_rate, generator), inert by default."""
        int8 = isinstance(self.pw1, Int8Linear)
        if channels_last and int8:
            # JAX conv_unit_apply's unfused body: elementwise steps in plain
            # PyTorch, pw1 / pw2 as modules (int8_matmul), the exact GRN
            out = x + unit_body(x, self.kernel_weights(dense=False),
                                lambda h: self.pw1(h.contiguous()), self.pw2,
                                channel_dim=2, dilation=self.dilation)
        elif channels_last:
            out = conv_unit(x, self.kernel_weights(), dilation=self.dilation)
        else:
            # the kernel takes prepared products; the plain path (the CPU, and
            # a training backward) the dense weights, which an int8 unit makes
            # per call
            out = conv_unit_ct(x, self.kernel_weights(dense=not (int8 and x.is_cuda)),
                               dilation=self.dilation, prepared=self.prepared)
        rate, generator = drop
        if rate > 0.0 and generator is not None:
            return x + drop_path(out - x, rate, generator)
        return out


def _dense_weight(lin: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    return lin.dense(dtype) if isinstance(lin, Int8Linear) else lin.weight


class LegacyUnit(nn.Module):
    """Weights of one tail unit; its dilation is fixed by its place in the
    tail (``legacy_tail.DILATIONS``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.alpha1 = nn.Parameter(torch.ones(dim, device=device))
        self.conv1 = nn.Conv1d(dim, dim, 7, device=device)
        self.alpha2 = nn.Parameter(torch.ones(dim, device=device))
        self.conv2 = nn.Conv1d(dim, dim, 1, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        pinit.weight_norm_layer_(self.conv1, gen)
        pinit.weight_norm_layer_(self.conv2, gen)
