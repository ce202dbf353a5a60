"""int8 weight-only quantization (``l3ac_tpu/ops/quantized.py:20-99``).

Symmetric per-output-channel int8 for the codec's matmul weights;
activations stay in the model's dtype, fp32 or bf16. In ``nn.Linear``
layout: ``w_q`` is (Cout, Cin) int8 and ``w_scale`` (Cout,) fp32, so ``w ~=
w_q * w_scale[:, None]``; the JAX package keeps the transpose, (Cin, Cout)
and (1, Cout). The bias keeps the layer's dtype (bf16 in a bf16 model, as
JAX's quantized tree keeps ``b``).

:func:`quantize_params` swaps each large ``nn.Linear`` of a codec for an
:class:`Int8Linear`, whose forward is the ``int8_matmul`` kernel (its bf16
variant on bf16 x; plain versions on the CPU). The (B, C, T) ConvUnits run
on dense weights made from the int8 ones with JAX's rule for the narrow
units (``l3ac_tpu/models/layers.py:_dense_w``: ``q`` and the scale cast to
the activation dtype, then multiplied), :meth:`Int8Linear.dense`.
"""

from __future__ import annotations

import torch
from torch import nn

from .kernels.int8_matmul import dequantize_weight, int8_matmul

# attribute names whose nn.Linear may be quantized (JAX: dict keys)
_QUANT_SUFFIXES = ("pw1", "pw2", "qkv", "out", "w1", "w2", "proj_in",
                   "proj_out")


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Cout, Cin) weight -> (w_q (Cout, Cin) int8, scale (Cout,) fp32): per
    row amax / 127 (1 for an all-zero row), round half to even, clamp to
    +-127; bit for bit JAX's ``quantize_weight`` on the transpose."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return w_q, scale


class Int8Linear(nn.Module):
    """``nn.Linear`` with an int8 weight: buffers ``w_q`` (Cout, Cin) int8 and
    ``w_scale`` (Cout,) fp32, and an optional ``bias`` in ``dtype`` (the
    activations' dtype, fp32 or bf16)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_q", torch.zeros(out_features, in_features,
                                                dtype=torch.int8, device=device))
        self.register_buffer("w_scale", torch.ones(out_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype))
                     if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> Int8Linear:
        q = cls(lin.in_features, lin.out_features, lin.bias is not None,
                device=lin.weight.device, dtype=lin.weight.dtype)
        with torch.no_grad():
            q.w_q, q.w_scale = quantize_weight(lin.weight)
            if lin.bias is not None:
                q.bias.copy_(lin.bias)
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.w_q, self.w_scale, self.bias)

    def dense(self, dtype: torch.dtype) -> torch.Tensor:
        """``q`` and the scale cast to ``dtype``, then multiplied in ``dtype``:
        JAX's rule for the units it runs unfused (``layers.py:_dense_w``);
        in fp32 the same as ``int8_matmul.dequantize_weight``."""
        return self.w_q.to(dtype) * self.w_scale.to(dtype)[:, None]


def quantize_params(codec: nn.Module, *, min_size: int = 1024) -> nn.Module:
    """Replace, in place, every ``nn.Linear`` held under a name in
    ``_QUANT_SUFFIXES`` whose weight has at least ``min_size`` elements by an
    :class:`Int8Linear`; returns ``codec``. The same selection as JAX's
    ``quantize_params`` (the DynamicPositionBias's ``w1`` / ``w2`` are plain
    parameters, not layers, and stay fp32). Works on a ``device="meta"``
    codec too."""
    for module in list(codec.modules()):
        for name, child in list(module.named_children()):
            if (type(child) is nn.Linear and name in _QUANT_SUFFIXES
                    and child.weight.numel() >= min_size):
                setattr(module, name, Int8Linear.from_linear(child))
    return codec
