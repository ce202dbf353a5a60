"""A conv_unit_ct-like chain on bf16 (B, C, T), run up to a chosen stage: the
bisection of where a fused ConvUnit's time goes.

Replaces the TPU probe ``tools/bisect_kernel.py`` (``pallas_call`` at :91,
body ``_kernel`` :33) with ``csrc/conv_unit_stages.cu``, one template
instance per mode. It follows the probe's body line by line, which is not
the codec's ConvUnit: no dw bias, a ChannelNorm without affine, an
activation (``h + sin(h)^2``) only in ``full``, no GRN, and the residual
added onto the chain's own activation, not onto x. ``tile`` is the probe's
time tile S and part of the result: ``dw`` and ``dw_mm`` pad every tile with
zeros on its own, ``full`` only the sequence.

bf16 in and out; the depthwise conv in fp32 (taps added in order from 0),
each product's operands rounded to bf16 and summed in fp32. Bound on the
H100: ``copy`` .. ``norm`` by bytes; the products, 16 C^2 operations per
column, by the bf16 tensor-core rate at C = 96 and by bytes at C <= 48. The
kernel's products are SIMT fp32 FMAs, so it is far from that bound (see
PERF.md).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels as K
from . import _build

MODES = ("copy", "halo_only", "dw", "norm", "mm", "dw_mm", "full")
MAX_C = 192  # 12 output channels per thread group in the second product
HALO, TAPS = 3, 7
NORM_EPS = 1e-8


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """The value of a bf16 cast, in fp32: an operand of a bf16 product."""
    return t.bfloat16().float()


def _depthwise(x: torch.Tensor, dww: torch.Tensor, tile: int, halo: bool) -> torch.Tensor:
    """k7 depthwise conv in fp32, taps added in order; zero pads around every
    tile, or with ``halo`` only around the sequence."""
    B, C, T = x.shape
    w = dww.float()
    if halo:
        xpad, n = F.pad(x, (HALO, HALO)), T
    else:
        xpad, n, w = F.pad(x.reshape(B, C, T // tile, tile), (HALO, HALO)), tile, w[:, None]
    acc = torch.zeros_like(xpad[..., :n])
    for k in range(TAPS):
        acc = acc + xpad[..., k:k + n] * w[..., k:k + 1]
    return acc.reshape(B, C, T)


def conv_unit_stages_plain(x: torch.Tensor, dww: torch.Tensor, w1t: torch.Tensor,
                           w2t: torch.Tensor, tile: int, mode: str) -> torch.Tensor:
    """The probe's chain in plain PyTorch; products as fp32 matmuls of the
    bf16-rounded operands (each product exact in fp32)."""
    if mode in ("copy", "halo_only"):
        return x.clone()
    acc = x.float()
    if mode in ("dw", "dw_mm", "full"):
        acc = _depthwise(acc, dww, tile, halo=mode == "full")
    if mode in ("norm", "full"):
        u = acc.mean(1, keepdim=True)
        s = ((acc - u) ** 2).mean(1, keepdim=True)
        acc = (acc - u) / torch.sqrt(s + NORM_EPS)
    if mode in ("mm", "dw_mm", "full"):
        h = torch.einsum("mc,bct->bmt", w1t.float(), _bf16(acc))
        if mode == "full":
            h = h + torch.sin(h) ** 2
        acc = acc + torch.einsum("cm,bmt->bct", w2t.float(), _bf16(h))
    return acc.bfloat16()


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch(x, dww, w1t, w2t, tile: int, mode: str) -> torch.Tensor:
    B, C, T = x.shape
    if C > MAX_C:
        raise ValueError(f"conv_unit_stages: C = {C} > {MAX_C}")
    K.check_cuda({"x": x, "dww": dww, "w1t": w1t, "w2t": w2t}, x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    fn = _build.function("l3ac_conv_unit_stages", _ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), dww.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
             B, C, T, tile, MODES.index(mode), _build.stream_ptr())
    _build.check(err, "conv_unit_stages")
    K.LAUNCHES["conv_unit_stages"] += 1
    return out


def conv_unit_stages(x: torch.Tensor, dww: torch.Tensor, w1t: torch.Tensor,
                     w2t: torch.Tensor, tile: int, mode: str) -> torch.Tensor:
    """x (B, C, T), dww (C, 7), w1t (4C, C), w2t (C, 4C), all bf16; T a
    multiple of ``tile``; ``mode`` one of ``MODES``. Kernel on CUDA, plain on
    CPU."""
    name = "conv_unit_stages"
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} is not one of {MODES}")
    K.check_input(x, f"{name} x", ndim=3, dtype=torch.bfloat16)
    for t, n in ((dww, "dww"), (w1t, "w1t"), (w2t, "w2t")):
        K.check_input(t, f"{name} {n}", ndim=2, dtype=torch.bfloat16)
    B, C, T = x.shape
    if dww.shape != (C, TAPS) or w1t.shape != (4 * C, C) or w2t.shape != (C, 4 * C):
        raise ValueError(f"{name}: weight shapes do not match C = {C}")
    if tile < 1 or T % tile:
        raise ValueError(f"{name}: T = {T} is not a multiple of tile = {tile}")
    if not K.route(x, name):
        return conv_unit_stages_plain(x, dww, w1t, w2t, tile, mode)
    return _launch(x, dww, w1t, w2t, tile, mode)
