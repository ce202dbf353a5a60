"""int8 weight-only dense layer: ``y = x @ (w_q * scale).T + b``.

Replaces ``l3ac_tpu/ops/pallas/int8_matmul.py:int8_matmul`` (body
``_kernel``) with ``csrc/int8_matmul.cu``. The weight is in ``nn.Linear``
layout, ``w_q`` (N, K) int8 with ``scale`` (N,) fp32; x is (..., K) fp32 and
the output (..., N) fp32.

Bound on the H100: 2 M K N fp32 operations against 4 M (K + N) + K N bytes,
so every shape of the codec (K, N <= 2048, M in the thousands) is bound by
the fp32 rate, not memory. The TPU kernel holds the whole (K, N) weight in
VMEM and tiles only M; here the weight is tiled in N and K as well. Each
block computes a 128 x 64 output tile: per step of 32 along K it stages the
x chunk and the int8 weight chunk, dequantized on chip as ``float(q) *
scale``, in shared memory, and each thread keeps an 8 x 4 tile of fp32 sums
in registers. Device memory sees only the 1-byte weight. SIMT fp32 FMAs: with
fp32 activations and TF32 off no tensor-core path gives the same numbers.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from . import _build


def dequantize_weight(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 (N, K): ``w_q.float() * scale``, JAX's rounding."""
    return w_q.float() * scale[:, None]


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """The same product in plain PyTorch, the weight dequantized in fp32."""
    y = x @ dequantize_weight(w_q, scale).T
    return y if b is None else y + b


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
            b: torch.Tensor | None) -> torch.Tensor:
    N, Kd = w_q.shape
    if x.shape[-1] != Kd or scale.shape != (N,) or (b is not None and b.shape != (N,)):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)} do not match")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: w_q must be int8, got {w_q.dtype}")
    if w_q.device != x.device or not w_q.is_contiguous():
        raise ValueError(f"int8_matmul: w_q must be contiguous on {x.device}")
    K.check_cuda({"x": x, "scale": scale, "b": b}, x.device)
    M = x.numel() // Kd
    out = torch.empty(*x.shape[:-1], N, device=x.device, dtype=torch.float32)
    fn = _build.function("l3ac_int8_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), _build.ptr(b),
             out.data_ptr(), M, N, Kd, _build.stream_ptr())
    _build.check(err, "int8_matmul")
    K.LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K) fp32; w_q (N, K) int8; scale (N,) fp32; b (N,) or None ->
    (..., N). Kernel on CUDA (x contiguous; a strided view raises), plain on
    CPU."""
    K.check_input(x, "int8_matmul x")
    if not K.route(x, "int8_matmul"):
        return int8_matmul_plain(x, w_q, scale, b)
    return _launch(x, w_q, scale, b)
