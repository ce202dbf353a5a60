"""int8 weight-only dense layer: ``y = x @ (w_q * scale).T + b``.

Replaces ``l3ac_tpu/ops/pallas/int8_matmul.py:int8_matmul`` (body
``_kernel``) with ``csrc/int8_matmul.cu``. The weight is in ``nn.Linear``
layout, ``w_q`` (N, K) int8 with ``scale`` (N,) fp32; x is (..., K) fp32 or
bf16 and the output (..., N) in x's dtype.

Bound on the H100: 2 M K N operations against 4 M (K + N) + K N bytes. The
kernel runs on the tensor-core GEMM core (``csrc/tc_gemm.cuh``): ``q`` is
exact in bf16, so x alone is split, into three bf16 terms
(``tc_gemm.split_bf16x3``, 24 bits), and the product takes three bf16
passes (two TF32 passes measured slower, ``tools/tc_variants.py``). The
scale moves to the epilogue, so the kernel rounds as ``scale * sum(x q) + b`` where the plain
version (and the JAX package) rounds as ``sum(x (q scale)) + b``; the two
agree within fp32 rounding, far inside the ``1e-4`` tolerance the card is
held to. The TPU kernel holds the whole (K, N) weight in VMEM and tiles only
M; here each block computes a 128 x 128 output tile, streaming K in steps of
32 through shared memory, where the int8 weight tile is widened to fp32.
Device memory sees only the 1-byte weight.

bf16 x (the bf16 model's layers): ``l3ac_int8_matmul_bf16``, the TPU
kernel's rounding (``int8_matmul.py:37-40``), on the wgmma core
(``csrc/gemm_sm90.cuh``): TMA stages each int8 tile and the producer's
warps dequantize it to ``bf16(fp32(q) * scale)`` in shared memory, wgmma
sums in fp32 in one accumulator across K, ``bf16(b)`` is added in fp32 and
the output rounded to bf16 once. The weight stays int8 in device memory;
its tensor map is built once (``gemm_sm90.weight_map``). Shapes TMA cannot
take (K % 16 != 0: the GEGLU w2 at K = 341) run the core's cp.async route
(``gemm_sm90.route_for``). The bias is the layer's bf16 bias. The plain version
(:func:`int8_matmul_plain_bf16`) rounds at the same points, so the two
differ only by the order of the fp32 sums.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from . import _build, autograd, gemm_sm90


def dequantize_weight(w_q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, K) in ``dtype``: ``w_q * scale`` in fp32, then rounded to
    ``dtype`` (``l3ac_tpu/ops/quantized.py:dequantize_weight``)."""
    return (w_q.float() * scale.float()[:, None]).to(dtype)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """The same product in plain PyTorch, the weight dequantized in fp32."""
    y = x @ dequantize_weight(w_q, scale).T
    return y if b is None else y + b


def int8_matmul_plain_bf16(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 kernel's function in plain PyTorch: the weight dequantized to
    bf16, the product of the bf16 values with fp32 sums, ``bf16(b)`` added in
    fp32, one rounding to bf16."""
    y = x.float() @ dequantize_weight(w_q, scale, torch.bfloat16).float().T
    if b is not None:
        y = y + b.to(torch.bfloat16).float()
    return y.to(torch.bfloat16)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BF16_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    K.check_cuda({"x": x, "b": b}, x.device, dtype=x.dtype)
    K.check_cuda({"scale": scale}, x.device)
    M = x.numel() // Kd
    out = torch.empty(*x.shape[:-1], N, device=x.device, dtype=x.dtype)
    if x.dtype == torch.bfloat16:
        route = gemm_sm90.route_for(M, N, Kd, int8=True, a_ptr=x.data_ptr(),
                                    b_ptr=w_q.data_ptr())
        wmap = gemm_sm90.weight_map(w_q) if route == "tma" else None  # alive across the launch
        fn = _build.function("l3ac_int8_matmul_bf16", _BF16_ARGTYPES)
        err = fn(x.data_ptr(), w_q.data_ptr(), gemm_sm90.map_ptr(wmap), scale.data_ptr(), _build.ptr(b),
                 out.data_ptr(), M, N, Kd, gemm_sm90.ROUTE_CODE[route], _build.stream_ptr())
        _build.check(err, "int8_matmul")
        gemm_sm90.ROUTES[route] += 1
    else:
        fn = _build.function("l3ac_int8_matmul", _ARGTYPES)
        err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), _build.ptr(b),
                 out.data_ptr(), M, N, Kd, _build.stream_ptr())
        _build.check(err, "int8_matmul")
    K.LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K) fp32 or bf16; w_q (N, K) int8; scale (N,) fp32; b (N,) in
    x's dtype or None -> (..., N) in x's dtype. Kernel on CUDA (x contiguous;
    a strided view raises; under autograd it raises: int8 does not train),
    plain on CPU."""
    K.check_input(x, "int8_matmul x", dtype=K.DTYPES)
    if not K.route(x, "int8_matmul"):
        plain = int8_matmul_plain_bf16 if x.dtype == torch.bfloat16 else int8_matmul_plain
        return plain(x, w_q, scale, b)
    return autograd.call("int8_matmul", lambda: _launch(x, w_q, scale, b), int8_matmul_plain,
                         x, w_q, scale, b)
