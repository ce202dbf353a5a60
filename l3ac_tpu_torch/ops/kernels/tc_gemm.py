"""The arithmetic of the tensor-core GEMM core (``csrc/tc_gemm.cuh``) in
PyTorch: the TF32 and bf16 roundings, the operand splits, and an emulation of
the core's products for the CPU tests.

The core computes ``epilogue(A @ B.T)`` in fp32 accuracy from tensor-core
passes:

- fp32 B (the ConvUnit weights), 3 TF32 passes:
  ``A_lo B_hi + A_hi B_lo + A_hi B_hi`` with ``X_hi = tf32_rna(X)`` and
  ``X_lo = tf32_rna(X - X_hi)`` (3xTF32). B is split once per weight by
  :func:`split_tf32` (``ops/kernels/conv_unit.py`` caches it); A is split in
  the kernel as its fragments are loaded.
- int8 B, 3 bf16 passes: ``q`` is exact in bf16, A is split into three bf16
  terms (:func:`split_bf16x3`, 24 bits), and the row scale is applied after
  the sum: ``y = scale * (A q^T) + b``.

Each K step of 32 sums into a fresh accumulator, which is added to the fp32
total with an ordinary rounded add: the tensor core's own fp32 adds truncate,
and a chain of hundreds of them drifts toward zero.
"""

from __future__ import annotations

import torch

K_STEP = 32   # K per fresh accumulator (tc_gemm.cuh kBK)
MMA_K = {"tf32": 8, "bf16": 16}   # K per mma.sync (m16n8k8 TF32, m16n8k16 bf16)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as fp32 with the 13 low mantissa bits zero: ``cvt.rna.tf32.f32``
    for every finite input."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_rna: float32 only, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_rna(x), lo = tf32_rna(x - hi); x - hi is exact."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(x0, x1, x2), each a bf16 value kept in fp32 (round to nearest even,
    ``cvt.rn.bf16x2.f32``): x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0
    - x1); every difference is exact, and x0 + x1 + x2 carries x's 24 bits."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x3: float32 only, got {x.dtype}")
    x0 = x.bfloat16().float()
    r = x - x0
    x1 = r.bfloat16().float()
    return x0, x1, (r - x1).bfloat16().float()


def _add_rz(acc: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32(acc + s) rounded toward zero, the sum in float64: one mma step's
    fp32 accumulate, modelled as exact products added with truncation."""
    t = acc.double() + s
    f = t.float()
    return torch.where(f.double().abs() > t.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def gemm_emulated(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """The core's ``a @ b.T`` (+ bias), as its passes round: a (M, K) fp32;
    b (N, K) fp32 (3 TF32 passes) or an int8 weight as int8 with ``scale``
    (N,) (3 bf16 passes, ``scale * sum + bias``). Within a K step the mma
    steps add in fp32 toward zero; the steps add into the total in fp32. The
    products' sum order inside one mma is not modelled (exact here)."""
    int8 = b.dtype == torch.int8
    if int8 != (scale is not None):
        raise ValueError("gemm_emulated: an int8 b goes with a scale, an fp32 b without")
    if int8:
        q = b.double()
        x0, x1, x2 = split_bf16x3(a)
        passes, step = [(x2, q), (x1, q), (x0, q)], MMA_K["bf16"]
    else:
        a_hi, a_lo = split_tf32(a)
        b_hi, b_lo = split_tf32(b)
        passes = [(a_lo, b_hi.double()), (a_hi, b_lo.double()), (a_hi, b_hi.double())]
        step = MMA_K["tf32"]
    M, Kd = a.shape
    total = torch.zeros(M, b.shape[0], dtype=torch.float32)
    for k0 in range(0, Kd, K_STEP):
        acc = torch.zeros_like(total)
        for k in range(k0, min(Kd, k0 + K_STEP), step):
            for x, w in passes:
                acc = _add_rz(acc, x[:, k:k + step].double() @ w[:, k:k + step].T)
        total = total + acc
    if int8:
        total = (total.double() * scale.double()).float()
    return total if bias is None else total + bias
