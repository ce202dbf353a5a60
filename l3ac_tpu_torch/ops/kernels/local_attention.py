"""Block-local causal attention: each window of n queries attends to the
[previous | current] windows' 2n keys.

Replaces ``l3ac_tpu/ops/pallas/local_attention.py:local_attention`` (body
``_attn_kernel``) with ``csrc/local_attention.cu``. Same signature as the JAX
wrapper, ``(q, k, v, *, window_size, bias)`` with q, k, v of shape
(B, H, T, D) and bias (H, n, 2n) or None, and one more keyword,
``bias_table``: the dynamic position bias's (2n, H) Toeplitz table
(``ops.attention.dynamic_position_table``), of which the full bias is the
expansion ``bias[h, i, j] = table[|n + i - j|, h]``. At most one of the two is
given. The model passes the table; the full bias stays accepted (the tests
and the JAX parity checks pass random ones).

The TPU wrapper folds the causal mask and window 0's missing previous block
into two stored additive planes, ``bias + mask``, indexed by min(w, 1). This
kernel adds the same bias and applies the same two masks from the indices
(key j of [prev | cur] is valid iff j <= n + i, and j >= n in window 0), so
it reads no mask planes. A masked key gets weight 0, as NEG_INF does in the
plain version.

Heads are read in place: q, k and v may be any (B, H, T, D) views whose last
dim is contiguous, whose B / H / T strides are multiples of 4 floats and
whose data is 16-byte aligned (the head split of a (B, T, 3 H D) projection
is one); the wrapper raises on any other view and never copies. The output
is written as (B, T, H, D) and returned as its (B, H, T, D) permuted view, so
the caller's merge of the heads is a view too.

Bound on the H100, design (flash-attention style: 3xTF32 mma.sync for both
products, online softmax in registers, the table column in shared memory)
and how P moves between the two products: the note at the head of
``csrc/local_attention.cu``. No SDPA, no cuDNN, no cuBLAS.

Head dims: D a multiple of 4 up to ``MAX_HEAD_DIM`` (128), the K loop of
S = q K^T in steps of 8 (fp32) or 16 (bf16) and O in D / 8 n8 tiles.
:func:`admits` is the shape rule the launch applies.

bf16 (the encode half of ROADMAP A6): bf16 q / k / v (and a bias or table in
bf16) run the bf16 kernel of the same file, both products one m16n8k16 bf16
pass with fp32 sums. q is scaled by D^-1/2 in bf16 (the scale rounded to
bf16) as the plain version and the JAX kernel do; the bias is added and the
online softmax runs in fp32; P is rounded to bf16 for P V and O is written
in bf16 after the division by the row sum. The plain version rounds the
normalized P where this kernel rounds exp(s - m) with the running max m
and divides at the end: the one rounding point the two do not share, worth
at most a bf16 ulp of P.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from ..attention import local_attention as local_attention_plain
from . import _build

MAX_HEAD_DIM = 128  # csrc/local_attention.cu: D / 8 n8 tiles of O
ALIGN = 4           # elements: rows are read as pieces of 4 (16 bytes fp32, 8 bf16)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 +
             [ctypes.c_float, ctypes.c_void_p])


def _strides(t: torch.Tensor, name: str) -> list[int]:
    """The B, H, T element strides the kernel takes for a (B, H, T, D) view
    (0 for a dim of size 1); raises on a view it cannot read in place."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"local_attention: {name}'s last dim is not contiguous "
                         f"(strides {t.stride()}); the kernel does not copy")
    out = [t.stride(d) if t.shape[d] > 1 else 0 for d in range(3)]
    piece = ALIGN * t.element_size()
    if any(s % ALIGN for s in out) or t.data_ptr() % piece:
        raise ValueError(f"local_attention: {name} (strides {t.stride()}, address "
                         f"{t.data_ptr():#x}) is not a view of {piece}-byte aligned rows: "
                         f"its B / H / T strides must be multiples of {ALIGN}")
    return out


def admits(D: int) -> str | None:
    """Why the kernel does not take head dim D, or None when it does."""
    if not 1 <= D <= MAX_HEAD_DIM:
        return f"local_attention: the kernel takes D <= {MAX_HEAD_DIM}, got {D}"
    if D % ALIGN:
        return f"local_attention: the kernel takes D a multiple of {ALIGN}, got {D}"
    return None


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window_size: int, bias: torch.Tensor | None = None,
                    bias_table: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D) views, T a multiple of window_size; bias
    (H, n, 2n), or bias_table (2n, H), or neither. Returns (B, H, T, D), on
    CUDA a permuted view of a (B, T, H, D) tensor. Kernel on CUDA, plain on
    CPU."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.check_input(t, f"local_attention {name}", ndim=4, dtype=K.DTYPES)
    if bias is not None and bias_table is not None:
        raise ValueError("local_attention: pass bias or bias_table, not both")
    if not K.route(q, "local_attention"):
        return local_attention_plain(q, k, v, window_size=window_size, bias=bias,
                                     bias_table=bias_table)
    B, H, T, D = q.shape
    n = window_size
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("local_attention: q, k, v shapes differ")
    why = admits(D)
    if why is not None:
        raise ValueError(why)
    if n < 1 or T % n:
        raise ValueError(f"local_attention: T = {T} is not a multiple of n = {n}")
    if bias is not None and bias.shape != (H, n, 2 * n):
        raise ValueError(f"local_attention: bias {tuple(bias.shape)} is not "
                         f"{(H, n, 2 * n)}")
    if bias_table is not None and bias_table.shape != (2 * n, H):
        raise ValueError(f"local_attention: bias_table {tuple(bias_table.shape)} is not "
                         f"{(2 * n, H)}")
    K.check_cuda({"bias": bias, "bias_table": bias_table}, q.device, dtype=q.dtype)
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected {q.dtype} on "
                             f"{q.device}")
        strides += _strides(t, name)
    bf16 = q.dtype == torch.bfloat16
    scale = D ** -0.5
    if bf16:  # the scale as a bf16 operand, as the plain version takes it
        scale = float(torch.tensor(scale, dtype=torch.bfloat16))
    out = torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    fn = _build.function("l3ac_local_attention_bf16" if bf16 else "l3ac_local_attention",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(bias),
             _build.ptr(bias_table), out.data_ptr(), B, H, T, n, D, *strides, scale,
             _build.stream_ptr())
    _build.check(err, "local_attention")
    K.LAUNCHES["local_attention"] += 1
    return out.permute(0, 2, 1, 3)
