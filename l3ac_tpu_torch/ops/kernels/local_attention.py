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

bf16: bf16 q / k / v (and a bias or table in bf16) run
``csrc/local_attention_bf16.cu``, designed for the H100: a persistent grid of
(128 query rows, window, batch * head) items, a producer warp that loads K /
V tiles into a ring of swizzled shared memory with full / empty mbarriers,
two consumer warpgroups with both products on wgmma (P in registers as the
A operand of P V) and a softmax in base 2 (``ex2.approx``) whose score is one
fma with the table prepared once in fp32 times log2 e
(:func:`prepare_table`, cached on the table). q is scaled by D^-1/2 in bf16
(the scale rounded to bf16) as the plain version and the JAX kernel do; S,
the bias and the online softmax are fp32; P is rounded to bf16 for P V and
O is written in bf16 after the division by the row sum. The plain version
rounds the normalized P where this kernel rounds 2^(x - m) with the running
max m and divides at the end, and its exp is exact where ex2.approx is
within 2 ulp: P differs by fp32 ulps before its rounding to bf16.

Routes of the bf16 kernel (:func:`route_for`, a shape and alignment rule,
never a fallback): ``"tma"`` where every B / H / T stride of q, k, v is a
multiple of 8 elements and their data 16-byte aligned (TMA loads from 4-D
tensor maps over the head views: the model's (B, T, 3 H D) projection at
every released head dim), else ``"cp_async"`` (the producer warp copies
8-byte pieces into the same layout). :data:`ROUTES` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels as K
from ..attention import local_attention as local_attention_plain
from . import _build, autograd
from .conv_unit import cached_prepare

MAX_HEAD_DIM = 128  # csrc/local_attention.cu: D / 8 n8 tiles of O
ALIGN = 4           # elements: rows are read as pieces of 4 (16 bytes fp32, 8 bf16)
TMA_ALIGN = 8       # elements: the bf16 kernel's TMA route reads 16-byte aligned rows
Q_ROWS = 128        # csrc/local_attention_bf16.cu: query rows of a work item
LOG2E = 1.4426950408889634
ROUTE_CODE = {"tma": 0, "cp_async": 1}
# launches of the bf16 kernel per route, and per instantiation (the columns
# of the padded head dim it runs, :func:`instance_for`)
ROUTES: dict[str, int] = dict.fromkeys(ROUTE_CODE, 0)
INSTANCES: dict[int, int] = dict.fromkeys((16, 32, 64, 128), 0)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 +
             [ctypes.c_float, ctypes.c_void_p])
_ARGTYPES_BF16 = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 +
                  [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _strides(t: torch.Tensor, name: str) -> tuple[list[int], int]:
    """The B, H, T element strides the kernel takes for a (B, H, T, D) view
    (0 for a dim of size 1) and its data address; raises on a view it cannot
    read in place."""
    st, sh, ptr = t.stride(), t.shape, t.data_ptr()
    if sh[3] > 1 and st[3] != 1:
        raise ValueError(f"local_attention: {name}'s last dim is not contiguous "
                         f"(strides {st}); the kernel does not copy")
    out = [st[0] if sh[0] > 1 else 0, st[1] if sh[1] > 1 else 0, st[2] if sh[2] > 1 else 0]
    piece = ALIGN * t.element_size()
    if out[0] % ALIGN or out[1] % ALIGN or out[2] % ALIGN or ptr % piece:
        raise ValueError(f"local_attention: {name} (strides {st}, address "
                         f"{ptr:#x}) is not a view of {piece}-byte aligned rows: "
                         f"its B / H / T strides must be multiples of {ALIGN}")
    return out, ptr


@functools.lru_cache(maxsize=None)
def _bf16_scale(D: int) -> float:
    """D^-1/2 rounded to bf16: the scale as the plain version takes it."""
    return float(torch.tensor(D ** -0.5, dtype=torch.bfloat16))


def admits(D: int) -> str | None:
    """Why the kernel does not take head dim D, or None when it does."""
    if not 1 <= D <= MAX_HEAD_DIM:
        return f"local_attention: the kernel takes D <= {MAX_HEAD_DIM}, got {D}"
    if D % ALIGN:
        return f"local_attention: the kernel takes D a multiple of {ALIGN}, got {D}"
    return None


def route_for(strides: list[int], ptrs: list[int]) -> str:
    """The bf16 kernel's loader for q, k, v with these B / H / T element
    strides (nine, 0 for a dim of extent 1) and data addresses: ``"tma"``
    when every stride is a multiple of 8 elements and every address 16-byte
    aligned, else ``"cp_async"``."""
    for s in strides:
        if s % TMA_ALIGN:
            return "cp_async"
    for p in ptrs:
        if p % 16:
            return "cp_async"
    return "tma"


def instance_for(D: int) -> int:
    """The columns of the bf16 kernel's instantiation that runs head dim D
    (``local_attention_bf16.cu``'s dispatch): D zero-padded to 16, 32, 64
    or 128."""
    return 16 if D <= 16 else 32 if D <= 32 else 64 if D <= 64 else 128


def prepare_table(table: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's table: the (2n, H) position table as (H, 2n) fp32
    times log2 e (one fp32 rounding of the product), so that each head's
    column is contiguous and a score is one fma, s log2 e + tab[h, n + i - j]."""
    return (table.float().t() * LOG2E).contiguous()


_TABLES: dict[int, tuple] = {}


def prepared_table(table: torch.Tensor) -> torch.Tensor:
    """:func:`prepare_table`, cached on the table (rebuilt when it changes)."""
    return cached_prepare(table, (table,), lambda: prepare_table(table), store=_TABLES)


def work_item(idx: int, n: int, W: int, BH: int, H: int) -> tuple[int, int, int, int]:
    """Host twin of the bf16 kernel's work list (``local_attention_bf16.cu:
    work_item``): item idx as (first query row, window, batch, head), longest
    first: the windows w >= 1 (n keys more), then window 0, each from the
    last query tile to the first."""
    nq = -(-n // Q_ROWS)
    rest = (W - 1) * BH
    if idx < nq * rest:
        qt, r = nq - 1 - idx // rest, idx % rest
        w, bh = 1 + r // BH, r % BH
    else:
        j = idx - nq * rest
        qt, w, bh = nq - 1 - j // BH, 0, j % BH
    return qt * Q_ROWS, w, bh // H, bh % H


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window_size: int, bias: torch.Tensor | None = None,
                    bias_table: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D) views, T a multiple of window_size; bias
    (H, n, 2n), or bias_table (2n, H), or neither. Returns (B, H, T, D), on
    CUDA a permuted view of a (B, T, H, D) tensor. Kernel on CUDA (under
    autograd through ``autograd.call``, with a gradient for q, k, v and the
    bias or its table), plain on CPU."""
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
    strides, ptrs = [], []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected {q.dtype} on "
                             f"{q.device}")
        st, ptr = _strides(t, name)
        strides += st
        ptrs.append(ptr)

    def launch():
        return _launch(q, k, v, bias, bias_table, n, ptrs, strides)

    def plain(q, k, v, bias, bias_table):
        return local_attention_plain(q, k, v, window_size=n, bias=bias,
                                     bias_table=bias_table).permute(0, 2, 1, 3)

    out = autograd.call("local_attention", launch, plain, q, k, v, bias, bias_table)
    K.LAUNCHES["local_attention"] += 1
    return out.permute(0, 2, 1, 3)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
            bias_table: torch.Tensor | None, n: int, ptrs: list[int],
            strides: list[int]) -> torch.Tensor:
    """The kernel of q's dtype on operands :func:`local_attention` checked
    (``ptrs`` / ``strides`` of q, k, v) -> (B, T, H, D)."""
    B, H, T, D = q.shape
    out = torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    if q.dtype == torch.bfloat16:
        route = route_for(strides, ptrs)
        table = None if bias_table is None else prepared_table(bias_table)
        fn = _build.function("l3ac_local_attention_bf16", _ARGTYPES_BF16)
        err = fn(*ptrs, _build.ptr(bias), _build.ptr(table), out.data_ptr(), B, H, T, n, D,
                 *strides, _bf16_scale(D), ROUTE_CODE[route], _build.stream_ptr())
        _build.check(err, "local_attention")
        ROUTES[route] += 1
        INSTANCES[instance_for(D)] += 1
    else:
        fn = _build.function("l3ac_local_attention", _ARGTYPES)
        err = fn(*ptrs, _build.ptr(bias), _build.ptr(bias_table), out.data_ptr(), B, H, T, n,
                 D, *strides, D ** -0.5, _build.stream_ptr())
        _build.check(err, "local_attention")
    return out
