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

JAX's previous-window operands are keywords too: ``kp`` (the keys window
w >= 1 reads from window w - 1, default k; the rotary path's keys rotated as
previous-window keys), ``prev_k`` / ``prev_v`` (window 0's previous block,
the left shard's last window under SP) and ``left_edge``. Both kernels take
them as operands and keep their key tiles (see their sources' notes);
``ROUTES["kp"]`` / ``ROUTES["prev_k"]`` count the launches that pass them.

The TPU wrapper folds the causal mask and window 0's missing previous block
into two stored additive planes, ``bias + mask``, indexed by min(w, 1). This
kernel adds the same bias and applies the same two masks from the indices
(key j of [prev | cur] is valid iff j <= n + i, and j >= n in window 0), so
it reads no mask planes. A masked key gets weight 0, as NEG_INF does in the
plain version.

Heads are read in place: q, k and v may be any (B, H, T, D) views whose last
dim is contiguous (the head split of a (B, T, 3 H D) projection is one); the
wrapper raises on any other view and never copies. The output
is written as (B, T, H, D) and returned as its (B, H, T, D) permuted view, so
the caller's merge of the heads is a view too.

Bound on the H100, design (flash-attention style: 3xTF32 mma.sync for both
products, online softmax in registers, the table column in shared memory)
and how P moves between the two products: the note at the head of
``csrc/local_attention.cu``. No SDPA, no cuDNN, no cuBLAS.

Head dims and views (:func:`fast_takes`, the shape rule the launch
applies): the two tensor-core kernels take D a multiple of 4 up to
``MAX_HEAD_DIM`` (128), the K loop of S = q K^T in steps of 8 (fp32) or 16
(bf16) and O in D / 8 n8 tiles, on views whose B / H / T strides are
multiples of 4 elements and whose data is 16-byte (fp32) or 8-byte (bf16)
aligned. Every other head dim and view, as the JAX kernel takes them (its
BlockSpecs hold the whole D, ``l3ac_tpu/ops/pallas/local_attention.py:
178-187``), runs the general route of ``csrc/general.cu``
(``l3ac_general_attention``): the fast kernels' design without their
instantiation limits, both products on the tensor cores (fp32 3xTF32,
bf16 one m16n8k16 pass), an online softmax, S over D in chunks of
64 columns and O in registers up to 256 columns (wider: slabs of O's
columns, one block each, :func:`general_slabs`), rows staged by 16-byte
or 4-byte cp.async or, for bf16 at odd offsets, element by element, so any
D and any element strides, with the same operands (bias or table, ``kp``,
``prev_k`` / ``prev_v``, ``left_edge``, ``head_offset``; the TP mode reads
a contiguous copy of its heads' table columns in both dtypes there). In
bf16 it takes a first pass over the keys for each row's max and sum, and
rounds the normalized P to bf16 where the bf16 plain version does.
``ROUTES["general"]`` counts its launches, ``GENERAL_INSTANCES`` them by
O's tiles. :func:`admits` refuses only D < 1.

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

Tensor-parallel mode (``head_offset``, ``parallel.tp``): q, k, v hold a
rank's heads, H = heads / tp of them, views of the rank's qkv shard (its
T stride 3 H D); the bias table (or the full bias) is the model's whole
one, and the heads [head_offset, head_offset + H) of it apply. The fp32
kernel reads the rank's columns as a contiguous (2n, H) copy (2n H floats a
call), the bf16 kernel its rows of the prepared (heads, 2n) table in place.
``K.TP_LAUNCHES["local_attention"]`` counts these launches.

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
# launches of the bf16 kernel per route, and of either kernel with the
# previous-window operands: "kp" (the rotary path's previous-role keys) and
# "prev_k" (window 0's previous block, the SP path); and the bf16 launches
# per instantiation (the columns of the padded head dim it runs, :func:`instance_for`)
ROUTES: dict[str, int] = dict.fromkeys((*ROUTE_CODE, "kp", "prev_k", "general"), 0)
INSTANCES: dict[int, int] = dict.fromkeys((16, 32, 64, 128), 0)
# the general route (csrc/general.cu): O's n8 tiles a block holds in
# registers, at most GENERAL_MAX_TILES (256 columns); its launches per
# instantiation
GENERAL_TILES = (2, 4, 8, 16, 24, 32)
GENERAL_MAX_TILES = GENERAL_TILES[-1]
GENERAL_INSTANCES: dict[int, int] = dict.fromkeys(GENERAL_TILES, 0)

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 +
             [ctypes.c_float, ctypes.c_void_p])
_ARGTYPES_BF16 = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 +
                  [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_GENERAL_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 +
                     [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])


def _strides(t: torch.Tensor, name: str) -> tuple[list[int], int]:
    """The B, H, T element strides the kernels take for a (B, H, T, D) view
    (0 for a dim of size 1) and its data address; raises on a view whose
    last dim is not contiguous (no kernel reads it in place)."""
    st, sh, ptr = t.stride(), t.shape, t.data_ptr()
    if sh[3] > 1 and st[3] != 1:
        raise ValueError(f"local_attention: {name}'s last dim is not contiguous "
                         f"(strides {st}); the kernel does not copy")
    return [st[0] if sh[0] > 1 else 0, st[1] if sh[1] > 1 else 0, st[2] if sh[2] > 1 else 0], ptr


def fast_takes(D: int, strides: list[int], ptrs: list[int], element_size: int) -> bool:
    """Whether the tensor-core kernel of this dtype takes head dim D on views
    with these B / H / T element strides and data addresses: D a multiple
    of ALIGN up to MAX_HEAD_DIM, every stride a multiple of ALIGN and every
    address aligned to ALIGN elements. Else the general route runs."""
    piece = ALIGN * element_size
    return (ALIGN <= D <= MAX_HEAD_DIM and D % ALIGN == 0
            and all(s % ALIGN == 0 for s in strides) and all(p % piece == 0 for p in ptrs))


@functools.lru_cache(maxsize=None)
def _bf16_scale(D: int) -> float:
    """D^-1/2 rounded to bf16: the scale as the plain version takes it."""
    return float(torch.tensor(D ** -0.5, dtype=torch.bfloat16))


def admits(D: int) -> str | None:
    """Why no kernel takes head dim D, or None when one does: every D >= 1
    (:func:`fast_takes` names the kernel)."""
    return None if D >= 1 else f"local_attention: the kernel takes D >= 1, got {D}"


def route_for(strides: list[int], ptrs: list[int]) -> str:
    """The bf16 kernel's loader for q, k, v (and kp, prev_k, prev_v where
    given) with these B / H / T element strides (0 for a dim of extent 1)
    and data addresses: ``"tma"`` when every stride is a multiple of 8
    elements and every address 16-byte aligned, else ``"cp_async"``."""
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


def general_slabs(D: int) -> tuple[int, int]:
    """(n8 tiles of O a block holds, slabs of O's columns) of the general
    attention at head dim D, the host twin of ``general.cu:launch_attention``:
    D's n8 tiles split into the fewest slabs of at most GENERAL_MAX_TILES, the
    instantiation at or above a slab's share; one block per slab (S is
    computed once per slab: more than one only past D = 256)."""
    d8 = -(-D // 8)
    slabs = -(-d8 // GENERAL_MAX_TILES)
    per = -(-d8 // slabs)
    tiles = next(t for t in GENERAL_TILES if per <= t)
    return tiles, -(-d8 // tiles)


def general_work_item(idx: int, n: int, W: int, BH: int, slabs: int) -> tuple[int, int, int, int]:
    """Host twin of the general attention's block order (``general.cu``:
    ``attention_kernel``): block idx as (first query row, window, slab,
    batch * head), longest first: the windows w >= 1, then window 0, each
    from the last query tile of 64 rows to the first."""
    nq = -(-n // 64)
    per = slabs * BH
    rest = (W - 1) * per
    if idx < nq * rest:
        qt, r = nq - 1 - idx // rest, idx % rest
        w, r = 1 + r // per, r % per
    else:
        j = idx - nq * rest
        qt, r, w = nq - 1 - j // per, j % per, 0
    return 64 * qt, w, r // BH, r % BH


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
                    bias_table: torch.Tensor | None = None, kp: torch.Tensor | None = None,
                    prev_k: torch.Tensor | None = None, prev_v: torch.Tensor | None = None,
                    left_edge: int | None = None,
                    head_offset: int | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D) views, T a multiple of window_size; bias
    (H, n, 2n), or bias_table (2n, H), or neither. Returns (B, H, T, D), on
    CUDA a permuted view of a (B, T, H, D) tensor. Kernel on CUDA (under
    autograd through ``autograd.call``, with a gradient for q, k, v, kp,
    prev_k, prev_v and the bias or its table), plain on CPU.

    The previous-window operands of JAX's kernel (``_attn_kernel``'s kp /
    kp0 / vp0 refs): ``kp`` (B, H, T, D), a view like k, the keys window w
    >= 1 reads from window w - 1 as its previous half (default k; the rotary
    path passes the keys rotated as previous-window keys); ``prev_k`` /
    ``prev_v`` (B, H, n, D) contiguous, window 0's previous half (SP: the
    left shard's last window); ``left_edge`` 1 masks that half all the same
    (the globally first shard). Without ``prev_k`` window 0's previous half
    is masked, as before. ``head_offset``: the tensor-parallel mode (q, k, v
    the heads [head_offset, head_offset + H) of the bias or table given)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("kp", kp), ("prev_k", prev_k),
                    ("prev_v", prev_v)):
        if t is not None:
            K.check_input(t, f"local_attention {name}", ndim=4, dtype=K.DTYPES)
    if bias is not None and bias_table is not None:
        raise ValueError("local_attention: pass bias or bias_table, not both")
    if (prev_k is None) != (prev_v is None):
        raise ValueError("local_attention: prev_k and prev_v go together")
    edge = 0 if left_edge is None else int(left_edge)
    cuda = K.route(q, "local_attention")
    full_table = None
    if head_offset is not None:
        h0, h1 = head_offset, head_offset + q.shape[1]
        for name, t, ax in (("bias", bias, 0), ("bias_table", bias_table, 1)):
            if t is not None and t.shape[ax] < h1:
                raise ValueError(f"local_attention: {name} has {t.shape[ax]} heads, the "
                                 f"shard reads heads {h0}..{h1 - 1}")
        bias = None if bias is None else bias[h0:h1].contiguous()  # rows: a view
        if bias_table is not None and cuda and q.dtype == torch.bfloat16:
            # the bf16 kernel reads the prepared table's rows of these heads
            # in place (and bf16 never differentiates through ``plain``)
            full_table = bias_table
        elif bias_table is not None:
            bias_table = bias_table[:, h0:h1].contiguous()
    if not cuda:
        return local_attention_plain(q, k, v, window_size=window_size, bias=bias,
                                     bias_table=bias_table, kp=kp, prev_k=prev_k,
                                     prev_v=prev_v, left_edge=edge)
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
    if full_table is None and bias_table is not None and bias_table.shape != (2 * n, H):
        raise ValueError(f"local_attention: bias_table {tuple(bias_table.shape)} is not "
                         f"{(2 * n, H)}")
    K.check_cuda({"bias": bias, "bias_table": bias_table, "prev_k": prev_k, "prev_v": prev_v},
                 q.device, dtype=q.dtype)
    for name, t, shape in (("kp", kp, q.shape), ("prev_k", prev_k, (B, H, n, D)),
                           ("prev_v", prev_v, (B, H, n, D))):
        if t is not None and t.shape != shape:
            raise ValueError(f"local_attention: {name} {tuple(t.shape)} is not {tuple(shape)}")
    strides, ptrs = [], []
    for name, t in (("q", q), ("k", k), ("v", v)) + ((("kp", kp),) if kp is not None else ()):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected {q.dtype} on "
                             f"{q.device}")
        st, ptr = _strides(t, name)
        strides += st
        ptrs.append(ptr)
    prev = None
    if prev_k is not None:
        prev = [_strides(t, name)[1] for name, t in (("prev_k", prev_k), ("prev_v", prev_v))]
    prev_strides = [H * n * D if B > 1 else 0, n * D if H > 1 else 0, D] * 2 \
        if prev is not None else []
    general = not fast_takes(D, strides + prev_strides, ptrs + list(prev or []),
                             q.element_size())

    extra = {} if prev is None and not edge else {"prev": prev, "left_edge": edge}

    if full_table is not None:
        if general:  # the general kernel reads a contiguous table of the rank's heads
            bias_table = full_table[:, head_offset:head_offset + H].contiguous()
        else:
            extra["table_rows"] = (full_table, head_offset)
    if general:
        extra["general"] = True

    def launch():
        return _launch(q, k, v, bias, bias_table, n, ptrs, strides, **extra)

    def plain(q, k, v, bias, bias_table, kp, prev_k, prev_v):
        return local_attention_plain(q, k, v, window_size=n, bias=bias, bias_table=bias_table,
                                     kp=kp, prev_k=prev_k, prev_v=prev_v,
                                     left_edge=edge).permute(0, 2, 1, 3)

    out = autograd.call("local_attention", launch, plain, q, k, v, bias, bias_table, kp,
                        prev_k, prev_v)
    K.LAUNCHES["local_attention"] += 1
    if kp is not None:
        ROUTES["kp"] += 1
    if prev_k is not None:
        ROUTES["prev_k"] += 1
    if head_offset is not None:
        K.TP_LAUNCHES["local_attention"] += 1
    return out.permute(0, 2, 1, 3)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
            bias_table: torch.Tensor | None, n: int, ptrs: list[int], strides: list[int],
            prev: list[int] | None = None, left_edge: int = 0,
            table_rows: tuple[torch.Tensor, int] | None = None,
            general: bool = False) -> torch.Tensor:
    """The kernel of q's dtype on operands :func:`local_attention` checked
    (``ptrs`` / ``strides`` of q, k, v and kp when given; ``prev`` the
    addresses of prev_k and prev_v, contiguous (B, H, n, D), or None) ->
    (B, T, H, D). ``table_rows``: the TP mode's (whole table, first head),
    whose prepared rows the bf16 kernel reads in place. ``general``: the
    general route of ``csrc/general.cu`` (either dtype)."""
    B, H, T, D = q.shape
    out = torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    pk, pv = prev if prev is not None else (None, None)
    kp = ptrs[3] if len(ptrs) > 3 else None
    args = (*ptrs[:3], kp, pk, pv)
    kp_strides = strides[9:12] if kp is not None else [0, 0, 0]
    if general:
        bf16 = q.dtype == torch.bfloat16
        st = (ctypes.c_longlong * 12)(*strides[:9], *kp_strides)
        fn = _build.function("l3ac_general_attention", _GENERAL_ARGTYPES)
        err = fn(*args, _build.ptr(bias), _build.ptr(bias_table), out.data_ptr(), B, H, T, n, D,
                 left_edge, st, int(bf16), _bf16_scale(D) if bf16 else D ** -0.5,
                 _build.stream_ptr())
        _build.check(err, "local_attention")
        ROUTES["general"] += 1
        GENERAL_INSTANCES[general_slabs(D)[0]] += 1
    elif q.dtype == torch.bfloat16:
        prev_strides = [H * n * D if B > 1 else 0, n * D if H > 1 else 0, D] * 2 \
            if prev is not None else []
        route = route_for(strides + prev_strides, ptrs + list(prev or []))
        if table_rows is not None:
            full, h0 = table_rows
            table = prepared_table(full)[h0:h0 + H]
        else:
            table = None if bias_table is None else prepared_table(bias_table)
        fn = _build.function("l3ac_local_attention_bf16", _ARGTYPES_BF16)
        err = fn(*args, _build.ptr(bias), _build.ptr(table), out.data_ptr(), B, H, T, n, D,
                 left_edge, *strides[:9], *kp_strides, _bf16_scale(D), ROUTE_CODE[route],
                 _build.stream_ptr())
        _build.check(err, "local_attention")
        ROUTES[route] += 1
        INSTANCES[instance_for(D)] += 1
    else:
        fn = _build.function("l3ac_local_attention", _ARGTYPES)
        err = fn(*args, _build.ptr(bias), _build.ptr(bias_table), out.data_ptr(), B, H, T, n, D,
                 left_edge, *strides[:9], *kp_strides, D ** -0.5, _build.stream_ptr())
        _build.check(err, "local_attention")
    return out
