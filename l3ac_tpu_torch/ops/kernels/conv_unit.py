"""Residual ConvUnit in both activation layouts:
``x + pw2(GRN(act(pw1(ChannelNorm(dwconv_k(x))))))``.

Replaces ``l3ac_tpu/ops/pallas/conv_unit.py:conv_unit_ct`` (body
``_kernel_t``, (B, C, T)) and ``:conv_unit`` (body ``_kernel``, (B, T, C))
with three kernels, chosen by a shape rule, never by a retry:

- ``csrc/conv_unit_narrow.cu`` for ``conv_unit_ct`` at every C up to
  ``NARROW_MAX_C`` (96): the codec's (B, C, T) widths 24, 48, 96 and
  ``debug``'s 8, 12, 16. One fused launch: the depthwise conv and
  ChannelNorm into shared memory, then both products on the tensor cores
  (3xTF32, mma.sync), the hidden activation one chunk of 32 units at a time
  in shared memory, never in device memory.
- ``csrc/conv_unit_tc.cu`` for ``conv_unit`` when C is a multiple of
  ``TC_MULTIPLE`` (64): every released config's channels-last widths (192,
  256, 512). Three launches: depthwise conv + ChannelNorm, then the two
  products on the tensor-core GEMM core (``csrc/tc_gemm.cuh``, 3xTF32) with
  the activation and the residual in their epilogues.
- ``csrc/conv_unit.cu``, one fused SIMT kernel, for ``conv_unit`` at any
  other C (``debug``'s 16). ``conv_unit_simt`` also runs it on (B, C, T),
  where it is only timed beside the narrow kernel.

Widths: ``conv_unit`` takes C <= ``TC_MAX_C`` (1024) on the tensor-core
route and C <= ``MAX_C`` (512) on the SIMT route; ``conv_unit_ct`` C <=
``NARROW_MAX_C``. :func:`admits` is the one shape rule, for the launch and
for a walk of a model.

bf16 (the encode half of ROADMAP A6): both wrappers take bf16 x with a bf16
unit. ``conv_unit_ct`` runs ``csrc/conv_unit_narrow_bf16.cu`` (a persistent
kernel holding the unit's weights in shared memory, each product one bf16
mma.sync pass, its operands one buffer from :func:`narrow_pack`) and
``conv_unit`` the bf16 path of
``csrc/conv_unit_tc.cu`` (C % 8 == 0, so ``debug``'s 16 too; another C
raises on the card): a depthwise conv + norm pass that stages its time rows
and halo in shared memory, then both products on the wgmma core
(``csrc/gemm_sm90.cuh``, ``ops/kernels/gemm_sm90.py``: TMA ring, producer
warp, fp32 sums in one accumulator across K), each product's route from
``gemm_sm90.route_for`` and W1's / W2''s tensor maps from
``gemm_sm90.weight_map`` (built once, cached on the prepared weights). They round where
``l3ac_tpu/ops/pallas/conv_unit.py`` does: the depthwise conv, the norm and
the activation in fp32; pw1's operand rounded to bf16 (:126), the hidden
activation rounded to bf16 (:136), the residual added in fp32 and the sum
rounded once (:139); GRN folded into pw2 in fp32 from the bf16 parameters,
W2' then rounded to bf16 (:188-192), b2' kept in fp32. Their operands come
prepared once per weight set (:class:`PreparedBf16`); the plain version
(:func:`conv_unit_plain_bf16`) rounds at the same points.

The two tensor-core kernels take their product weights prepared once per
weight set (:func:`prepared_weights`).

GRN fold: the reference's GRN norm is a per-batch scalar ``n = g / (g + eps)``
with ``g`` the L2 norm of the whole (4C, T) hidden activation, so
``1 - n <= 1e-8 / g``. The kernels take ``n = 1`` and fold GRN into pw2, as
``conv_unit.py:185-192`` does: ``W2' = W2 * (1 + gamma)`` along the hidden
axis and ``b2' = b2 + W2 @ beta``, in fp32 (:func:`fold_grn`). That removes
the only reduction across time tiles. The plain version keeps the exact GRN;
the two differ by at most ``1e-8 / ||h||`` relative.

Bound on the H100: 16 C^2 + O(C) operations per column against 8 C bytes
moved, so from C = 24 up the products bound it: at the tensor-core passes'
rate (3 TF32 passes at 495 TFLOP/s) the narrow widths sit near the bytes
bound, which is why the narrow kernel keeps the normalized input and the
hidden activation on the SM. The wide tensor-core path writes both to
device memory instead, so that each product is one GEMM at the full tile.
"""

from __future__ import annotations

import ctypes
import weakref
from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..activations import EPS, gelu, snake
from ..norms import channel_norm, grn
from . import _build, autograd, gemm_sm90
from .tc_gemm import split_tf32

MAX_C = 512        # conv_unit, SIMT route: conv_unit.cu's accumulators and shared memory
TC_MAX_C = 1024    # conv_unit, tensor-core route: conv_unit_tc.cu's 32 channels per lane
TC_MULTIPLE = 64   # conv_unit at C % 64 == 0 runs conv_unit_tc.cu, other C conv_unit.cu
BF16_MULTIPLE = 8  # bf16 conv_unit: conv_unit_tc.cu's bf16 path at every C % 8 == 0
NARROW_MAX_C = 96  # conv_unit_ct: conv_unit_narrow.cu's 12 n8 tiles of the second product


class ConvUnitWeights(NamedTuple):
    dw_w: torch.Tensor            # (C, 1, K) depthwise conv
    dw_b: torch.Tensor            # (C,)
    norm_w: torch.Tensor | None   # (C,) ChannelNorm, or None without norm
    norm_b: torch.Tensor | None
    pw1_w: torch.Tensor | None    # (4C, C) nn.Linear layout; None where unit_body
                                  # gets the products as callables
    pw1_b: torch.Tensor           # (4C,)
    alpha: torch.Tensor | None    # (4C,) snake, or None for exact GELU
    grn_gamma: torch.Tensor       # (4C,)
    grn_beta: torch.Tensor        # (4C,)
    pw2_w: torch.Tensor | None    # (C, 4C); likewise
    pw2_b: torch.Tensor           # (C,)


def unit_body(x: torch.Tensor, w: ConvUnitWeights, pw1: Callable, pw2: Callable, *,
              channel_dim: int, dilation: int = 1) -> torch.Tensor:
    """The unit's step chain without the residual: depthwise conv ->
    ChannelNorm -> ``pw1`` -> snake or exact GELU -> exact GRN -> ``pw2``, on
    x (B, C, T) (``channel_dim`` 1) or (B, T, C) (2). The two products are
    callables over that layout; of ``w`` only the other weights are read."""
    k = w.dw_w.shape[-1]
    xt = x if channel_dim == 1 else x.transpose(1, 2)
    y = F.conv1d(xt, w.dw_w, w.dw_b, padding=(k - 1) * dilation // 2,
                 dilation=dilation, groups=xt.shape[1])
    y = y if channel_dim == 1 else y.transpose(1, 2)
    if w.norm_w is not None:
        y = channel_norm(y, w.norm_w, w.norm_b, dim=channel_dim)
    y = pw1(y)
    if w.alpha is not None:
        y = snake(y, w.alpha[:, None] if channel_dim == 1 else w.alpha)
    else:
        y = gelu(y)
    return pw2(grn(y, w.grn_gamma, w.grn_beta, dim=channel_dim))


def conv_unit_plain(x: torch.Tensor, w: ConvUnitWeights, *, channel_dim: int,
                    dilation: int = 1) -> torch.Tensor:
    """The residual unit in plain PyTorch, with the exact GRN. ``channel_dim``
    is 1 for (B, C, T) and 2 for (B, T, C)."""
    xt = x if channel_dim == 1 else x.transpose(1, 2)
    y = unit_body(xt, w,
                  lambda h: torch.einsum("oc,bct->bot", w.pw1_w, h) + w.pw1_b[:, None],
                  lambda h: torch.einsum("oc,bct->bot", w.pw2_w, h) + w.pw2_b[:, None],
                  channel_dim=1, dilation=dilation)
    out = xt + y
    return out if channel_dim == 1 else out.transpose(1, 2)


def fold_grn(w: ConvUnitWeights) -> tuple[torch.Tensor, torch.Tensor]:
    """(W2' (4C, C), b2' (C,)): pw2 with GRN (n = 1) folded in, fp32 (from
    bf16 parameters too)."""
    w2t = w.pw2_w.float().t()                                  # (4C, C)
    w2f = (w2t * (1.0 + w.grn_gamma.float())[:, None]).contiguous()
    b2f = (w.pw2_b.float() + w.grn_beta.float() @ w2t).contiguous()
    return w2f, b2f


class PreparedBf16(NamedTuple):
    """The bf16 kernels' operands: the two products in bf16, every vector in
    fp32 (the bf16 parameters' values), on the weights' device; at C <=
    NARROW_MAX_C also the narrow kernel's one buffer (:func:`narrow_pack`)."""
    dw: torch.Tensor              # (C, K) depthwise conv
    dw_b: torch.Tensor            # (C,)
    norm_w: torch.Tensor | None   # (C,) or None
    norm_b: torch.Tensor | None
    w1: torch.Tensor              # (4C, C) bf16, pw1 (nn.Linear layout)
    b1: torch.Tensor              # (4C,)
    alpha: torch.Tensor | None    # (4C,) snake, or None for exact GELU
    w2: torch.Tensor              # (C, 4C) bf16, W2' = pw2 with GRN folded (fold_grn), rounded
    b2: torch.Tensor              # (C,) b2', fp32
    narrow: torch.Tensor | None = None  # uint8, narrow_pack of the fields above


def prepare_bf16(w: ConvUnitWeights) -> PreparedBf16:
    """:class:`PreparedBf16` from a bf16 unit's weights."""
    f = lambda t: None if t is None else t.detach().float().contiguous()
    with torch.no_grad():
        w2f, b2f = fold_grn(w)
        p = PreparedBf16(f(w.dw_w[:, 0, :]), f(w.dw_b), f(w.norm_w), f(w.norm_b),
                         w.pw1_w.detach().bfloat16().contiguous(), f(w.pw1_b), f(w.alpha),
                         w2f.t().contiguous().bfloat16(), b2f)
        return p._replace(narrow=narrow_pack(p)) if p.dw.shape[0] <= NARROW_MAX_C else p


NARROW_STEP = 32  # conv_unit_narrow_bf16.cu: hidden units a step (kStep)


def narrow_shape(C: int) -> tuple[int, int]:
    """(kP, steps) of the narrow bf16 kernel at C channels: k16 steps of pw1
    (n8 pairs of pw2), and hidden steps of NARROW_STEP units."""
    return -(-C // 16), -(-4 * C // NARROW_STEP)


def narrow_packed_bytes(C: int, K: int) -> int:
    """The bytes of :func:`narrow_pack`'s buffer (the kernel's ``Packed``)."""
    kP, steps = narrow_shape(C)
    return 2 * 2 * (steps * NARROW_STEP) * (16 * kP) + 16 * steps * NARROW_STEP + \
        4 * (K + 4) * 16 * kP


def narrow_pack(p: PreparedBf16) -> torch.Tensor:
    """The narrow bf16 kernel's one buffer (uint8, on p's device), in the
    order of its shared-memory image (``csrc/conv_unit_narrow_bf16.cu``):

    - W1 (4C, C) zero-filled to (32 steps, 16 kP), bf16 in B-fragment order:
      for each pair pp of n8 tiles (16 hidden units), k16 step ks and lane
      4 g + t, the 8 values W1[16 pp + 8 s + g][16 ks + 8 h + 2 t + e] in
      the order (s, h, e): one 16-byte load gives two n8 tiles' fragments;
    - W2' (C, 4C) zero-filled to (16 kP, 32 steps) the same way: per k16
      step kh over the hidden units and pair p of n8 output tiles,
      W2'[16 p + 8 s + g][16 kh + 8 h + 2 t + e];
    - per hidden unit (32 steps of them) fp32 b1, alpha, alpha + eps and the
      correctly rounded 1 / (alpha + eps) (padding: 0, 1, 1 + eps and its
      reciprocal; the alpha fields are unused under GELU);
    - fp32 (K + 4, 16 kP): the depthwise taps (K, C) transposed, then dw_b,
      norm_w, norm_b (zero without norm) and b2', zero past C."""
    C, K = p.dw.shape
    kP, steps = narrow_shape(C)
    Cp, H = 16 * kP, NARROW_STEP * steps
    w1 = p.w1.new_zeros(H, Cp)
    w1[:4 * C, :C] = p.w1
    f1 = w1.view(2 * steps, 2, 8, kP, 2, 4, 2).permute(0, 3, 2, 5, 1, 4, 6)
    w2 = p.w2.new_zeros(Cp, H)
    w2[:C, :4 * C] = p.w2
    f2 = w2.view(kP, 2, 8, 2 * steps, 2, 4, 2).permute(3, 0, 2, 5, 1, 4, 6)
    alpha = p.b1.new_ones(H)
    if p.alpha is not None:
        alpha[:4 * C] = p.alpha
    d = alpha + EPS
    hv = torch.stack([F.pad(p.b1, (0, H - 4 * C)), alpha, d, 1.0 / d], 1)
    cv = p.b1.new_zeros(K + 4, Cp)
    cv[:K, :C] = p.dw.t()
    for i, v in enumerate((p.dw_b, p.norm_w, p.norm_b, p.b2)):
        if v is not None:
            cv[K + i, :C] = v
    parts = [f1.contiguous().view(torch.uint8), f2.contiguous().view(torch.uint8),
             hv.view(torch.uint8), cv.view(torch.uint8)]
    return torch.cat([t.reshape(-1) for t in parts])


def conv_unit_plain_bf16(x: torch.Tensor, w: ConvUnitWeights | PreparedBf16, *,
                         channel_dim: int, dilation: int = 1) -> torch.Tensor:
    """The bf16 kernels' function in plain PyTorch, rounding where they do:
    fp32 depthwise conv, norm and activation, bf16 product operands with
    fp32 sums, GRN folded, the residual added in fp32 and rounded once."""
    p = w if isinstance(w, PreparedBf16) else prepare_bf16(w)
    xt = (x if channel_dim == 1 else x.transpose(1, 2)).float()
    k = p.dw.shape[-1]
    y = F.conv1d(xt, p.dw[:, None, :], p.dw_b, padding=(k - 1) * dilation // 2,
                 dilation=dilation, groups=xt.shape[1])
    if p.norm_w is not None:
        y = channel_norm(y, p.norm_w, p.norm_b, dim=1)
    h = torch.einsum("oc,bct->bot", p.w1.float(), y.bfloat16().float()) + p.b1[:, None]
    h = snake(h, p.alpha[:, None]) if p.alpha is not None else gelu(h)
    y = torch.einsum("oc,bct->bot", p.w2.float(), h.bfloat16().float()) + p.b2[:, None]
    out = (xt + y).to(x.dtype)
    return out if channel_dim == 1 else out.transpose(1, 2)


class PreparedWeights(NamedTuple):
    """The tensor-core kernels' product operands, fp32 on the weights' device."""
    b2: torch.Tensor      # (C,) b2' (fold_grn)
    w1_hi: torch.Tensor   # (4C, C) pw1 split into TF32 (split_tf32)
    w1_lo: torch.Tensor
    w2_hi: torch.Tensor   # (C, 4C) W2': pw2 with GRN folded (fold_grn, transposed), split
    w2_lo: torch.Tensor


def prepare_weights(w: ConvUnitWeights) -> PreparedWeights | PreparedBf16:
    """W1 and W2' in K-major (nn.Linear) layout, split into TF32 hi / lo, and
    b2'. pw1 is K-major already; W2' is ``fold_grn``'s (4C, C) result
    transposed. A bf16 unit's operands are :func:`prepare_bf16`'s."""
    if w.pw1_w.dtype == torch.bfloat16:
        return prepare_bf16(w)
    with torch.no_grad():
        w2f, b2f = fold_grn(w)
        return PreparedWeights(b2f, *split_tf32(w.pw1_w), *split_tf32(w2f.t().contiguous()))


# id(owner) -> ((data_ptr, _version) of each source, weak references to the
# sources, PreparedWeights). Kept here, not on the tensor, so that the weights
# still pickle; an entry goes when its owner is freed.
_PREPARED: dict[int, tuple] = {}


def cached_prepare(owner: torch.Tensor, src: tuple[torch.Tensor, ...],
                   build: Callable[[], PreparedWeights], store: dict | None = None
                   ) -> PreparedWeights:
    """``build()``, cached under ``owner`` in ``store`` (default: the
    prepared weights' own dict) and rebuilt whenever a tensor of
    ``src`` is another object or has changed in place (``load_state_dict``,
    ``mul_``, ...: each bumps its ``_version``) or has another dtype (a model
    moved with ``.to(torch.bfloat16)``), so no stale weight is used.
    A source that is an inference tensor has no version counter, and its
    in-place changes cannot be seen: such a set is built on every call and
    never cached."""
    if any(t.is_inference() for t in src):
        return build()
    store = _PREPARED if store is None else store
    key = tuple((t.data_ptr(), t._version, t.dtype) for t in src)
    slot = id(owner)
    hit = store.get(slot)
    if hit is not None and hit[0] == key and all(r() is t for r, t in zip(hit[1], src)):
        return hit[2]
    prep = build()
    if hit is None:
        weakref.finalize(owner, store.pop, slot, None)
    store[slot] = (key, tuple(weakref.ref(t) for t in src), prep)
    return prep


def prepared_weights(w: ConvUnitWeights) -> PreparedWeights | PreparedBf16:
    """:func:`prepare_weights`, cached on its sources by
    :func:`cached_prepare`: pw1_w, pw2_w, pw2_b, grn_gamma, grn_beta, and for
    a bf16 unit every other weight too (:class:`PreparedBf16` holds them)."""
    src = ((w.pw1_w, w.pw2_w, w.pw2_b, w.grn_gamma, w.grn_beta)
           if w.pw1_w.dtype != torch.bfloat16 else tuple(t for t in w if t is not None))
    return cached_prepare(w.pw1_w, src, lambda: prepare_weights(w))


def admits(name: str, C: int, dtype: torch.dtype = torch.float32) -> str | None:
    """Why the CUDA route of ``name`` (``"conv_unit"`` or ``"conv_unit_ct"``)
    does not take width C in ``dtype``, or None when it does. The launch
    raises with this reason."""
    if name == "conv_unit_ct":
        if not 1 <= C <= NARROW_MAX_C:
            return f"conv_unit_ct: C = {C} outside 1..{NARROW_MAX_C}"
        return None
    if C % TC_MULTIPLE == 0 or (dtype == torch.bfloat16 and C % BF16_MULTIPLE == 0):
        return None if 1 <= C <= TC_MAX_C else \
            f"conv_unit: C = {C} outside 1..{TC_MAX_C} (tensor-core route)"
    if dtype == torch.bfloat16:
        return (f"conv_unit: bf16 runs on the tensor-core route only, C a multiple of "
                f"{BF16_MULTIPLE}; got C = {C}")
    return None if 1 <= C <= MAX_C else f"conv_unit: C = {C} outside 1..{MAX_C} (SIMT route)"


def _check_weights(w: ConvUnitWeights, C: int, name: str, max_c: int = MAX_C) -> int:
    ksz = w.dw_w.shape[-1]
    if not 1 <= C <= max_c:
        raise ValueError(f"{name}: C = {C} outside 1..{max_c}")
    if w.dw_w.shape != (C, 1, ksz) or ksz % 2 == 0 or \
            w.pw1_w.shape != (4 * C, C) or w.pw2_w.shape != (C, 4 * C):
        raise ValueError(f"{name}: weight shapes do not match C = {C}")
    if (w.norm_w is None) != (w.norm_b is None):
        raise ValueError(f"{name}: norm weight and bias go together")
    return ksz


_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 +
             [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def conv_unit_simt(x: torch.Tensor, w: ConvUnitWeights, dilation: int = 1, *,
                   channels_last: bool, name: str = "conv_unit") -> torch.Tensor:
    """Launch ``csrc/conv_unit.cu`` on a CUDA tensor, (B, T, C) or (B, C, T);
    counts no launch (the wrapper counts). ``conv_unit``'s kernel at C not a
    multiple of 64; on (B, C, T) it is only timed beside the narrow kernel."""
    B = x.shape[0]
    C, T = (x.shape[2], x.shape[1]) if channels_last else (x.shape[1], x.shape[2])
    ksz = _check_weights(w, C, name)
    dw = w.dw_w[:, 0, :].contiguous()                          # (C, K)
    w1t = w.pw1_w.t().contiguous()                             # (C, 4C)
    w2f, b2f = fold_grn(w)
    ops = {"x": x, "dw": dw, "dw_b": w.dw_b, "norm_w": w.norm_w,
           "norm_b": w.norm_b, "w1t": w1t, "pw1_b": w.pw1_b,
           "alpha": w.alpha, "w2f": w2f, "b2f": b2f}
    K.check_cuda(ops, x.device)
    out = torch.empty_like(x)
    sB = x.stride(0)
    sC, sT = (1, C) if channels_last else (T, 1)
    fn = _build.function("l3ac_conv_unit", _ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), dw.data_ptr(), w.dw_b.data_ptr(),
             _build.ptr(w.norm_w), _build.ptr(w.norm_b), w1t.data_ptr(),
             w.pw1_b.data_ptr(), _build.ptr(w.alpha), w2f.data_ptr(),
             b2f.data_ptr(), B, C, T, ksz, dilation, sB, sC, sT,
             _build.stream_ptr())
    _build.check(err, name)
    return out


_TC_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch_tc(x: torch.Tensor, w: ConvUnitWeights, dilation: int) -> torch.Tensor:
    """``csrc/conv_unit_tc.cu`` on (B, T, C), C a multiple of TC_MULTIPLE."""
    B, T, C = x.shape
    ksz = _check_weights(w, C, "conv_unit", TC_MAX_C)
    p = prepared_weights(w)
    dw = w.dw_w[:, 0, :]                                       # (C, K), a view
    ops = {"x": x, "dw": dw, "dw_b": w.dw_b, "norm_w": w.norm_w, "norm_b": w.norm_b,
           "pw1_b": w.pw1_b, "alpha": w.alpha, **p._asdict()}
    K.check_cuda(ops, x.device)
    out = torch.empty_like(x)
    a = torch.empty(B * T, C, device=x.device)
    h = torch.empty(B * T, 4 * C, device=x.device)
    fn = _build.function("l3ac_conv_unit_tc", _TC_ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), a.data_ptr(), h.data_ptr(), dw.data_ptr(),
             w.dw_b.data_ptr(), _build.ptr(w.norm_w), _build.ptr(w.norm_b),
             p.w1_hi.data_ptr(), p.w1_lo.data_ptr(), w.pw1_b.data_ptr(), _build.ptr(w.alpha),
             p.w2_hi.data_ptr(), p.w2_lo.data_ptr(), p.b2.data_ptr(), B, T, C, ksz, dilation,
             _build.stream_ptr())
    _build.check(err, "conv_unit")
    return out


_NARROW_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch_narrow(x: torch.Tensor, w: ConvUnitWeights, p: PreparedWeights,
                   dilation: int) -> torch.Tensor:
    """``csrc/conv_unit_narrow.cu`` on (B, C, T), C <= NARROW_MAX_C; the
    products from ``p``, the other weights from ``w``."""
    B, C, T = x.shape
    ksz = w.dw_w.shape[-1]
    if not 1 <= C <= NARROW_MAX_C:
        raise ValueError(f"conv_unit_ct: C = {C} outside 1..{NARROW_MAX_C}")
    if w.dw_w.shape != (C, 1, ksz) or ksz % 2 == 0 or w.pw1_b.shape != (4 * C,) or \
            p.w1_hi.shape != (4 * C, C) or p.w2_hi.shape != (C, 4 * C):
        raise ValueError(f"conv_unit_ct: weight shapes do not match C = {C}")
    if (w.norm_w is None) != (w.norm_b is None):
        raise ValueError("conv_unit_ct: norm weight and bias go together")
    dw = w.dw_w[:, 0, :]                                       # (C, K), a view
    ops = {"x": x, "dw": dw, "dw_b": w.dw_b, "norm_w": w.norm_w, "norm_b": w.norm_b,
           "pw1_b": w.pw1_b, "alpha": w.alpha, **p._asdict()}
    K.check_cuda(ops, x.device)
    out = torch.empty_like(x)
    fn = _build.function("l3ac_conv_unit_narrow", _NARROW_ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), dw.data_ptr(), w.dw_b.data_ptr(),
             _build.ptr(w.norm_w), _build.ptr(w.norm_b), p.w1_hi.data_ptr(), p.w1_lo.data_ptr(),
             w.pw1_b.data_ptr(), _build.ptr(w.alpha), p.w2_hi.data_ptr(), p.w2_lo.data_ptr(),
             p.b2.data_ptr(), B, C, T, ksz, dilation, _build.stream_ptr())
    _build.check(err, "conv_unit_ct")
    return out


_TC_BF16_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _check_bf16(x: torch.Tensor, p: PreparedBf16, C: int, name: str) -> int:
    ksz = p.dw.shape[-1]
    if p.dw.shape != (C, ksz) or ksz % 2 == 0 or p.w1.shape != (4 * C, C) or \
            p.w2.shape != (C, 4 * C) or p.b1.shape != (4 * C,) or p.b2.shape != (C,):
        raise ValueError(f"{name}: bf16 weight shapes do not match C = {C}")
    if (p.norm_w is None) != (p.norm_b is None):
        raise ValueError(f"{name}: norm weight and bias go together")
    K.check_cuda({"x": x, "w1": p.w1, "w2": p.w2}, x.device, dtype=torch.bfloat16)
    K.check_cuda({"dw": p.dw, "dw_b": p.dw_b, "norm_w": p.norm_w, "norm_b": p.norm_b,
                  "b1": p.b1, "alpha": p.alpha, "b2": p.b2}, x.device)
    return ksz


_NARROW_BF16_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def call_narrow_bf16(fn: Callable, x: torch.Tensor, out: torch.Tensor, p: PreparedBf16,
                     dilation: int) -> int:
    """``fn`` (``l3ac_conv_unit_narrow_bf16`` or a variant of it) on x, out
    (B, C, T) with p's narrow buffer; returns its CUDA error code."""
    B, C, T = x.shape
    return fn(x.data_ptr(), out.data_ptr(), p.narrow.data_ptr(), B, C, T, p.dw.shape[-1],
              dilation, int(p.norm_w is not None), int(p.alpha is not None), _build.stream_ptr())


def _launch_bf16(x: torch.Tensor, p: PreparedBf16, dilation: int, *,
                 channels_last: bool) -> torch.Tensor:
    """The bf16 kernels: ``csrc/conv_unit_narrow_bf16.cu`` on (B, C, T), the
    bf16 path of ``csrc/conv_unit_tc.cu`` on (B, T, C)."""
    name = "conv_unit" if channels_last else "conv_unit_ct"
    B = x.shape[0]
    C, T = (x.shape[2], x.shape[1]) if channels_last else (x.shape[1], x.shape[2])
    why = admits(name, C, torch.bfloat16)
    if why is not None:
        raise ValueError(why)
    ksz = _check_bf16(x, p, C, name)
    out = torch.empty_like(x)
    if channels_last:
        vec = (p.dw.data_ptr(), p.dw_b.data_ptr(), _build.ptr(p.norm_w), _build.ptr(p.norm_b),
               p.w1.data_ptr(), p.b1.data_ptr(), _build.ptr(p.alpha), p.w2.data_ptr(),
               p.b2.data_ptr())
        if x.data_ptr() % 16:
            raise ValueError("conv_unit: bf16 x must be 16-byte aligned")
        M = B * T
        a = torch.empty(M, C, device=x.device, dtype=torch.bfloat16)
        h = torch.empty(M, 4 * C, device=x.device, dtype=torch.bfloat16)
        r1 = gemm_sm90.route_for(M, 4 * C, C, int8=False, a_ptr=a.data_ptr(),
                                 b_ptr=p.w1.data_ptr())
        r2 = gemm_sm90.route_for(M, C, 4 * C, int8=False, a_ptr=h.data_ptr(),
                                 b_ptr=p.w2.data_ptr())
        # the maps stay referenced until the launch has copied them
        maps = [gemm_sm90.weight_map(w) if r == "tma" else None
                for w, r in ((p.w1, r1), (p.w2, r2))]
        fn = _build.function("l3ac_conv_unit_tc_bf16", _TC_BF16_ARGTYPES)
        err = fn(x.data_ptr(), out.data_ptr(), a.data_ptr(), h.data_ptr(), *vec[:5],
                 gemm_sm90.map_ptr(maps[0]), *vec[5:8], gemm_sm90.map_ptr(maps[1]), vec[8],
                 B, T, C, ksz, dilation, gemm_sm90.ROUTE_CODE[r1], gemm_sm90.ROUTE_CODE[r2],
                 _build.stream_ptr())
        _build.check(err, name)
        gemm_sm90.ROUTES[r1] += 1
        gemm_sm90.ROUTES[r2] += 1
        return out
    else:
        if p.narrow is None or p.narrow.shape != (narrow_packed_bytes(C, ksz),):
            raise ValueError(f"{name}: the prepared narrow buffer does not match C = {C}, "
                             f"K = {ksz}")
        K.check_cuda({"narrow": p.narrow}, x.device, dtype=torch.uint8)
        err = call_narrow_bf16(_build.function("l3ac_conv_unit_narrow_bf16",
                                               _NARROW_BF16_ARGTYPES), x, out, p, dilation)
    _build.check(err, name)
    return out


def _plain(channel_dim: int, dilation: int) -> Callable:
    """The fp32 plain version over the flattened inputs (x, *ConvUnitWeights):
    what a training backward differentiates (``autograd.call``)."""
    return lambda x, *ws: conv_unit_plain(x, ConvUnitWeights(*ws), channel_dim=channel_dim,
                                          dilation=dilation)


def _check_trainable(x: torch.Tensor, w: ConvUnitWeights, name: str) -> None:
    if w.pw1_w is None and autograd.needs_grad(x, *w):
        raise TypeError(f"{name}: int8 weight-only units do not train (the JAX package trains "
                        "no int8 model); run them under torch.inference_mode()")


def conv_unit_ct(x: torch.Tensor, w: ConvUnitWeights, *, dilation: int = 1,
                 prepared: Callable[[], PreparedWeights | PreparedBf16] | None = None
                 ) -> torch.Tensor:
    """Residual ConvUnit on (B, C, T), fp32 or bf16. On CUDA the narrow
    tensor-core kernel of x's dtype at C <= NARROW_MAX_C (raises above), its
    operands from ``prepared()`` when given (then ``w`` may leave pw1_w /
    pw2_w out), else from :func:`prepared_weights`; under autograd through
    ``autograd.call`` (the backward differentiates the plain version on
    ``w``, which then holds the dense weights). Plain on the CPU, from
    ``w``'s dense weights."""
    K.check_input(x, "conv_unit_ct x", ndim=3, dtype=K.DTYPES)
    bf16 = x.dtype == torch.bfloat16
    if not K.route(x, "conv_unit_ct"):
        if bf16:
            return conv_unit_plain_bf16(x, w, channel_dim=1, dilation=dilation)
        return conv_unit_plain(x, w, channel_dim=1, dilation=dilation)
    why = admits("conv_unit_ct", x.shape[1], x.dtype)
    if why is not None:
        raise ValueError(why)
    _check_trainable(x, w, "conv_unit_ct")
    p = prepared() if prepared is not None else prepared_weights(w)
    if bf16 != isinstance(p, PreparedBf16):
        raise TypeError(f"conv_unit_ct: x is {x.dtype} but the unit's weights are not")
    if bf16:
        launch = lambda: _launch_bf16(x, p, dilation, channels_last=False)
    else:
        launch = lambda: _launch_narrow(x, w, p, dilation)
    out = autograd.call("conv_unit_ct", launch, _plain(1, dilation), x, *w)
    K.LAUNCHES["conv_unit_ct"] += 1
    return out


def conv_unit(x: torch.Tensor, w: ConvUnitWeights, *,
              dilation: int = 1) -> torch.Tensor:
    """Residual ConvUnit on (B, T, C), fp32 or bf16. On CUDA: the tensor-core
    path when C is a multiple of TC_MULTIPLE (bf16: of BF16_MULTIPLE), else
    (fp32 only) the SIMT kernel; one count either way; under autograd through
    ``autograd.call``. Plain on CPU."""
    K.check_input(x, "conv_unit x", ndim=3, dtype=K.DTYPES)
    bf16 = x.dtype == torch.bfloat16
    if not K.route(x, "conv_unit"):
        if bf16:
            return conv_unit_plain_bf16(x, w, channel_dim=2, dilation=dilation)
        return conv_unit_plain(x, w, channel_dim=2, dilation=dilation)
    why = admits("conv_unit", x.shape[2], x.dtype)
    if why is not None:
        raise ValueError(why)
    _check_trainable(x, w, "conv_unit")
    if bf16:
        p = prepared_weights(w)
        if not isinstance(p, PreparedBf16):
            raise TypeError("conv_unit: x is bf16 but the unit's weights are not")
        launch = lambda: _launch_bf16(x, p, dilation, channels_last=True)
    elif x.shape[2] % TC_MULTIPLE == 0:
        launch = lambda: _launch_tc(x, w, dilation)
    else:
        launch = lambda: conv_unit_simt(x, w, dilation, channels_last=True)
    out = autograd.call("conv_unit", launch, _plain(2, dilation), x, *w)
    K.LAUNCHES["conv_unit"] += 1
    return out
