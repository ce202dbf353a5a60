"""Residual ConvUnit in both activation layouts:
``x + pw2(GRN(act(pw1(ChannelNorm(dwconv_k(x))))))``.

Replaces ``l3ac_tpu/ops/pallas/conv_unit.py:conv_unit_ct`` (body
``_kernel_t``, (B, C, T)) and ``:conv_unit`` (body ``_kernel``, (B, T, C))
with two kernels:

- ``csrc/conv_unit_tc.cu`` for ``conv_unit`` when C is a multiple of
  ``TC_MULTIPLE`` (64): every released config's channels-last widths (192,
  256, 512). Three launches: depthwise conv + ChannelNorm, then the two
  products on the tensor-core GEMM core (``csrc/tc_gemm.cuh``, 3xTF32) with
  the activation and the residual in their epilogues. Its weights come
  prepared once per weight set (:func:`prepared_weights`).
- ``csrc/conv_unit.cu``, one fused SIMT kernel that takes the time and
  channel strides, for ``conv_unit_ct`` and for ``conv_unit`` at any other C
  (``debug``'s 16). The rule is a shape rule, never a retry.

GRN fold: the reference's GRN norm is a per-batch scalar ``n = g / (g + eps)``
with ``g`` the L2 norm of the whole (4C, T) hidden activation, so
``1 - n <= 1e-8 / g``. Both kernels take ``n = 1`` and fold GRN into pw2, as
``conv_unit.py:185-192`` does: ``W2' = W2 * (1 + gamma)`` along the hidden
axis and ``b2' = b2 + W2 @ beta``, in fp32 (:func:`fold_grn`). That removes
the only reduction across time tiles. The plain version keeps the exact GRN;
the two differ by at most ``1e-8 / ||h||`` relative.

Bound on the H100: 16 C^2 + O(C) operations per column against 8 C bytes
moved, so from C = 24 up the products bound it. The SIMT kernel keeps what
the TPU kernel keeps out of device memory: per (batch, column tile) block the
depthwise conv and ChannelNorm go to shared memory, and the (4C, S) hidden
activation exists only one chunk at a time in shared memory, between the
two products (tile S = 64 columns up to C = 192, 32 above). The tensor-core
path writes the normalized input and the hidden activation to device memory
instead, so that each product is one GEMM at the full tile.
"""

from __future__ import annotations

import ctypes
import weakref
from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..activations import gelu, snake
from ..norms import channel_norm, grn
from . import _build
from .tc_gemm import split_tf32

MAX_C = 512        # both kernels: the SIMT one's accumulators, conv_unit_tc's 16 channels per lane
TC_MULTIPLE = 64   # conv_unit at C % 64 == 0 runs conv_unit_tc.cu, other C conv_unit.cu


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
    """(W2' (4C, C), b2' (C,)): pw2 with GRN (n = 1) folded in, fp32."""
    w2t = w.pw2_w.t()                                          # (4C, C)
    w2f = (w2t * (1.0 + w.grn_gamma)[:, None]).contiguous()
    b2f = (w.pw2_b + w.grn_beta @ w2t).contiguous()
    return w2f, b2f


class PreparedWeights(NamedTuple):
    """The tensor-core path's product operands, fp32 on the weights' device."""
    b2: torch.Tensor      # (C,) b2' (fold_grn)
    w1_hi: torch.Tensor   # (4C, C) pw1 split into TF32 (split_tf32)
    w1_lo: torch.Tensor
    w2_hi: torch.Tensor   # (C, 4C) W2': pw2 with GRN folded (fold_grn, transposed), split
    w2_lo: torch.Tensor


def prepare_weights(w: ConvUnitWeights) -> PreparedWeights:
    """W1 and W2' in K-major (nn.Linear) layout, split into TF32 hi / lo, and
    b2'. pw1 is K-major already; W2' is ``fold_grn``'s (4C, C) result
    transposed."""
    with torch.no_grad():
        w2f, b2f = fold_grn(w)
        return PreparedWeights(b2f, *split_tf32(w.pw1_w), *split_tf32(w2f.t().contiguous()))


# id(pw1_w) -> ((data_ptr, _version) of each source, weak references to the
# sources, PreparedWeights). Kept here, not on the tensor, so that the weights
# still pickle; an entry goes when its pw1_w is freed.
_PREPARED: dict[int, tuple] = {}


def prepared_weights(w: ConvUnitWeights) -> PreparedWeights:
    """:func:`prepare_weights`, cached: rebuilt whenever a source tensor
    (pw1_w, pw2_w, pw2_b, grn_gamma, grn_beta) is another object or has
    changed in place (``load_state_dict``, ``mul_``, ...: each bumps its
    ``_version``), so no stale weight is used."""
    src = (w.pw1_w, w.pw2_w, w.pw2_b, w.grn_gamma, w.grn_beta)
    key = tuple((t.data_ptr(), t._version) for t in src)
    slot = id(w.pw1_w)
    hit = _PREPARED.get(slot)
    if hit is not None and hit[0] == key and all(r() is t for r, t in zip(hit[1], src)):
        return hit[2]
    prep = prepare_weights(w)
    if hit is None:
        weakref.finalize(w.pw1_w, _PREPARED.pop, slot, None)
    _PREPARED[slot] = (key, tuple(weakref.ref(t) for t in src), prep)
    return prep


def _check_weights(w: ConvUnitWeights, C: int, name: str) -> int:
    ksz = w.dw_w.shape[-1]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: C = {C} outside 1..{MAX_C}")
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
    counts no launch (the wrappers count). The wrappers' kernel for
    ``conv_unit_ct`` and for ``conv_unit`` at C not a multiple of 64."""
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
    ksz = _check_weights(w, C, "conv_unit")
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


def conv_unit_ct(x: torch.Tensor, w: ConvUnitWeights, *,
                 dilation: int = 1) -> torch.Tensor:
    """Residual ConvUnit on (B, C, T). Kernel on CUDA, plain on CPU."""
    K.check_input(x, "conv_unit_ct x", ndim=3)
    if not K.route(x, "conv_unit_ct"):
        return conv_unit_plain(x, w, channel_dim=1, dilation=dilation)
    out = conv_unit_simt(x, w, dilation, channels_last=False, name="conv_unit_ct")
    K.LAUNCHES["conv_unit_ct"] += 1
    return out


def conv_unit(x: torch.Tensor, w: ConvUnitWeights, *,
              dilation: int = 1) -> torch.Tensor:
    """Residual ConvUnit on (B, T, C). On CUDA: the tensor-core path when C is
    a multiple of TC_MULTIPLE, else the SIMT kernel; one count either way.
    Plain on CPU."""
    K.check_input(x, "conv_unit x", ndim=3)
    if not K.route(x, "conv_unit"):
        return conv_unit_plain(x, w, channel_dim=2, dilation=dilation)
    if x.shape[2] % TC_MULTIPLE == 0:
        out = _launch_tc(x, w, dilation)
    else:
        out = conv_unit_simt(x, w, dilation, channels_last=True)
    K.LAUNCHES["conv_unit"] += 1
    return out
