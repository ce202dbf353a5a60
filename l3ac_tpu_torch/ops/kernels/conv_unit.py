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

Widths: every C >= 1, as the JAX kernels take (their tile budget scales
with C, ``l3ac_tpu/ops/pallas/conv_unit.py:170-177``; ROADMAP C3).
:func:`route_for` is the one shape rule, for the launch and for a walk of a
model (:func:`admits` refuses only C < 1). The fast routes above take
``conv_unit`` at C % 64 == 0 up to ``TC_MAX_C`` (1024) on the tensor cores
(bf16: C % 8 == 0), the rest of fp32 up to ``MAX_C`` (512) on the SIMT
kernel, and ``conv_unit_ct`` up to ``NARROW_MAX_C`` on the narrow kernels.
Every other width (fp32 C > 512 not a multiple of 64, any C > 1024, bf16
C % 8 != 0, the TP mode off the tensor-core widths) runs the general route
of ``csrc/general.cu``: a depthwise conv + ChannelNorm pass of one block per
row looping over C (the statistics in a first pass), then both products on
the tensor cores through :func:`general_gemm` (its K-major flat operands on
the fast GEMM cores: fp32 ``csrc/tc_gemm.cuh``, 3xTF32 from the TF32 hi / lo
of :class:`PreparedWeights`, any K; bf16 ``csrc/gemm_sm90.cuh`` from
:class:`PreparedBf16`) with the activation, the residual or the TP share in
their epilogues, rounding where the bf16 plain version does.
``ROUTES["general"]`` counts its launches (of both wrappers),
``GEMM_ROUTES`` the general products by core (:func:`gemm_route`: the fast
cores, or ``general.cu``'s own tensor-core product for strided operands, k7
taps, tanh and ``round_mid``).

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

Widths above ``NARROW_MAX_C``: ``conv_unit_ct`` routes a (B, C, T) unit
wider than the narrow kernel onto the channels-last kernels (the JAX
``conv_unit_ct`` has no width limit: its tile budget scales with C,
``l3ac_tpu/ops/pallas/conv_unit.py:170-177``): x and its halos transposed
to (B, T, C), ``conv_unit``'s kernel of x's dtype (C % 64 == 0 in fp32,
C % 8 == 0 in bf16), the result transposed back. It is a route of the
shape rule (:func:`route_for`), counted in ``ROUTES["channels_last"]``
(``ROUTES["narrow"]`` counts the narrow kernel's launches), not a fallback.

Tensor-parallel operand mode (``partial=True``, ``parallel.tp``): the unit's
weights hold a rank's shard of the hidden axis, H = 4C / tp units (pw1's
rows and bias, alpha, GRN's gamma / beta, pw2's columns), and the result is
the shard's share of the unit's sum, ``W2'_r h_r + W2_r beta_r`` in fp32,
with no residual and no pw2 bias: the caller sums the shares over the ranks
and adds the bias and the residual once, a bf16 unit in fp32 with one
rounding of the sum (JAX's rounding point, ``conv_unit.py:139``). The bias
is added after the sum, not by rank 0's share, so that its gradient is the
same on every rank, as every replicated parameter's is. Every kernel takes
the hidden width as a parameter; a shard's prepared operands are
zero-padded to a multiple of ``TP_HIDDEN_MULTIPLE`` hidden units (a zero pw1
row with zero bias, alpha 1, a zero column of W2': exact). The fold stays
exact once summed: ``fold_grn`` of each shard without b2. The plain
versions take the same mode; their exact GRN sums its norm over the tp group
(``ops.norms.grn``). ``K.TP_LAUNCHES`` counts these launches.

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
TP_HIDDEN_MULTIPLE = 8  # a TP shard's hidden units padded to this (W2' rows of 16 / 32 bytes)
# conv_unit_ct's launches by kernel: the narrow kernel, or the channels-last
# kernels above NARROW_MAX_C
ROUTES: dict[str, int] = {"narrow": 0, "channels_last": 0, "general": 0}


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


def _depthwise(xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int,
               lh: torch.Tensor | None, rh: torch.Tensor | None) -> torch.Tensor:
    """The SAME-padded depthwise conv on xt (B, C, T); with halo blocks
    ``lh`` / ``rh`` (B, C, halo) in place of the zero padding (a missing
    one is zeros), unpadded over ``[lh | xt | rh]``."""
    pad = (w.shape[-1] - 1) * dilation // 2
    if lh is None and rh is None:
        return F.conv1d(xt, w, b, padding=pad, dilation=dilation, groups=xt.shape[1])
    z = xt.new_zeros(xt.shape[0], xt.shape[1], pad)
    xp = torch.cat([z if lh is None else lh.to(xt.dtype), xt,
                    z if rh is None else rh.to(xt.dtype)], dim=2)
    return F.conv1d(xp, w, b, dilation=dilation, groups=xt.shape[1])


def _t(h: torch.Tensor | None, channel_dim: int) -> torch.Tensor | None:
    return h if h is None or channel_dim == 1 else h.transpose(1, 2)


def unit_body(x: torch.Tensor, w: ConvUnitWeights, pw1: Callable, pw2: Callable, *,
              channel_dim: int, dilation: int = 1, lh: torch.Tensor | None = None,
              rh: torch.Tensor | None = None, partial: bool = False) -> torch.Tensor:
    """The unit's step chain without the residual: depthwise conv ->
    ChannelNorm -> ``pw1`` -> snake or exact GELU -> exact GRN -> ``pw2``, on
    x (B, C, T) (``channel_dim`` 1) or (B, T, C) (2). The two products are
    callables over that layout; of ``w`` only the other weights are read.
    ``lh`` / ``rh``: SP halo blocks in x's layout, 3 * dilation frames, in
    place of the conv's zero padding (GRN's norm is then summed over the sp
    group by ``ops.norms.grn``). ``partial``: ``w`` holds a tensor-parallel
    shard of the hidden axis, and GRN's norm is summed over the tp group."""
    xt = x if channel_dim == 1 else x.transpose(1, 2)
    y = _depthwise(xt, w.dw_w, w.dw_b, dilation, _t(lh, channel_dim), _t(rh, channel_dim))
    y = y if channel_dim == 1 else y.transpose(1, 2)
    if w.norm_w is not None:
        y = channel_norm(y, w.norm_w, w.norm_b, dim=channel_dim)
    y = pw1(y)
    if w.alpha is not None:
        y = snake(y, w.alpha[:, None] if channel_dim == 1 else w.alpha)
    else:
        y = gelu(y)
    return pw2(grn(y, w.grn_gamma, w.grn_beta, dim=channel_dim, hidden_split=partial))


def conv_unit_plain(x: torch.Tensor, w: ConvUnitWeights, *, channel_dim: int,
                    dilation: int = 1, lh: torch.Tensor | None = None,
                    rh: torch.Tensor | None = None, partial: bool = False) -> torch.Tensor:
    """The residual unit in plain PyTorch, with the exact GRN. ``channel_dim``
    is 1 for (B, C, T) and 2 for (B, T, C); ``lh`` / ``rh`` as
    :func:`unit_body` takes them. ``partial``: the tensor-parallel mode (the
    shard's share: no residual, no pw2 bias)."""
    xt = x if channel_dim == 1 else x.transpose(1, 2)
    b2 = 0.0 if partial else w.pw2_b[:, None]
    y = unit_body(xt, w,
                  lambda h: torch.einsum("oc,bct->bot", w.pw1_w, h) + w.pw1_b[:, None],
                  lambda h: torch.einsum("oc,bct->bot", w.pw2_w, h) + b2,
                  channel_dim=1, dilation=dilation, lh=_t(lh, channel_dim),
                  rh=_t(rh, channel_dim), partial=partial)
    out = y if partial else xt + y
    return out if channel_dim == 1 else out.transpose(1, 2)


def fold_grn(w: ConvUnitWeights, with_bias: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(W2' (4C, C), b2' (C,)): pw2 with GRN (n = 1) folded in, fp32 (from
    bf16 parameters too). ``with_bias=False``: b2' without pw2's bias, a
    tensor-parallel shard's share ``W2_r beta_r``."""
    w2t = w.pw2_w.float().t()                                  # (4C, C)
    w2f = (w2t * (1.0 + w.grn_gamma.float())[:, None]).contiguous()
    b2f = w.grn_beta.float() @ w2t
    b2f = (w.pw2_b.float() + b2f if with_bias else b2f).contiguous()
    return w2f, b2f


def pad_hidden(w: ConvUnitWeights, multiple: int = TP_HIDDEN_MULTIPLE) -> ConvUnitWeights:
    """``w`` with its hidden axis zero-padded to a multiple of ``multiple``
    units (pw1 rows and bias 0, alpha 1, gamma and beta 0, pw2 columns 0),
    which leaves the unit's function as it is; ``w`` itself where it fits."""
    pad = (-w.pw1_w.shape[0]) % multiple
    if not pad:
        return w
    z = lambda v, fill=0.0: None if v is None else F.pad(v, (0, pad), value=fill)
    return w._replace(pw1_w=F.pad(w.pw1_w, (0, 0, 0, pad)), pw1_b=z(w.pw1_b),
                      alpha=z(w.alpha, 1.0), grn_gamma=z(w.grn_gamma),
                      grn_beta=z(w.grn_beta), pw2_w=F.pad(w.pw2_w, (0, pad)))


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


def prepare_bf16(w: ConvUnitWeights, partial: bool = False) -> PreparedBf16:
    """:class:`PreparedBf16` from a bf16 unit's weights; ``partial``: of a
    tensor-parallel shard (:func:`pad_hidden`, b2' without pw2's bias)."""
    f = lambda t: None if t is None else t.detach().float().contiguous()
    with torch.no_grad():
        if partial:
            w = pad_hidden(w)
        w2f, b2f = fold_grn(w, with_bias=not partial)
        p = PreparedBf16(f(w.dw_w[:, 0, :]), f(w.dw_b), f(w.norm_w), f(w.norm_b),
                         w.pw1_w.detach().bfloat16().contiguous(), f(w.pw1_b), f(w.alpha),
                         w2f.t().contiguous().bfloat16(), b2f)
        return p._replace(narrow=narrow_pack(p)) if p.dw.shape[0] <= NARROW_MAX_C else p


NARROW_STEP = 32  # conv_unit_narrow_bf16.cu: hidden units a step (kStep)


def narrow_shape(C: int, H: int | None = None) -> tuple[int, int]:
    """(kP, steps) of the narrow bf16 kernel at C channels and H hidden
    units (default 4C): k16 steps of pw1 (n8 pairs of pw2), and hidden steps
    of NARROW_STEP units."""
    return -(-C // 16), -(-(4 * C if H is None else H) // NARROW_STEP)


def narrow_packed_bytes(C: int, K: int, H: int | None = None) -> int:
    """The bytes of :func:`narrow_pack`'s buffer (the kernel's ``Packed``)."""
    kP, steps = narrow_shape(C, H)
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
    Hu = p.w1.shape[0]                                          # hidden units: 4C or a shard
    kP, steps = narrow_shape(C, Hu)
    Cp, H = 16 * kP, NARROW_STEP * steps
    w1 = p.w1.new_zeros(H, Cp)
    w1[:Hu, :C] = p.w1
    f1 = w1.view(2 * steps, 2, 8, kP, 2, 4, 2).permute(0, 3, 2, 5, 1, 4, 6)
    w2 = p.w2.new_zeros(Cp, H)
    w2[:C, :Hu] = p.w2
    f2 = w2.view(kP, 2, 8, 2 * steps, 2, 4, 2).permute(3, 0, 2, 5, 1, 4, 6)
    alpha = p.b1.new_ones(H)
    if p.alpha is not None:
        alpha[:Hu] = p.alpha
    d = alpha + EPS
    hv = torch.stack([F.pad(p.b1, (0, H - Hu)), alpha, d, 1.0 / d], 1)
    cv = p.b1.new_zeros(K + 4, Cp)
    cv[:K, :C] = p.dw.t()
    for i, v in enumerate((p.dw_b, p.norm_w, p.norm_b, p.b2)):
        if v is not None:
            cv[K + i, :C] = v
    parts = [f1.contiguous().view(torch.uint8), f2.contiguous().view(torch.uint8),
             hv.view(torch.uint8), cv.view(torch.uint8)]
    return torch.cat([t.reshape(-1) for t in parts])


def conv_unit_plain_bf16(x: torch.Tensor, w: ConvUnitWeights | PreparedBf16, *,
                         channel_dim: int, dilation: int = 1, lh: torch.Tensor | None = None,
                         rh: torch.Tensor | None = None, partial: bool = False) -> torch.Tensor:
    """The bf16 kernels' function in plain PyTorch, rounding where they do:
    fp32 depthwise conv, norm and activation, bf16 product operands with
    fp32 sums, GRN folded, the residual added in fp32 and rounded once.
    ``lh`` / ``rh`` as :func:`unit_body` takes them. ``partial``: the
    tensor-parallel mode, the shard's fp32 share (unrounded; no residual, no
    pw2 bias) from a shard's weights (or their ``prepare_bf16(w, True)``)."""
    p = w if isinstance(w, PreparedBf16) else prepare_bf16(w, partial)
    xt = (x if channel_dim == 1 else x.transpose(1, 2)).float()
    lh, rh = (None if h is None else _t(h, channel_dim).float() for h in (lh, rh))
    y = _depthwise(xt, p.dw[:, None, :], p.dw_b, dilation, lh, rh)
    if p.norm_w is not None:
        y = channel_norm(y, p.norm_w, p.norm_b, dim=1)
    h = torch.einsum("oc,bct->bot", p.w1.float(), y.bfloat16().float()) + p.b1[:, None]
    h = snake(h, p.alpha[:, None]) if p.alpha is not None else gelu(h)
    y = torch.einsum("oc,bct->bot", p.w2.float(), h.bfloat16().float()) + p.b2[:, None]
    if partial:
        return y if channel_dim == 1 else y.transpose(1, 2)
    out = (xt + y).to(x.dtype)
    return out if channel_dim == 1 else out.transpose(1, 2)


class PreparedWeights(NamedTuple):
    """The tensor-core kernels' product operands, fp32 on the weights'
    device. A tensor-parallel shard's (``partial``) are of the hidden axis
    padded by :func:`pad_hidden`, and carry the padded pw1 bias and alpha,
    which the kernels then take in place of the unit's own."""
    b2: torch.Tensor      # (C,) b2' (fold_grn)
    w1_hi: torch.Tensor   # (4C, C) pw1 split into TF32 (split_tf32)
    w1_lo: torch.Tensor
    w2_hi: torch.Tensor   # (C, 4C) W2': pw2 with GRN folded (fold_grn, transposed), split
    w2_lo: torch.Tensor
    b1: torch.Tensor | None = None     # (H,) a shard's padded pw1 bias; None: the unit's
    alpha: torch.Tensor | None = None  # (H,) a shard's padded snake alpha (None under GELU)

    def hidden_vectors(self, w: ConvUnitWeights) -> tuple:
        """(b1, alpha) as the kernels take them: a shard's padded ones, else
        the unit's own."""
        return (w.pw1_b, w.alpha) if self.b1 is None else (self.b1, self.alpha)


def prepare_weights(w: ConvUnitWeights, partial: bool = False
                    ) -> PreparedWeights | PreparedBf16:
    """W1 and W2' in K-major (nn.Linear) layout, split into TF32 hi / lo, and
    b2'. pw1 is K-major already; W2' is ``fold_grn``'s (4C, C) result
    transposed. A bf16 unit's operands are :func:`prepare_bf16`'s.
    ``partial``: a tensor-parallel shard's (:func:`pad_hidden`, b2' without
    pw2's bias, the padded b1 and alpha kept)."""
    if w.pw1_w.dtype == torch.bfloat16:
        return prepare_bf16(w, partial)
    with torch.no_grad():
        if partial:
            w = pad_hidden(w)
        w2f, b2f = fold_grn(w, with_bias=not partial)
        p = PreparedWeights(b2f, *split_tf32(w.pw1_w), *split_tf32(w2f.t().contiguous()))
        if not partial:
            return p
        f = lambda t: None if t is None else t.detach().float().contiguous()
        return p._replace(b1=f(w.pw1_b), alpha=f(w.alpha))


# id(owner) -> ((data_ptr, _version) of each source, weak references to the
# sources, PreparedWeights). Kept here, not on the tensor, so that the weights
# still pickle; an entry goes when its owner is freed.
_PREPARED: dict[int, tuple] = {}


def cached_prepare(owner: torch.Tensor, src: tuple[torch.Tensor, ...],
                   build: Callable[[], PreparedWeights], store: dict | None = None,
                   mode: object = None) -> PreparedWeights:
    """``build()``, cached under ``owner`` in ``store`` (default: the
    prepared weights' own dict) and rebuilt whenever a tensor of
    ``src`` is another object or has changed in place (``load_state_dict``,
    ``mul_``, ...: each bumps its ``_version``) or has another dtype (a model
    moved with ``.to(torch.bfloat16)``), or ``mode`` (what ``build`` makes of
    the same sources) differs, so no stale weight is used.
    A source that is an inference tensor has no version counter, and its
    in-place changes cannot be seen: such a set is built on every call and
    never cached."""
    if any(t.is_inference() for t in src):
        return build()
    store = _PREPARED if store is None else store
    key = (mode, *((t.data_ptr(), t._version, t.dtype) for t in src))
    slot = id(owner)
    hit = store.get(slot)
    if hit is not None and hit[0] == key and all(r() is t for r, t in zip(hit[1], src)):
        return hit[2]
    prep = build()
    if hit is None:
        weakref.finalize(owner, store.pop, slot, None)
    store[slot] = (key, tuple(weakref.ref(t) for t in src), prep)
    return prep


def prepared_weights(w: ConvUnitWeights, partial: bool = False
                     ) -> PreparedWeights | PreparedBf16:
    """:func:`prepare_weights`, cached on its sources by
    :func:`cached_prepare`: pw1_w, pw2_w, pw2_b, grn_gamma, grn_beta, and for
    a bf16 unit or a TP shard (``partial``) every other weight too."""
    src = ((w.pw1_w, w.pw2_w, w.pw2_b, w.grn_gamma, w.grn_beta)
           if w.pw1_w.dtype != torch.bfloat16 and not partial
           else tuple(t for t in w if t is not None))
    return cached_prepare(w.pw1_w, src, lambda: prepare_weights(w, partial), mode=partial)


def admits(name: str, C: int, dtype: torch.dtype = torch.float32,
           partial: bool = False) -> str | None:
    """Why the CUDA route of ``name`` (``"conv_unit"`` or ``"conv_unit_ct"``)
    does not take width C in ``dtype`` (``partial``: in the tensor-parallel
    operand mode), or None when it does: every C >= 1 (:func:`route_for`
    names the kernel). The launch raises with this reason."""
    return None if C >= 1 else f"{name}: C = {C} is not a width (C >= 1)"


def route_for(name: str, C: int, dtype: torch.dtype = torch.float32,
              partial: bool = False) -> str:
    """The kernel that runs width C: ``"narrow"`` (``conv_unit_ct`` up to
    NARROW_MAX_C), ``"tc"`` (the tensor-core kernels: fp32 C % 64 == 0, bf16
    C % 8 == 0, up to TC_MAX_C), ``"simt"`` (fp32 up to MAX_C, not in the TP
    mode) or ``"general"`` (``csrc/general.cu``: every other C).
    ``conv_unit_ct`` above NARROW_MAX_C runs on the transposed x, by
    ``conv_unit``'s rule (the channels-last route)."""
    if name == "conv_unit_ct" and C <= NARROW_MAX_C:
        return "narrow"
    mult = BF16_MULTIPLE if dtype == torch.bfloat16 else TC_MULTIPLE
    if C % mult == 0 and C <= TC_MAX_C:
        return "tc"
    if dtype != torch.bfloat16 and not partial and C <= MAX_C:
        return "simt"
    return "general"


def _check_weights(w: ConvUnitWeights, C: int, name: str, max_c: int = MAX_C) -> int:
    """The kernel size; raises on shapes that do not match C (the products'
    where ``w`` holds them)."""
    ksz = w.dw_w.shape[-1]
    if not 1 <= C <= max_c:
        raise ValueError(f"{name}: C = {C} outside 1..{max_c}")
    H = w.pw1_b.shape[0]
    if w.dw_w.shape != (C, 1, ksz) or ksz % 2 == 0 or (w.pw1_w is not None and (
            w.pw1_w.shape != (H, C) or w.pw2_w.shape != (C, H))):
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
    if w.pw1_w.shape[0] != 4 * C:
        raise ValueError(f"{name}: the SIMT kernel takes 4C hidden units")
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


_TC_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch_tc(x: torch.Tensor, w: ConvUnitWeights, dilation: int, *,
               p: PreparedWeights, partial: bool = False) -> torch.Tensor:
    """``csrc/conv_unit_tc.cu`` on (B, T, C), C a multiple of TC_MULTIPLE,
    the products from ``p``; ``partial``: the TP mode, the shard's fp32
    share."""
    B, T, C = x.shape
    ksz = _check_weights(w, C, "conv_unit", TC_MAX_C)
    H = p.w1_hi.shape[0]
    if p.w1_hi.shape != (H, C) or p.w2_hi.shape != (C, H) or (H != 4 * C and not partial):
        raise ValueError(f"conv_unit: prepared weight shapes do not match C = {C}")
    b1, alpha = p.hidden_vectors(w)
    dw = w.dw_w[:, 0, :]                                       # (C, K), a view
    ops = {**p._asdict(), "x": x, "dw": dw, "dw_b": w.dw_b, "norm_w": w.norm_w,
           "norm_b": w.norm_b, "pw1_b": b1, "alpha": alpha}
    K.check_cuda(ops, x.device)
    out = torch.empty_like(x)
    a = torch.empty(B * T, C, device=x.device)
    h = torch.empty(B * T, H, device=x.device)
    fn = _build.function("l3ac_conv_unit_tc", _TC_ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), a.data_ptr(), h.data_ptr(), dw.data_ptr(),
             w.dw_b.data_ptr(), _build.ptr(w.norm_w), _build.ptr(w.norm_b),
             p.w1_hi.data_ptr(), p.w1_lo.data_ptr(), b1.data_ptr(), _build.ptr(alpha),
             p.w2_hi.data_ptr(), p.w2_lo.data_ptr(), p.b2.data_ptr(), B, T, C, ksz, dilation,
             H, int(partial), _build.stream_ptr())
    _build.check(err, "conv_unit")
    return out


_NARROW_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch_narrow(x: torch.Tensor, w: ConvUnitWeights, p: PreparedWeights,
                   dilation: int, partial: bool = False) -> torch.Tensor:
    """``csrc/conv_unit_narrow.cu`` on (B, C, T), C <= NARROW_MAX_C; the
    products from ``p``, the other weights from ``w`` (a TP shard's padded
    b1 and alpha from ``p``); ``partial``: the TP mode."""
    B, C, T = x.shape
    ksz = w.dw_w.shape[-1]
    H = p.w1_hi.shape[0]
    b1, alpha = p.hidden_vectors(w)
    if not 1 <= C <= NARROW_MAX_C:
        raise ValueError(f"conv_unit_ct: C = {C} outside 1..{NARROW_MAX_C}")
    if w.dw_w.shape != (C, 1, ksz) or ksz % 2 == 0 or b1.shape != (H,) or \
            p.w1_hi.shape != (H, C) or p.w2_hi.shape != (C, H) or (H != 4 * C and not partial):
        raise ValueError(f"conv_unit_ct: weight shapes do not match C = {C}")
    if (w.norm_w is None) != (w.norm_b is None):
        raise ValueError("conv_unit_ct: norm weight and bias go together")
    dw = w.dw_w[:, 0, :]                                       # (C, K), a view
    ops = {**p._asdict(), "x": x, "dw": dw, "dw_b": w.dw_b, "norm_w": w.norm_w,
           "norm_b": w.norm_b, "pw1_b": b1, "alpha": alpha}
    K.check_cuda(ops, x.device)
    out = torch.empty_like(x)
    fn = _build.function("l3ac_conv_unit_narrow", _NARROW_ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), dw.data_ptr(), w.dw_b.data_ptr(),
             _build.ptr(w.norm_w), _build.ptr(w.norm_b), p.w1_hi.data_ptr(), p.w1_lo.data_ptr(),
             b1.data_ptr(), _build.ptr(alpha), p.w2_hi.data_ptr(), p.w2_lo.data_ptr(),
             p.b2.data_ptr(), B, C, T, ksz, dilation, H, int(partial), _build.stream_ptr())
    _build.check(err, "conv_unit_ct")
    return out


_TC_BF16_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 +
                     [ctypes.c_void_p, ctypes.c_void_p])


def _check_bf16(x: torch.Tensor, p: PreparedBf16, C: int, name: str,
                partial: bool = False) -> int:
    ksz = p.dw.shape[-1]
    H = p.w1.shape[0]
    if p.dw.shape != (C, ksz) or ksz % 2 == 0 or p.w1.shape != (H, C) or \
            p.w2.shape != (C, H) or p.b1.shape != (H,) or p.b2.shape != (C,) or \
            (H != 4 * C and not partial):
        raise ValueError(f"{name}: bf16 weight shapes do not match C = {C}")
    if (p.norm_w is None) != (p.norm_b is None):
        raise ValueError(f"{name}: norm weight and bias go together")
    K.check_cuda({"x": x, "w1": p.w1, "w2": p.w2}, x.device, dtype=torch.bfloat16)
    K.check_cuda({"dw": p.dw, "dw_b": p.dw_b, "norm_w": p.norm_w, "norm_b": p.norm_b,
                  "b1": p.b1, "alpha": p.alpha, "b2": p.b2}, x.device)
    return ksz


_NARROW_BF16_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 +
                         [ctypes.c_void_p, ctypes.c_void_p])


def call_narrow_bf16(fn: Callable, x: torch.Tensor, out: torch.Tensor | None, p: PreparedBf16,
                     dilation: int, part: torch.Tensor | None = None) -> int:
    """``fn`` (``l3ac_conv_unit_narrow_bf16`` or a variant of it) on x, out
    (B, C, T) with p's narrow buffer (``part``: the TP mode's fp32 output,
    then ``out`` is unused); returns its CUDA error code."""
    B, C, T = x.shape
    return fn(x.data_ptr(), _build.ptr(out), p.narrow.data_ptr(), B, C, T, p.dw.shape[-1],
              dilation, int(p.norm_w is not None), int(p.alpha is not None), p.w1.shape[0],
              _build.ptr(part), _build.stream_ptr())


def _launch_bf16(x: torch.Tensor, p: PreparedBf16, dilation: int, *,
                 channels_last: bool, partial: bool = False) -> torch.Tensor:
    """The bf16 kernels: ``csrc/conv_unit_narrow_bf16.cu`` on (B, C, T), the
    bf16 path of ``csrc/conv_unit_tc.cu`` on (B, T, C); ``partial``: the TP
    mode, an fp32 result."""
    name = "conv_unit" if channels_last else "conv_unit_ct"
    B = x.shape[0]
    C, T = (x.shape[2], x.shape[1]) if channels_last else (x.shape[1], x.shape[2])
    why = admits(name, C, torch.bfloat16, partial)
    if why is not None:
        raise ValueError(why)
    ksz = _check_bf16(x, p, C, name, partial)
    H = p.w1.shape[0]
    out = torch.empty(x.shape, device=x.device, dtype=torch.float32 if partial else x.dtype)
    part = out if partial else None
    if channels_last:
        vec = (p.dw.data_ptr(), p.dw_b.data_ptr(), _build.ptr(p.norm_w), _build.ptr(p.norm_b),
               p.w1.data_ptr(), p.b1.data_ptr(), _build.ptr(p.alpha), p.w2.data_ptr(),
               p.b2.data_ptr())
        if x.data_ptr() % 16:
            raise ValueError("conv_unit: bf16 x must be 16-byte aligned")
        M = B * T
        a = torch.empty(M, C, device=x.device, dtype=torch.bfloat16)
        h = torch.empty(M, H, device=x.device, dtype=torch.bfloat16)
        r1 = gemm_sm90.route_for(M, H, C, int8=False, a_ptr=a.data_ptr(),
                                 b_ptr=p.w1.data_ptr())
        r2 = gemm_sm90.route_for(M, C, H, int8=False, a_ptr=h.data_ptr(),
                                 b_ptr=p.w2.data_ptr())
        # the maps stay referenced until the launch has copied them
        maps = [gemm_sm90.weight_map(w) if r == "tma" else None
                for w, r in ((p.w1, r1), (p.w2, r2))]
        fn = _build.function("l3ac_conv_unit_tc_bf16", _TC_BF16_ARGTYPES)
        err = fn(x.data_ptr(), None if partial else out.data_ptr(), a.data_ptr(), h.data_ptr(),
                 *vec[:5], gemm_sm90.map_ptr(maps[0]), *vec[5:8], gemm_sm90.map_ptr(maps[1]),
                 vec[8], B, T, C, ksz, dilation, gemm_sm90.ROUTE_CODE[r1],
                 gemm_sm90.ROUTE_CODE[r2], H, _build.ptr(part), _build.stream_ptr())
        _build.check(err, name)
        gemm_sm90.ROUTES[r1] += 1
        gemm_sm90.ROUTES[r2] += 1
        return out
    else:
        if p.narrow is None or p.narrow.shape != (narrow_packed_bytes(C, ksz, H),):
            raise ValueError(f"{name}: the prepared narrow buffer does not match C = {C}, "
                             f"K = {ksz}, H = {H}")
        K.check_cuda({"narrow": p.narrow}, x.device, dtype=torch.uint8)
        err = call_narrow_bf16(_build.function("l3ac_conv_unit_narrow_bf16",
                                               _NARROW_BF16_ARGTYPES),
                               x, None if partial else out, p, dilation, part)
    _build.check(err, name)
    return out


_GEMM_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 +
                  [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2 +
                  [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p] +
                  [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] +
                  [ctypes.c_int] * 2 + [ctypes.c_void_p])
_TC_GEMM_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DW_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6 +
                [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
ACT_NONE, ACT_SNAKE, ACT_GELU, ACT_TANH = 0, 1, 2, 3
# the general routes' products by the core that ran them (:func:`gemm_route`;
# the general tail's seven products a launch count under "mma")
GEMM_ROUTES: dict[str, int] = {"tc_gemm": 0, "gemm_sm90": 0, "mma": 0}
_INT_MAX = 2 ** 31 - 1
TC_GEMM_BM = 128   # tc_gemm.cuh's rows a block; its grid holds at most 65535 of them


def _flat(a_map: tuple[int, int, int, int], M: int, width: int) -> bool:
    """Whether rows m = (b, t) at ``b sb + t st`` with inner stride ``sk``,
    ``a_map = (rows, sb, st, sk)``, are the rows of one contiguous (M,
    width) matrix."""
    rows, sb, st, sk = a_map
    return sk == 1 and st == width and (M <= rows or sb == rows * width)


def gemm_route(a_map: tuple[int, int, int, int], a_dtype: torch.dtype, split: bool,
               K: int, o_map: tuple[int, int, int, int], N: int, M: int,
               out_dtype: torch.dtype, *, act: int = ACT_NONE, res: bool = False,
               round_mid: bool = False) -> str:
    """The core that runs :func:`general_gemm`'s product, a shape and layout
    rule: where A is a flat K-major (M, K) matrix, the output (and the
    residual) a flat (M, N) one and the epilogue one the core has,
    ``"tc_gemm"`` (fp32 with a TF32 hi / lo B, ``split``: ``csrc/tc_gemm.cuh``)
    or ``"gemm_sm90"`` (bf16: ``csrc/gemm_sm90.cuh``, bf16 out, or fp32 out
    with the bias alone); else ``"mma"`` (``csrc/general.cu``'s tensor-core
    product: any strides, k7 taps, tanh, ``round_mid``)."""
    if not (_flat(a_map, M, K) and _flat(o_map, M, N)) or round_mid or act == ACT_TANH or \
            (res and act != ACT_NONE) or max(M * K, M * N, N * K) > _INT_MAX:
        return "mma"
    if a_dtype == torch.float32:
        ok = split and out_dtype == torch.float32 and -(-M // TC_GEMM_BM) <= 65535
        return "tc_gemm" if ok else "mma"
    if out_dtype == torch.float32 and (act != ACT_NONE or res):
        return "mma"
    return "gemm_sm90"


def general_gemm(a: torch.Tensor, a_map: tuple[int, int, int, int], b: torch.Tensor,
                 b_lo: torch.Tensor | None, bias: torch.Tensor | None, out: torch.Tensor,
                 o_map: tuple[int, int, int, int], M: int, *, alpha: torch.Tensor | None = None,
                 act: int = ACT_NONE, res: torch.Tensor | None = None,
                 round_mid: bool = False) -> None:
    """The general routes' product on the tensor cores, out = act(A B^T +
    bias) (+ res): A's row m at ``a[(m // rows) sb + (m % rows) st]`` with
    ``a_map = (rows, sb, st, sk)`` (sk the stride of K), B (N, K) contiguous
    (plus ``b_lo``, fp32, where B is a TF32 hi / lo pair), out and res at
    ``o_map = (rows, sb, st, sn)``; fp32 sums, bf16 or fp32 operands and
    output. The core is :func:`gemm_route`'s, counted in
    :data:`GEMM_ROUTES` (and the wgmma core's loader in
    ``gemm_sm90.ROUTES``)."""
    N, Kd = b.shape
    route = gemm_route(a_map, a.dtype, b_lo is not None, Kd, o_map, N, M, out.dtype, act=act,
                       res=res is not None, round_mid=round_mid)
    if route == "tc_gemm":
        fn = _build.function("l3ac_tc_gemm_fp32", _TC_GEMM_ARGTYPES)
        err = fn(a.data_ptr(), b.data_ptr(), b_lo.data_ptr(), _build.ptr(bias),
                 _build.ptr(alpha), _build.ptr(res), out.data_ptr(), M, N, Kd,
                 3 if res is not None else act, _build.stream_ptr())
    elif route == "gemm_sm90":
        r = gemm_sm90.route_for(M, N, Kd, int8=False, a_ptr=a.data_ptr(), b_ptr=b.data_ptr())
        wmap = gemm_sm90.weight_map(b) if r == "tma" else None  # alive across the launch
        epi = 4 if out.dtype == torch.float32 else 3 if res is not None else act
        fn = _build.function("l3ac_gemm_sm90_bf16", gemm_sm90.ARGTYPES)
        err = fn(a.data_ptr(), b.data_ptr(), gemm_sm90.map_ptr(wmap), _build.ptr(bias),
                 _build.ptr(alpha), _build.ptr(res), out.data_ptr(), M, N, Kd, epi,
                 gemm_sm90.ROUTE_CODE[r], _build.stream_ptr())
        gemm_sm90.ROUTES[r] += 1
    else:
        bf = lambda t: int(t.dtype == torch.bfloat16)
        fn = _build.function("l3ac_general_gemm", _GEMM_ARGTYPES)
        err = fn(a.data_ptr(), a_map[1], a_map[2], a_map[3], a_map[0], bf(a), b.data_ptr(),
                 _build.ptr(b_lo), bf(b), _build.ptr(bias), _build.ptr(alpha), act,
                 _build.ptr(res), 0 if res is None else bf(res), int(round_mid), out.data_ptr(),
                 o_map[1], o_map[2], o_map[3], o_map[0], bf(out), M, N, Kd, _build.stream_ptr())
    _build.check(err, f"general gemm ({route})")
    GEMM_ROUTES[route] += 1


def _launch_general(x: torch.Tensor, w: ConvUnitWeights, p: PreparedWeights | PreparedBf16,
                    dilation: int, partial: bool, name: str) -> torch.Tensor:
    """The general route (``csrc/general.cu``) on (B, T, C) x of any C: the
    depthwise conv + ChannelNorm pass into a (B T, C) buffer of x's dtype,
    pw1 with the activation into (B T, H), pw2 with the residual (TP mode:
    the fp32 share, no residual). Operands from ``p`` (bf16: every one;
    fp32: the products and a TP shard's padded b1 / alpha, the rest from
    ``w``)."""
    B, T, C = x.shape
    bf16 = isinstance(p, PreparedBf16)
    if bf16 != (x.dtype == torch.bfloat16):
        raise TypeError(f"{name}: x is {x.dtype} but the unit's weights are not")
    if bf16:
        dw, dw_b, nw, nb = p.dw, p.dw_b, p.norm_w, p.norm_b
        w1, w1_lo, w2, w2_lo, b1, alpha, b2 = p.w1, None, p.w2, None, p.b1, p.alpha, p.b2
        ksz = _check_bf16(x, p, C, name, partial)
    else:
        ksz = _check_weights(w, C, name, max_c=C)
        dw, dw_b, nw, nb = w.dw_w[:, 0, :], w.dw_b, w.norm_w, w.norm_b
        w1, w1_lo, w2, w2_lo, b2 = p.w1_hi, p.w1_lo, p.w2_hi, p.w2_lo, p.b2
        b1, alpha = p.hidden_vectors(w)
    H = w1.shape[0]
    if w1.shape != (H, C) or w2.shape != (C, H) or b1.shape != (H,) or \
            (H != 4 * C and not partial):
        raise ValueError(f"{name}: prepared weight shapes do not match C = {C}")
    K.check_cuda({"x": x, "w1": w1, "w2": w2}, x.device, dtype=x.dtype)
    K.check_cuda({"dw": dw, "dw_b": dw_b, "norm_w": nw, "norm_b": nb, "w1_lo": w1_lo,
                  "w2_lo": w2_lo, "b1": b1, "alpha": alpha, "b2": b2}, x.device)
    M = B * T
    a = torch.empty(M, C, device=x.device, dtype=x.dtype)
    h = torch.empty(M, H, device=x.device, dtype=x.dtype)
    out = torch.empty(x.shape, device=x.device, dtype=torch.float32 if partial else x.dtype)
    fn = _build.function("l3ac_general_dw_norm", _DW_ARGTYPES)
    err = fn(x.data_ptr(), T * C, C, 1, int(bf16), B, T, C, ksz, dilation, dw.data_ptr(),
             dw_b.data_ptr(), _build.ptr(nw), _build.ptr(nb), a.data_ptr(), int(bf16),
             _build.stream_ptr())
    _build.check(err, name)
    flat = lambda n: (M, 0, n, 1)
    general_gemm(a, flat(C), w1, w1_lo, b1, h, flat(H), M, alpha=alpha,
                 act=ACT_SNAKE if alpha is not None else ACT_GELU)
    general_gemm(h, flat(H), w2, w2_lo, b2, out, flat(C), M,
                 res=None if partial else x)
    return out


def _plain(channel_dim: int, dilation: int, partial: bool) -> Callable:
    """The fp32 plain version over the flattened inputs (x, lh, rh,
    *ConvUnitWeights): what a training backward differentiates
    (``autograd.call``), with a gradient for the halo blocks too."""
    return lambda x, lh, rh, *ws: conv_unit_plain(
        x, ConvUnitWeights(*ws), channel_dim=channel_dim, dilation=dilation, lh=lh, rh=rh,
        partial=partial)


def _check_trainable(x: torch.Tensor, w: ConvUnitWeights, name: str) -> None:
    if w.pw1_w is None and autograd.needs_grad(x, *w):
        raise TypeError(f"{name}: int8 weight-only units do not train (the JAX package trains "
                        "no int8 model); run them under torch.inference_mode()")


def _count(name: str, partial: bool) -> None:
    K.LAUNCHES[name] += 1
    if partial:
        K.TP_LAUNCHES[name] += 1


def conv_unit_ct(x: torch.Tensor, w: ConvUnitWeights, *, dilation: int = 1,
                 prepared: Callable[[], PreparedWeights | PreparedBf16] | None = None,
                 lh: torch.Tensor | None = None, rh: torch.Tensor | None = None,
                 partial: bool = False) -> torch.Tensor:
    """Residual ConvUnit on (B, C, T), fp32 or bf16. On CUDA the narrow
    tensor-core kernel of x's dtype at C <= NARROW_MAX_C, above it the
    channels-last kernels on the transposed x (:func:`route_for`), their
    operands from ``prepared()`` when given (then ``w`` may leave pw1_w /
    pw2_w out), else from :func:`prepared_weights`; under autograd through
    ``autograd.call`` (the backward differentiates the plain version on
    ``w``, which then holds the dense weights, and on the halos). Plain on
    the CPU, from ``w``'s dense weights. ``lh`` / ``rh``: JAX's SP halo
    blocks (B, C, 3 * dilation), zeros where missing; the kernel runs on the
    staged ``[lh | x | rh]``. ``partial``: the tensor-parallel operand mode
    (``w`` a shard; the fp32 share without residual and pw2 bias)."""
    K.check_input(x, "conv_unit_ct x", ndim=3, dtype=K.DTYPES)
    bf16 = x.dtype == torch.bfloat16
    if not K.route(x, "conv_unit_ct"):
        if bf16:
            return conv_unit_plain_bf16(x, w, channel_dim=1, dilation=dilation, lh=lh, rh=rh,
                                        partial=partial)
        return conv_unit_plain(x, w, channel_dim=1, dilation=dilation, lh=lh, rh=rh,
                               partial=partial)
    C = x.shape[1]
    why = admits("conv_unit_ct", C, x.dtype, partial)
    if why is not None:
        raise ValueError(why)
    _check_trainable(x, w, "conv_unit_ct")
    if C > NARROW_MAX_C:
        # the channels-last route: x and the halos transposed, conv_unit's kernels
        tr = lambda t: None if t is None else t.transpose(1, 2).contiguous()
        out = _channels_last(tr(x), w, dilation, tr(lh), tr(rh), partial,
                             None if partial else prepared).transpose(1, 2).contiguous()
        ROUTES["channels_last"] += 1
        _count("conv_unit_ct", partial)
        return out
    if prepared is not None and not partial:
        p = prepared()
    else:
        p = prepared_weights(w, partial)
    if bf16 != isinstance(p, PreparedBf16):
        raise TypeError(f"conv_unit_ct: x is {x.dtype} but the unit's weights are not")
    if bf16:
        run = lambda x: _launch_bf16(x, p, dilation, channels_last=False, partial=partial)
    elif partial:
        run = lambda x: _launch_narrow(x, w, p, dilation, partial=True)
    else:
        run = lambda x: _launch_narrow(x, w, p, dilation)
    # on [lh | x | rh], the halo frames' outputs cropped: exact, as the kernel
    # folds GRN (no reduction over time) and pads only at its buffer's ends
    launch = lambda: K.halo_call(run, x, lh, rh, axis=2, out_axis=2)
    out = autograd.call("conv_unit_ct", launch, _plain(1, dilation, partial), x, lh, rh, *w)
    ROUTES["narrow"] += 1
    _count("conv_unit_ct", partial)
    return out


def conv_unit(x: torch.Tensor, w: ConvUnitWeights, *, dilation: int = 1,
              lh: torch.Tensor | None = None, rh: torch.Tensor | None = None,
              partial: bool = False) -> torch.Tensor:
    """Residual ConvUnit on (B, T, C), fp32 or bf16. On CUDA the kernel
    :func:`route_for` names (the tensor-core path, the SIMT kernel or the
    general route); one count either way; under autograd through
    ``autograd.call``. Plain on CPU. ``lh`` / ``rh``: SP halo blocks (B,
    3 * dilation, C), staged as :func:`conv_unit_ct` stages them.
    ``partial``: the tensor-parallel operand mode (the tensor-core or the
    general route)."""
    K.check_input(x, "conv_unit x", ndim=3, dtype=K.DTYPES)
    if not K.route(x, "conv_unit"):
        plain = conv_unit_plain_bf16 if x.dtype == torch.bfloat16 else conv_unit_plain
        return plain(x, w, channel_dim=2, dilation=dilation, lh=lh, rh=rh, partial=partial)
    out = _channels_last(x, w, dilation, lh, rh, partial, None)
    _count("conv_unit", partial)
    return out


def _channels_last(x: torch.Tensor, w: ConvUnitWeights, dilation: int, lh, rh, partial: bool,
                   prepared: Callable[[], PreparedWeights | PreparedBf16] | None
                   ) -> torch.Tensor:
    """:func:`conv_unit`'s launch on a CUDA (B, T, C) x, uncounted; also
    :func:`conv_unit_ct`'s route above NARROW_MAX_C (``prepared`` as it
    takes them)."""
    bf16 = x.dtype == torch.bfloat16
    why = admits("conv_unit", x.shape[2], x.dtype, partial)
    if why is not None:
        raise ValueError(why)
    _check_trainable(x, w, "conv_unit")
    route = route_for("conv_unit", x.shape[2], x.dtype, partial)
    p = (prepared() if prepared is not None else prepared_weights(w, partial)) \
        if route != "simt" else None
    if p is not None and bf16 != isinstance(p, PreparedBf16):
        raise TypeError(f"conv_unit: x is {x.dtype} but the unit's weights are not")
    if route == "general":
        run = lambda x: _launch_general(x, w, p, dilation, partial, "conv_unit")
    elif bf16:
        run = lambda x: _launch_bf16(x, p, dilation, channels_last=True, partial=partial)
    elif route == "tc":
        tp_kw = {"partial": True} if partial else {}
        run = lambda x: _launch_tc(x, w, dilation, p=p, **tp_kw)
    else:
        run = lambda x: conv_unit_simt(x, w, dilation, channels_last=True)
    launch = lambda: K.halo_call(run, x, lh, rh, axis=1, out_axis=1)
    out = autograd.call("conv_unit", launch, _plain(2, dilation, partial), x, lh, rh, *w)
    if route == "general":
        ROUTES["general"] += 1
    return out
