"""Encoder stem (FirstBlock): audio (B, T) -> features (B, Cout, T).

Replaces ``l3ac_tpu/ops/pallas/first_block.py:first_block_ct`` (body
``_kernel``) with ``csrc/first_block.cu``:
five branches |x| -> max-pool k -> avg-pool k -> conv 1->4 k7 for
k in {1, 5, 11, 21, 45} (torch pads: max -inf, avg 0 and always / k), then a
1x1 20->80, exact GELU, the raw sample appended, and a 1x1 81->Cout.

Semantics are those of the plain path (``models/tconv.py:first_block_apply``
in the JAX package): each pooled branch signal is zero outside [0, T) before
its k7 conv. The Pallas kernel does not re-zero it there, which changes its
first and last three output columns; this kernel and its plain version do.

The kernel runs both 1x1 products on the tensor cores (3xTF32 mma.sync, time
as the M axis) with the exact GELU between them in registers, from one
weight buffer, :func:`pack`: W1 and W2 split into TF32 hi / lo and laid out
in the order of their mma fragments, W2's hidden axis permuted so that
product 1's accumulator is product 2's A fragment, Cout padded to a
multiple of 8 with zeros, then the vectors and the branch convs. A caller
that holds its weights prepares it once: :func:`prepared_stem` caches it on
the weight tensors (``conv_unit.cached_prepare``: rebuilt when one of them
is replaced or changed in place, never cached for an inference tensor), and
``models.tconv.FirstBlock`` passes the :class:`PreparedStem` it cached on
its parameters. Bound on the H100 and design: the note at the head of
``csrc/first_block.cu``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..activations import gelu
from ..pool import trend_pool
from . import _build
from .conv_unit import cached_prepare
from .tc_gemm import split_tf32

POOLS = (1, 5, 11, 21, 45)
MAX_COUT = 64
TILE = 128        # output columns per tile (csrc/first_block.cu kTile)
HALO = 47         # staged audio on each side of a tile: 2 * (45 // 2) + 3
HID, HID_PAD, MID = 20, 24, 80


class FirstBlockWeights(NamedTuple):
    branch_w: torch.Tensor  # (5, 4, 7): each branch's Conv1d(1, 4, 7) weight, in-channel squeezed
    branch_b: torch.Tensor  # (5, 4)
    w1: torch.Tensor        # (80, 20)
    b1: torch.Tensor        # (80,)
    w2: torch.Tensor        # (Cout, 81)
    b2: torch.Tensor        # (Cout,)


class PreparedStem(NamedTuple):
    """A stem's weights as both versions take them."""
    weights: FirstBlockWeights  # the plain version's operands
    packed: torch.Tensor        # the kernel's buffer (:func:`pack`)


def first_block_plain(x: torch.Tensor, w: FirstBlockWeights) -> torch.Tensor:
    """x: (B, T) -> (B, Cout, T), in plain PyTorch."""
    xc = x[:, None, :]
    outs = []
    for i, k in enumerate(POOLS):
        h = trend_pool(xc, k)
        outs.append(F.conv1d(h, w.branch_w[i][:, None, :], w.branch_b[i],
                             padding=3))
    h = torch.cat(outs, dim=1)                                   # (B, 20, T)
    h = gelu(torch.einsum("oc,bct->bot", w.w1, h) + w.b1[:, None])
    h = torch.cat([h, xc], dim=1)                                # (B, 81, T)
    return torch.einsum("oc,bct->bot", w.w2, h) + w.b2[:, None]


def padded_cout(Cout: int) -> int:
    """Output channels rounded up to the kernel's n8 tiles."""
    return -(-Cout // 8) * 8


def sections(Cout: int) -> dict[str, tuple[int, ...]]:
    """The shapes of :func:`pack`'s parts, in the order of its buffer (the
    weights of ``csrc/first_block.cu``'s shared-memory Layout)."""
    Cp = padded_cout(Cout)
    return {"w1": (MID // 8, HID_PAD // 8, 32, 4), "w2": (MID // 8, Cp // 8, 32, 4),
            "b1": (MID,), "b2": (Cp,), "wx": (Cp,), "branch_w": (5, 4, 7), "branch_b": (5, 4)}


def packed_floats(Cout: int) -> int:
    """The floats of :func:`pack`'s buffer."""
    return sum(math.prod(shape) for shape in sections(Cout).values())


def _check_shapes(w: FirstBlockWeights, name: str) -> int:
    Cout = w.w2.shape[0]
    if w.branch_w.shape != (5, 4, 7) or w.branch_b.shape != (5, 4) or \
            w.w1.shape != (MID, HID) or w.b1.shape != (MID,) or w.w2.shape != (Cout, MID + 1) or \
            w.b2.shape != (Cout,) or not 1 <= Cout <= MAX_COUT:
        raise ValueError(f"{name}: unexpected weight shapes {[tuple(t.shape) for t in w]}")
    return Cout


def pack(w: FirstBlockWeights) -> torch.Tensor:
    """The kernel's one weight buffer, fp32 on the weights' device, in the
    order of its shared-memory image (:func:`sections`; Cp = Cout rounded up
    to 8):

    - W1 (80, 20) zero-padded to (80, 24), split into TF32 hi / lo, as the B
      fragments of product 1: [j][ks][lane] (hi0, hi1, lo0, lo1), j < 10 the
      n8 tile of hidden units, ks < 3 the k8 step, lane = 4 g + t:
      ``0 = W1[8j + g, 8ks + t]``, ``1 = W1[8j + g, 8ks + t + 4]``;
    - W2's first 80 columns, zero-padded to Cp rows, split, as the B
      fragments of product 2: [j][nt][lane] (hi0, hi1, lo0, lo1), j the k8
      step, nt < Cp / 8: ``0 = W2[8nt + g, 8j + 2t]``,
      ``1 = W2[8nt + g, 8j + 2t + 1]``: k = t of step j is hidden unit
      8j + 2t and k = t + 4 is 8j + 2t + 1, the permutation that makes
      product 1's accumulator product 2's A fragment;
    - b1 (80); b2 (Cp); W2[:, 80] (Cp), the raw sample's column; the branch
      convs (5, 4, 7) and their biases (5, 4), in fp32 as they are."""
    Cout = _check_shapes(w, "first_block pack")
    Cp = padded_cout(Cout)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4                                          # lane = 4 g + t
    with torch.no_grad():
        w1 = w.w1.new_zeros(MID, HID_PAD)
        w1[:, :HID] = w.w1
        hi, lo = split_tf32(w1)
        rows = 8 * torch.arange(MID // 8)[:, None, None] + g            # (10, 1, 32)
        k0 = 8 * torch.arange(HID_PAD // 8)[None, :, None] + t          # (1, 3, 32)
        f1 = torch.stack([hi[rows, k0], hi[rows, k0 + 4], lo[rows, k0], lo[rows, k0 + 4]], -1)
        w2 = w.w2.new_zeros(Cp, MID)
        w2[:Cout] = w.w2[:, :MID]
        hi, lo = split_tf32(w2)
        k0 = 8 * torch.arange(MID // 8)[:, None, None] + 2 * t          # (10, 1, 32)
        rows = 8 * torch.arange(Cp // 8)[None, :, None] + g             # (1, Cp / 8, 32)
        f2 = torch.stack([hi[rows, k0], hi[rows, k0 + 1], lo[rows, k0], lo[rows, k0 + 1]], -1)
        vec = lambda v: F.pad(v, (0, Cp - Cout))
        parts = {"w1": f1, "w2": f2, "b1": w.b1, "b2": vec(w.b2), "wx": vec(w.w2[:, MID]),
                 "branch_w": w.branch_w, "branch_b": w.branch_b}
        return torch.cat([p.reshape(-1) for p in parts.values()]).contiguous()


def prepared_stem(w: FirstBlockWeights) -> torch.Tensor:
    """:func:`pack`, cached on ``w``'s tensors by ``cached_prepare``."""
    return cached_prepare(w.w1, tuple(w), lambda: pack(w))


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch(x: torch.Tensor, w: FirstBlockWeights | PreparedStem) -> torch.Tensor:
    """``csrc/first_block.cu`` on x (B, T)."""
    B, T = x.shape
    prepared = isinstance(w, PreparedStem)
    Cout = _check_shapes(w.weights if prepared else w, "first_block")
    wp = w.packed if prepared else prepared_stem(w)
    if wp.shape != (packed_floats(Cout),):
        raise ValueError(f"first_block: packed weights {tuple(wp.shape)} do not match "
                         f"Cout = {Cout}")
    K.check_cuda({"x": x, "weights": wp}, x.device)
    out = torch.empty((B, Cout, T), device=x.device, dtype=x.dtype)
    fn = _build.function("l3ac_first_block", _ARGTYPES)
    err = fn(x.data_ptr(), wp.data_ptr(), out.data_ptr(), B, T, Cout, _build.stream_ptr())
    _build.check(err, "first_block")
    K.LAUNCHES["first_block"] += 1
    return out


def first_block(x: torch.Tensor, w: FirstBlockWeights | PreparedStem) -> torch.Tensor:
    """x: (B, T) fp32 audio -> (B, Cout, T). ``w``: the weights, or a
    :class:`PreparedStem` whose buffer the kernel takes as it is. Kernel on
    CUDA, plain on CPU."""
    K.check_input(x, "first_block x", ndim=2)
    if not K.route(x, "first_block"):
        return first_block_plain(x, w.weights if isinstance(w, PreparedStem) else w)
    return _launch(x, w)
