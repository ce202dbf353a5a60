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

Widths: any Cout >= 1, as the JAX stem takes (ROADMAP C3). Above 64 the
output channels are padded to a multiple of 64 and each block computes one
64-channel tile of them (the grid's third axis), redoing the pools and
product 1 per tile. The bf16 kernel stages the whole W2 of a launch in
shared memory, so above ``BF16_CHUNK`` (256) channels it runs one launch per
chunk of 256 (its pack the chunks' packs concatenated); ``ROUTES["wide"]``
counts the stems above 256 channels (both dtypes).

bf16 (the encode half of ROADMAP A6): bf16 audio with a bf16 stem runs
``csrc/first_block_bf16.cu``, rounding where
``l3ac_tpu/ops/pallas/first_block.py`` does (:81, :108-124): pools and
branch convs in fp32 from the bf16 samples, the 20 branch outputs rounded to
bf16, product 1 on bf16 operands with fp32 sums (one m16n8k16 pass), b1 and
the exact GELU in fp32, the 80 activations rounded to bf16 and product 2
likewise, the raw sample's column (bf16 times bf16, exact) added in fp32,
and the output rounded to bf16. :func:`pack` lays a bf16 stem's products
out as bf16 pairs in the mma's fragment order (product 1's K in the order
of :func:`k_slot`); :func:`first_block_plain` rounds at the same points on
bf16 input. That kernel keeps the per-warp structure of the bf16 kernel
it replaced (128-column tiles, :data:`TILE_BF16`) and takes erff's
small-range polynomial alone (``csrc/common.cuh`` gelu_small) where a warp
vote finds a whole hidden-tile pair in that range, else the library erff;
its note says what was measured.
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
from . import _build, autograd
from .conv_unit import cached_prepare
from .tc_gemm import split_tf32

POOLS = (1, 5, 11, 21, 45)
BF16_CHUNK = 256  # csrc/first_block_bf16.cu kMaxCout: output channels a bf16 launch
# launches of a stem wider than 256 channels (fp32: more tiles of the grid's
# third axis; bf16: one kernel launch per chunk of BF16_CHUNK channels)
ROUTES: dict[str, int] = {"wide": 0}
COUT_TILE = 64   # output channels per block (csrc/first_block.cu kMaxNT n8 tiles)
TILE = 128        # output columns per tile (csrc/first_block.cu kTile)
TILE_BF16 = 128   # ... of csrc/first_block_bf16.cu
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


def first_block_plain(x: torch.Tensor, w: FirstBlockWeights, *, lh: torch.Tensor | None = None,
                      rh: torch.Tensor | None = None,
                      edges: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (B, T) -> (B, Cout, T), in plain PyTorch; bf16 x: the bf16 kernel's
    roundings (:func:`first_block_plain_bf16`). ``lh`` / ``rh`` / ``edges``:
    SP halo blocks (B, HALO) and the (first, last) shard flags, staged as the
    kernel's wrapper stages them."""
    if lh is not None or rh is not None:
        return K.halo_call(lambda b: first_block_plain(b, w), x, lh, rh, edges, axis=1,
                           out_axis=2)
    if x.dtype == torch.bfloat16:
        return first_block_plain_bf16(x, w)
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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """The value of a bf16 cast, in fp32."""
    return t.bfloat16().float()


def first_block_hidden_bf16(x: torch.Tensor, w: FirstBlockWeights) -> torch.Tensor:
    """bf16 x (B, T) -> the 80 pre-activations (B, 80, T) in fp32, as
    :func:`first_block_plain_bf16` forms them: fp32 pools and branch convs,
    bf16 operands of product 1 with fp32 sums, b1 in fp32."""
    wf = FirstBlockWeights(*(t.float() for t in w))
    xc = x.float()[:, None, :]
    h = torch.cat([F.conv1d(trend_pool(xc, k), wf.branch_w[i][:, None, :], wf.branch_b[i],
                            padding=3) for i, k in enumerate(POOLS)], dim=1)
    return torch.einsum("oc,bct->bot", _bf16(wf.w1), _bf16(h)) + wf.b1[:, None]


def first_block_plain_bf16(x: torch.Tensor, w: FirstBlockWeights) -> torch.Tensor:
    """bf16 x (B, T) -> bf16 (B, Cout, T), rounding where the bf16 kernel
    does: fp32 pools and branch convs, bf16 operands of both products with
    fp32 sums, fp32 b1 and GELU, the raw sample's term in fp32."""
    wf = FirstBlockWeights(*(t.float() for t in w))
    xc = x.float()[:, None, :]
    g = _bf16(gelu(first_block_hidden_bf16(x, w)))
    y = torch.einsum("oc,bct->bot", wf.w2[:, :MID], g) + wf.b2[:, None]
    return (y + wf.w2[:, MID, None] * xc).to(x.dtype)


def padded_cout(Cout: int) -> int:
    """Output channels rounded up to the kernel's n8 tiles, and above
    COUT_TILE to whole tiles of COUT_TILE."""
    q = 8 if Cout <= COUT_TILE else COUT_TILE
    return -(-Cout // q) * q


def sections(Cout: int, bf16: bool = False) -> dict[str, tuple[int, ...]]:
    """The shapes of :func:`pack`'s parts, in 32-bit words, in the order of
    its buffer (the weights of ``csrc/first_block.cu``'s shared-memory
    Layout); ``bf16``: the bf16 kernel's."""
    Cp = padded_cout(Cout)
    if bf16:
        mats = {"w1": (MID // 8, 2, 32, 2), "w2": (MID // 16, Cp // 8, 32, 2)}
    else:
        mats = {"w1": (MID // 8, HID_PAD // 8, 32, 4), "w2": (MID // 8, Cp // 8, 32, 4)}
    return {**mats, "b1": (MID,), "b2": (Cp,), "wx": (Cp,), "branch_w": (5, 4, 7),
            "branch_b": (5, 4)}


def chunks(Cout: int, bf16: bool) -> list[tuple[int, int]]:
    """The (first, end) output channels of each launch: one for fp32, chunks
    of BF16_CHUNK for bf16."""
    step = BF16_CHUNK if bf16 else Cout
    return [(c, min(c + step, Cout)) for c in range(0, Cout, step)]


def packed_floats(Cout: int, bf16: bool = False) -> int:
    """The 32-bit words of :func:`pack`'s buffer (a bf16 stem's: its
    chunks' packs)."""
    return sum(math.prod(shape) for c0, c1 in chunks(Cout, bf16)
               for shape in sections(c1 - c0, bf16).values())


def _pairs(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two tensors of bf16 values -> one fp32 tensor whose bits hold the pair
    (``lo`` in the low half), as ``cvt.rn.bf16x2.f32`` packs it."""
    bits = lambda t: t.bfloat16().view(torch.int16).to(torch.int32) & 0xFFFF
    return (bits(lo) | (bits(hi) << 16)).view(torch.float32)


def _pack_bf16(w: FirstBlockWeights, Cout: int, Cp: int) -> dict[str, torch.Tensor]:
    """The bf16 kernel's products as m16n8k16 B fragments of bf16 pairs.

    - W1 [j][s][lane] (b0, b1), j < 10 the n8 tile of hidden units, s < 2 the
      k16 step; lane (g, t) of step 0 holds hidden inputs t, 4 + t (b0) and
      8 + t, 12 + t (b1), i.e. channel t of branches 0-3, and of step 1
      input 16 + t (branch 4) and zeros: the k order that puts each lane's
      own branch convs into its A fragment;
    - W2 [s][nt][lane] (b0, b1), s < 5 the k16 step over the 80 hidden
      units in their natural order (product 1's accumulator pairs are
      product 2's A fragment), nt < Cp / 8:
      ``b0 = W2[8nt + g, 16s + 2t .. +1]``, ``b1 = W2[8nt + g, 16s + 2t + 8 .. +9]``."""
    lane = torch.arange(32, device=w.w1.device)
    g, t = lane // 4, lane % 4
    w1 = w.w1.float()
    rows = 8 * torch.arange(MID // 8, device=lane.device)[:, None] + g   # (10, 32)
    z = torch.zeros(rows.shape, device=lane.device)
    s0 = torch.stack([_pairs(w1[rows, t], w1[rows, 4 + t]),
                      _pairs(w1[rows, 8 + t], w1[rows, 12 + t])], -1)
    s1 = torch.stack([_pairs(w1[rows, 16 + t], z), _pairs(z, z)], -1)
    f1 = torch.stack([s0, s1], 1)                                       # (10, 2, 32, 2)
    w2 = w.w2.new_zeros(Cp, MID, dtype=torch.float32)
    w2[:Cout] = w.w2[:, :MID].float()
    k0 = 16 * torch.arange(MID // 16, device=lane.device)[:, None, None] + 2 * t  # (5, 1, 32)
    rows = 8 * torch.arange(Cp // 8, device=lane.device)[None, :, None] + g       # (1, Cp/8, 32)
    f2 = torch.stack([_pairs(w2[rows, k0], w2[rows, k0 + 1]),
                      _pairs(w2[rows, k0 + 8], w2[rows, k0 + 9])], -1)
    return {"w1": f1, "w2": f2}


def k_slot(br: int, c: int) -> int:
    """Where branch ``br``'s channel ``c`` (hidden input 4 br + c) sits in the
    bf16 kernel's product-1 K of 32 (:func:`_pack_bf16`'s order; the other
    slots are zero): 2c, 2c + 1 for branches 0, 1; 8 + 2c, 9 + 2c for 2, 3;
    16 + 2c for 4 (the A fragments each lane of ``csrc/first_block_bf16.cu``
    packs from its branch convs)."""
    return (0 if br < 2 else 8 if br < 4 else 16) + 2 * c + (br & 1 if br < 4 else 0)


def admits(Cout: int) -> str | None:
    """Why the kernel does not take Cout output channels, or None when it
    does: every Cout >= 1."""
    return None if Cout >= 1 else f"the kernel takes Cout >= 1, got {Cout}"


def _check_shapes(w: FirstBlockWeights, name: str) -> int:
    Cout = w.w2.shape[0]
    if w.branch_w.shape != (5, 4, 7) or w.branch_b.shape != (5, 4) or \
            w.w1.shape != (MID, HID) or w.b1.shape != (MID,) or w.w2.shape != (Cout, MID + 1) or \
            w.b2.shape != (Cout,) or admits(Cout) is not None:
        raise ValueError(f"{name}: unexpected weight shapes {[tuple(t.shape) for t in w]}")
    return Cout


def pack(w: FirstBlockWeights) -> torch.Tensor:
    """The kernel's one weight buffer, fp32 on the weights' device, in the
    order of its shared-memory image (:func:`sections`; Cp =
    :func:`padded_cout`). A bf16 stem's products are :func:`_pack_bf16`'s
    bf16 pairs, its vectors the fp32 values of its bf16 parameters. fp32:

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
      convs (5, 4, 7) and their biases (5, 4), in fp32 as they are.

    A bf16 stem wider than BF16_CHUNK: the packs of its chunks of output
    channels (:func:`chunks`), concatenated."""
    Cout = _check_shapes(w, "first_block pack")
    Cp = padded_cout(Cout)
    if w.w1.dtype == torch.bfloat16 and Cout > BF16_CHUNK:
        return torch.cat([pack(w._replace(w2=w.w2[c0:c1], b2=w.b2[c0:c1]))
                          for c0, c1 in chunks(Cout, True)])
    if w.w1.dtype == torch.bfloat16:
        with torch.no_grad():
            wf = FirstBlockWeights(*(p.float() for p in w))
            vec = lambda v: F.pad(v, (0, Cp - Cout))
            parts = {**_pack_bf16(wf, Cout, Cp), "b1": wf.b1, "b2": vec(wf.b2),
                     "wx": vec(wf.w2[:, MID]), "branch_w": wf.branch_w,
                     "branch_b": wf.branch_b}
            return torch.cat([p.reshape(-1) for p in parts.values()]).contiguous()
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
    """``csrc/first_block.cu`` on fp32 x (B, T), ``csrc/first_block_bf16.cu`` on bf16."""
    B, T = x.shape
    prepared = isinstance(w, PreparedStem)
    weights = w.weights if prepared else w
    Cout = _check_shapes(weights, "first_block")
    bf16 = x.dtype == torch.bfloat16
    if (weights.w1.dtype == torch.bfloat16) != bf16:
        raise TypeError(f"first_block: x is {x.dtype}, the weights {weights.w1.dtype}")
    wp = w.packed if prepared else prepared_stem(w)
    if wp.shape != (packed_floats(Cout, bf16),):
        raise ValueError(f"first_block: packed weights {tuple(wp.shape)} do not match "
                         f"Cout = {Cout}")
    K.check_cuda({"x": x}, x.device, dtype=x.dtype)
    K.check_cuda({"weights": wp}, x.device)
    out = torch.empty((B, Cout, T), device=x.device, dtype=x.dtype)
    fn = _build.function("l3ac_first_block_bf16" if bf16 else "l3ac_first_block", _ARGTYPES)
    err = fn(x.data_ptr(), wp.data_ptr(), out.data_ptr(), B, T, Cout, _build.stream_ptr())
    _build.check(err, "first_block")
    K.LAUNCHES["first_block"] += 1
    if Cout > BF16_CHUNK:
        ROUTES["wide"] += 1
    return out


def first_block(x: torch.Tensor, w: FirstBlockWeights | PreparedStem, *,
                lh: torch.Tensor | None = None, rh: torch.Tensor | None = None,
                edges: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (B, T) fp32 or bf16 audio -> (B, Cout, T) in x's dtype. ``w``: the
    weights (of x's dtype), or a :class:`PreparedStem` whose buffer the
    kernel takes as it is. Kernel on CUDA (under autograd through
    ``autograd.call``: the backward differentiates the plain version on the
    weights, so a trainer passes a PreparedStem of the live weights), plain on
    CPU. ``lh`` / ``rh`` / ``edges``: JAX's SP operands, the neighbours'
    HALO (47) boundary samples (B, HALO) and the (first, last) shard flags;
    the kernel runs on ``[lh | x | rh]`` without the halo an edge shard does
    not have, and the halo columns are cropped (the stem's receptive field
    is 47 samples a side; JAX's kernel stages 25, ROADMAP C)."""
    K.check_input(x, "first_block x", ndim=2, dtype=K.DTYPES)
    weights = w.weights if isinstance(w, PreparedStem) else w
    if not K.route(x, "first_block"):
        return first_block_plain(x, weights, lh=lh, rh=rh, edges=edges)
    for h in (lh, rh):
        if h is not None and h.shape != (x.shape[0], HALO):
            raise ValueError(f"first_block: halo {tuple(h.shape)} is not {(x.shape[0], HALO)}")
    return autograd.call(
        "first_block",
        lambda: K.halo_call(lambda b: _launch(b, w), x, lh, rh, edges, axis=1, out_axis=2),
        lambda x, lh, rh, *ws: first_block_plain(x, FirstBlockWeights(*ws), lh=lh, rh=rh,
                                                 edges=edges),
        x, lh, rh, *weights)
