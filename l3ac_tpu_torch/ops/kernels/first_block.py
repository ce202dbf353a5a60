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

Bound on the H100: ~7.6k fp32 operations per output column against 4 bytes
read and 4 Cout bytes written, so the fp32 rate (67 TFLOP/s without tensor
cores) bounds it, not memory. Design: one block per (batch, 256-column
tile), one thread per output column. The audio tile with its 47-sample halo
and the pooled signals live in shared memory; a column's 20 branch outputs
and 80 hidden activations live in registers, so nothing between the audio
and the output touches device memory.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..activations import gelu
from ..pool import trend_pool
from . import _build

POOLS = (1, 5, 11, 21, 45)
MAX_COUT = 64


class FirstBlockWeights(NamedTuple):
    branch_w: torch.Tensor  # (5, 4, 7): each branch's Conv1d(1, 4, 7) weight, in-channel squeezed
    branch_b: torch.Tensor  # (5, 4)
    w1: torch.Tensor        # (80, 20)
    b1: torch.Tensor        # (80,)
    w2: torch.Tensor        # (Cout, 81)
    b2: torch.Tensor        # (Cout,)


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


def first_block(x: torch.Tensor, w: FirstBlockWeights) -> torch.Tensor:
    """x: (B, T) fp32 audio -> (B, Cout, T). Kernel on CUDA, plain on CPU."""
    K.check_input(x, "first_block x", ndim=2)
    if not K.route(x, "first_block"):
        return first_block_plain(x, w)
    B, T = x.shape
    Cout = w.w2.shape[0]
    if w.branch_w.shape != (5, 4, 7) or w.w1.shape != (80, 20) or \
            w.w2.shape != (Cout, 81) or not 1 <= Cout <= MAX_COUT:
        raise ValueError(f"first_block: unexpected weight shapes "
                         f"{[tuple(t.shape) for t in w]}")
    K.check_cuda({"x": x, **w._asdict()}, x.device)
    out = torch.empty((B, Cout, T), device=x.device, dtype=x.dtype)
    fn = _build.function("l3ac_first_block", [ctypes.c_void_p] * 8 +
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(), B, T,
             Cout, _build.stream_ptr())
    _build.check(err, "first_block")
    K.LAUNCHES["first_block"] += 1
    return out
