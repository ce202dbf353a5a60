"""The decoder's legacy tail: 3 x [x + conv1x1(snake(conv_k7,dil d(snake x)))]
for d in (1, 3, 9) -> snake -> conv k7 C -> 1 -> tanh, audio (B, T) out.

Replaces ``l3ac_tpu/ops/pallas/legacy_tail.py:legacy_tail_poly_ct`` (body
``_kernel_poly``: the input is the pair of stride-2 phase arrays that the last
up path emits) and ``:legacy_tail_ct`` (body ``_kernel``: one interleaved
(B, C, T) input) with one kernel, ``csrc/legacy_tail.cu``, with two input
modes.

Semantics are those of the jnp path (``models/decoder.py`` with
``legacy_unit_apply_t``): every conv zero-pads its input at the sequence
edges, which the kernel reproduces by zeroing outside [0, T) after every
conv, as the Pallas kernel does.

Bound on the H100: about 28 k fp32 operations per audio sample (three k7
convs C -> C and three 1x1 convs at C = 24) against 4 C bytes read and 4
written, so the fp32 rate bounds it. Design: one block per (batch, tile of
684 samples) with a halo of 42 samples per side (3 (1 + 3 + 9) + 3). The
block loads its tile in interleaved order into shared memory whichever mode
the input has, so the Pallas kernel's per-phase tap routing (a workaround for
Mosaic, which cannot interleave lanes) has no counterpart here. The chain
runs in shared memory: the residual stream and one activation buffer, with
all weights (55 KB at C = 24) beside them; each thread keeps 3 columns x C
accumulators of a conv in registers. Only the audio is written.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..activations import snake
from ..resample import interleave
from . import _build

DILATIONS = (1, 3, 9)
CHANNELS = (8, 12, 16, 24)  # the kernel's instantiations; every released config has 24


class TailWeights(NamedTuple):
    a1: torch.Tensor  # (3, C) snake before the k7 conv of each unit
    w1: torch.Tensor  # (3, C, C, 7) k7 convs (Conv1d layout)
    b1: torch.Tensor  # (3, C)
    a2: torch.Tensor  # (3, C) snake before the 1x1 conv
    w2: torch.Tensor  # (3, C, C) 1x1 convs (kernel axis squeezed)
    b2: torch.Tensor  # (3, C)
    ao: torch.Tensor  # (C,) the tail's last snake
    wo: torch.Tensor  # (1, C, 7) output conv
    bo: torch.Tensor  # (1,)


def legacy_tail_plain(x: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """(B, C, T) interleaved -> audio (B, T), in plain PyTorch."""
    for u, d in enumerate(DILATIONS):
        h = snake(x, w.a1[u][:, None])
        h = F.conv1d(h, w.w1[u], w.b1[u], padding=3 * d, dilation=d)
        h = snake(h, w.a2[u][:, None])
        x = x + torch.einsum("oc,bct->bot", w.w2[u], h) + w.b2[u][:, None]
    h = F.conv1d(snake(x, w.ao[:, None]), w.wo, w.bo, padding=3)
    return torch.tanh(h)[:, 0]


def pack(w: TailWeights) -> torch.Tensor:
    """The kernel's one weight buffer: w1 (3, 7, Cin, Cout), w2 (3, Cin,
    Cout), b1, a1, a2, b2 (3, C) each, ao (C), wo (7, C), bo, padded to a
    multiple of 4 floats."""
    parts = [w.w1.permute(0, 3, 2, 1), w.w2.permute(0, 2, 1), w.b1, w.a1, w.a2, w.b2,
             w.ao, w.wo[0].t(), w.bo]
    flat = torch.cat([p.reshape(-1) for p in parts])
    return F.pad(flat, (0, (-flat.numel()) % 4)).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_void_p]


def _launch(x0: torch.Tensor, x1: torch.Tensor | None, w: TailWeights, T: int,
            name: str) -> torch.Tensor:
    B, C = x0.shape[:2]
    if C not in CHANNELS:
        raise ValueError(f"{name}: the kernel takes C in {CHANNELS}, got {C}")
    shapes = {"a1": (3, C), "w1": (3, C, C, 7), "b1": (3, C), "a2": (3, C),
              "w2": (3, C, C), "b2": (3, C), "ao": (C,), "wo": (1, C, 7), "bo": (1,)}
    for k, shape in shapes.items():
        if tuple(getattr(w, k).shape) != shape:
            raise ValueError(f"{name}: {k} {tuple(getattr(w, k).shape)} is not {shape}")
    wp = pack(w)
    K.check_cuda({"x0": x0, "x1": x1, "weights": wp}, x0.device)
    out = torch.empty((B, T), device=x0.device, dtype=x0.dtype)
    fn = _build.function("l3ac_legacy_tail", _ARGTYPES)
    err = fn(x0.data_ptr(), _build.ptr(x1), wp.data_ptr(), out.data_ptr(), B, C, T,
             x0.stride(0), x0.stride(1), _build.stream_ptr())
    _build.check(err, name)
    K.LAUNCHES[name] += 1
    return out


def legacy_tail_poly_ct(x0: torch.Tensor, x1: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """Phase pair x0, x1 (B, C, Tt) of the interleaved input
    (``x[.., 2 t + q] = x_q[.., t]``) -> audio (B, 2 Tt). Kernel on CUDA,
    plain on CPU."""
    K.check_input(x0, "legacy_tail_poly_ct x0", ndim=3)
    K.check_input(x1, "legacy_tail_poly_ct x1", ndim=3)
    if x0.shape != x1.shape:
        raise ValueError(f"legacy_tail_poly_ct: phases {tuple(x0.shape)} and "
                         f"{tuple(x1.shape)} differ")
    if not K.route(x0, "legacy_tail_poly_ct"):
        return legacy_tail_plain(interleave([x0, x1], 2), w)
    return _launch(x0, x1, w, 2 * x0.shape[2], "legacy_tail_poly_ct")


def legacy_tail_ct(x: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """Interleaved (B, C, T) -> audio (B, T). Kernel on CUDA, plain on CPU."""
    K.check_input(x, "legacy_tail_ct x", ndim=3)
    if not K.route(x, "legacy_tail_ct"):
        return legacy_tail_plain(x, w)
    return _launch(x, None, w, x.shape[2], "legacy_tail_ct")
