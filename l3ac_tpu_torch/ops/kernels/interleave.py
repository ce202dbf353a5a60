"""s-fold interleaved store of bf16 data, in the lane layout (B, C, T) ->
(B, C, T s), ``out[b, c, t s + p] = x[b, c, t]``, or the sublane layout
(B, T, C) -> (B, T s, C), ``out[b, t s + p, c] = x[b, t, c]``.

Replaces the TPU probe ``tools/test_interleave.py`` (``pallas_call`` at :79
and :102; bodies ``kA``, ``kB``, ``kC``, ``kD``) with ``csrc/interleave.cu``.
``packed`` picks the store strategy, the Hopper counterpart of the probe's
two: strided stores, one per copy (its A and D), or the s copies built in
registers and written as one contiguous vector (its B and C). Both write the
whole length; the probe's grid leaves the columns past its last whole tile
unwritten (ROADMAP C). A pure copy, bound by bytes on the H100: 2 (1 + s)
bytes per input element.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from . import _build


def interleave_plain(x: torch.Tensor, s: int, channels_last: bool = False) -> torch.Tensor:
    """The same copy in plain PyTorch: stack s copies, then reshape."""
    B, A, Z = x.shape
    if channels_last:
        return x.unsqueeze(2).expand(B, A, s, Z).reshape(B, A * s, Z)
    return x.unsqueeze(3).expand(B, A, Z, s).reshape(B, A, Z * s)


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch(x: torch.Tensor, s: int, channels_last: bool, packed: bool) -> torch.Tensor:
    K.check_cuda({"interleave x": x}, x.device, dtype=torch.bfloat16)
    if packed and x.data_ptr() % 16:
        raise ValueError("interleave: packed stores need x 16-byte aligned")
    B, A, Z = x.shape
    N, L = (B * A, Z) if channels_last else (x.numel(), 1)
    out = torch.empty((B, A * s, Z) if channels_last else (B, A, Z * s),
                      device=x.device, dtype=x.dtype)
    fn = _build.function("l3ac_interleave", _ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), N, L, s, int(packed), _build.stream_ptr())
    _build.check(err, "interleave")
    K.LAUNCHES["interleave"] += 1
    return out


def interleave(x: torch.Tensor, s: int, channels_last: bool = False,
               packed: bool = False) -> torch.Tensor:
    """x (B, C, T) -> (B, C, T s), or with ``channels_last`` (B, T, C) ->
    (B, T s, C); bf16 only. Kernel on CUDA, plain on CPU."""
    K.check_input(x, "interleave x", ndim=3, dtype=torch.bfloat16)
    if s < 1:
        raise ValueError(f"interleave: s = {s} < 1")
    if not K.route(x, "interleave"):
        return interleave_plain(x, s, channels_last)
    return _launch(x, s, channels_last, packed)
