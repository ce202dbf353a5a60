"""Decoder up path: 1x1 conv Ci -> Co, linear upsample x s (edge frame
repeated at both edges), ChannelNorm over Co (eps 1e-8 inside the sqrt).

Replaces ``l3ac_tpu/ops/pallas/upsample.py:up_fused_ct`` (body ``_kernel_ct``,
(B, C, T), with ``phase_split``) and ``:up_fused`` (body ``_kernel``,
(B, T, C)) with one kernel, ``csrc/up_fused.cu``, which takes the input and
output strides and so serves both wrappers.

Semantics are those of the jnp chain (``models/decoder.py:_up_path``): conv,
``upsample_linear`` with the phase weights of ``ops/resample.py``, then the
norm. ChannelNorm is per output position, so each phase is normalized on its
own. Phase p of the output, ``out[.., t s + p]``, reads
``z[t - 1], z[t], z[t + 1]`` of ``z = W x + b``.

Bound on the H100: per input column 2 Ci Co operations for the conv and
about 8 s Co for blend and norm, against 4 Ci bytes read and 4 s Co bytes
written; the wide (B, T, C) stages sit near the fp32 rate, the narrow
(B, C, T) ones on memory. Design: one block per (batch, tile of 32 or 64
input columns). The tile and one column on each side (clamped into [0, T),
which is torch's ``align_corners=False`` edge rule) go to shared memory; z
for those columns is computed there, four output channels per thread; the
per-(column, phase) moments over Co follow; then every output element is
blended, normalized and stored straight to its final address. The Pallas
kernel emits s phase arrays and an XLA pass interleaves them, because Mosaic
cannot interleave lanes; here the interleave is the store address, and
``phase_split`` only changes that address.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..norms import channel_norm
from ..resample import interleave, upsample_phases
from . import _build

MAX_C = 512
MAX_SCALE = 16


class UpWeights(NamedTuple):
    w: torch.Tensor              # (Co, Ci): the 1x1 conv, kernel axis squeezed
    b: torch.Tensor              # (Co,)
    norm_w: torch.Tensor | None  # (Co,) ChannelNorm, or None without norm
    norm_b: torch.Tensor | None


def up_fused_plain(x: torch.Tensor, w: UpWeights, *, scale: int, channel_dim: int,
                   phase_split: bool = False):
    """The up path in plain PyTorch. ``channel_dim`` is 1 for (B, C, T) and
    2 for (B, T, C). Returns the interleaved (.., T * scale, ..) tensor, or
    with ``phase_split`` the tuple of ``scale`` phase tensors."""
    t_dim = 3 - channel_dim
    if channel_dim == 1:
        z = torch.einsum("oc,bct->bot", w.w, x) + w.b[:, None]
    else:
        z = F.linear(x, w.w, w.b)
    phases = upsample_phases(z, scale, t_dim) if scale > 1 else [z]
    if w.norm_w is not None:
        phases = [channel_norm(p, w.norm_w, w.norm_b, dim=channel_dim) for p in phases]
    return tuple(phases) if phase_split else interleave(phases, t_dim)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 7 + \
    [ctypes.c_int, ctypes.c_void_p]
ORDER_TIME, ORDER_CHANNEL, ORDER_PHASE = 0, 1, 2  # fastest axis of the stores


def _launch(x: torch.Tensor, w: UpWeights, scale: int, *, channels_last: bool,
            phase_split: bool, name: str):
    B = x.shape[0]
    Ci, T = (x.shape[2], x.shape[1]) if channels_last else (x.shape[1], x.shape[2])
    Co = w.w.shape[0]
    if w.w.shape != (Co, Ci) or w.b.shape != (Co,):
        raise ValueError(f"{name}: weight {tuple(w.w.shape)} does not map Ci = {Ci}")
    if not (1 <= Ci <= MAX_C and 4 <= Co <= MAX_C and Co % 4 == 0):
        raise ValueError(f"{name}: the kernel takes Ci <= {MAX_C} and Co a multiple "
                         f"of 4 up to {MAX_C}, got Ci = {Ci}, Co = {Co}")
    if not 1 <= scale <= MAX_SCALE:
        raise ValueError(f"{name}: scale {scale} outside 1..{MAX_SCALE}")
    if (w.norm_w is None) != (w.norm_b is None):
        raise ValueError(f"{name}: norm weight and bias go together")
    wt = w.w.t().contiguous()                                   # (Ci, Co)
    K.check_cuda({"x": x, "wt": wt, "b": w.b, "norm_w": w.norm_w,
                  "norm_b": w.norm_b}, x.device)
    if phase_split:
        out = torch.empty((scale, B, Co, T), device=x.device, dtype=x.dtype)
        os_ = (Co * T, T, 1, B * Co * T)
        order = ORDER_PHASE
    elif channels_last:
        out = torch.empty((B, T * scale, Co), device=x.device, dtype=x.dtype)
        os_ = (T * scale * Co, 1, scale * Co, Co)
        order = ORDER_CHANNEL
    else:
        out = torch.empty((B, Co, T * scale), device=x.device, dtype=x.dtype)
        os_ = (Co * T * scale, T * scale, scale, 1)
        order = ORDER_TIME
    xs = (x.stride(0), 1, Ci) if channels_last else (x.stride(0), T, 1)
    fn = _build.function("l3ac_up_fused", _ARGTYPES)
    err = fn(x.data_ptr(), wt.data_ptr(), w.b.data_ptr(), _build.ptr(w.norm_w),
             _build.ptr(w.norm_b), out.data_ptr(), B, Ci, Co, T, scale,
             *xs, *os_, order, _build.stream_ptr())
    _build.check(err, name)
    K.LAUNCHES[name] += 1
    return tuple(out.unbind(0)) if phase_split else out


def up_fused_ct(x: torch.Tensor, w: UpWeights, *, scale: int,
                phase_split: bool = False):
    """(B, Ci, T) -> (B, Co, T * scale), or with ``phase_split`` the tuple of
    ``scale`` phases (B, Co, T) with ``out[.., t * scale + p] ==
    phases[p][.., t]``. Kernel on CUDA, plain on CPU."""
    K.check_input(x, "up_fused_ct x", ndim=3)
    if not K.route(x, "up_fused_ct"):
        return up_fused_plain(x, w, scale=scale, channel_dim=1, phase_split=phase_split)
    return _launch(x, w, scale, channels_last=False, phase_split=phase_split,
                   name="up_fused_ct")


def up_fused(x: torch.Tensor, w: UpWeights, *, scale: int) -> torch.Tensor:
    """(B, T, Ci) -> (B, T * scale, Co). Kernel on CUDA, plain on CPU."""
    K.check_input(x, "up_fused x", ndim=3)
    if not K.route(x, "up_fused"):
        return up_fused_plain(x, w, scale=scale, channel_dim=2)
    return _launch(x, w, scale, channels_last=True, phase_split=False, name="up_fused")
