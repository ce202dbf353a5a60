"""Decoder up path: 1x1 conv Ci -> Co, linear upsample x s (edge frame
repeated at both edges), ChannelNorm over Co (eps 1e-8 inside the sqrt).

Replaces ``l3ac_tpu/ops/pallas/upsample.py:up_fused_ct`` (body ``_kernel_ct``,
(B, C, T), with ``phase_split``) and ``:up_fused`` (body ``_kernel``,
(B, T, C)). Three kernels, chosen by shape (:func:`route_for`), never by
failure:

- ``csrc/up_fused_tc_bf16.cu`` (route ``"wgmma"``): bf16 (B, T, C) with
  Ci % 8 == 0 up to 1024 and Co a multiple of 32 up to 256, the bf16 wide
  stages of every released config. A persistent grid of 64-row tiles (62
  owned), x and W by TMA from a producer warp into a ring, the conv on
  wgmma (two warpgroups, Co / 2 columns each), the norm's statistics and
  the interleaved stores in the epilogue while the next tile loads. It reads
  the ``"tc"`` buffer (at these shapes W as it is, unpadded).

- ``csrc/up_fused_tc.cu`` (route ``"tc"``): fp32 (B, T, C) with Ci a
  multiple of 4 and Co a multiple of 32 up to 256, the wide stages of every
  released config, and every other (B, T, C) shape with Ci <= 1024 and Co
  <= 512 that the other kernels do not take (its bf16 instance: bf16 shapes
  the wgmma kernel does not take) (Co zero-padded in the weight buffer,
  :func:`tc_padded_co`). The conv runs on the tensor cores (3xTF32
  mma.sync, time as the M axis); a block owns all Co columns of
  62 rows (30 above Co = 256) and its two halo rows, and its epilogue
  blends, normalizes and stores each output row at its interleaved address.
- ``csrc/up_fused.cu`` (route ``"stream"``): a streaming pass for
  Ci <= 128 and Co <= 128 in either layout (the narrow (B, C, T) stages,
  ``phase_split`` included), bound by its bytes; its conv also runs on the
  tensor cores, with the output channels as the M axis. On bf16 (B, C, T)
  input the stream route runs ``csrc/up_fused_bf16.cu`` instead (warp
  tiles on a persistent grid, x staged in bf16 by 16-byte pieces a tile
  ahead, W resident in mma.sync A-fragment order, z and the norm's
  statistics in registers); the bf16 instance of ``up_fused.cu`` serves only
  the (B, T, C) input at stream shapes (:func:`stream_buffer`).

- ``csrc/general_gemm.cu`` and ``csrc/general_rows.cu`` (route ``"general"``):
  every other shape, as the JAX
  kernels take any Ci and Co (``l3ac_tpu/ops/pallas/upsample.py:159-160``;
  ROADMAP C3): the (B, C, T) stages past 128 channels and the (B, T, C) ones
  past Ci 1024 or Co 512, both layouts, both dtypes and ``phase_split``.
  The general product (``conv_unit.general_gemm``, on the tensor cores)
  writes z = W x + b (fp32) for every input row, x read in place in either
  layout (a contiguous (B, T, C) x on the fast GEMM cores, (B, C, T) on
  ``general_gemm.cu``'s product, x's time rows staged by 16-byte blocks at
  any offset; ``conv_unit.GEMM_ROUTES`` counts which); then
  the blend + norm pass of ``csrc/general_rows.cu``: a block per tile of z
  rows (staged once in shared memory, the edge frame repeated) blends each
  phase from z's rows t - 1, t, t + 1 (the plain version's products and
  sum), takes ChannelNorm's statistics one warp per output row (over Co in
  chunks where a row does not fit) and stores at the interleaved (or phase)
  address, rounded once to x's dtype: channels-last rows as they are, the
  channels-first and ``phase_split`` outputs as each channel's contiguous
  run of time samples. Its weights are the ``"general"`` buffer (W as it
  is, contiguous; fp32: ``"general_split"``, its TF32 hi / lo) and the
  ``"general_vec"`` one (b, norm_w, norm_b in fp32).

The plain version runs only for a CPU tensor.

bf16 (x bf16 with bf16 weights): each kernel's bf16 variant, one bf16
tensor-core pass with fp32 sums; the bias, the blend and the norm in fp32
from the bf16 parameters, and one rounding at the store, where
``l3ac_tpu/ops/pallas/upsample.py`` rounds (``_kernel`` / ``_kernel_ct``,
``out_shape`` in x's dtype). :func:`up_fused_plain_bf16` rounds at the same
point.

Semantics are those of the jnp chain (``models/decoder.py:_up_path``): conv,
``upsample_linear`` with the phase weights of ``ops/resample.py``, then the
norm. ChannelNorm is per output position, so each phase is normalized on its
own. Phase p of the output, ``out[.., t s + p]``, reads
``z[t - 1], z[t], z[t + 1]`` of ``z = W x + b``. The Pallas kernel emits s
phase arrays and an XLA pass interleaves them, because Mosaic cannot
interleave lanes; here the interleave is the store address, and
``phase_split`` only changes that address.

The kernels read their weights from a buffer prepared once per weight set
and route (:class:`UpPrepared`, cached by :func:`prepared_up` or, in the
model, ``Stage.up_prepared``), never transposed per call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as K
from ..norms import channel_norm
from ..resample import interleave, phase_weights, upsample_phases
from . import _build, autograd
from .conv_unit import cached_prepare, general_gemm
from .tc_gemm import split_tf32

MAX_SCALE = 16
TC_MAX_CO = 256                        # up_fused_tc.cu at Co % 32 == 0, Ci % 4 == 0 ...
TC_WIDE_MAX_CI, TC_WIDE_MAX_CO = 1024, 512  # ... and at any other Ci, Co up to these
STREAM_MAX_CI, STREAM_MAX_CO = 128, 128  # up_fused.cu
TC_OWN_ROWS = 62                        # up_fused_tc.cu: rows a block stores (64 z rows)
ROUTES: dict[str, int] = {"wgmma": 0, "tc": 0, "stream": 0, "general": 0}  # launches by kernel


class UpWeights(NamedTuple):
    w: torch.Tensor              # (Co, Ci): the 1x1 conv, kernel axis squeezed
    b: torch.Tensor              # (Co,)
    norm_w: torch.Tensor | None  # (Co,) ChannelNorm, or None without norm
    norm_b: torch.Tensor | None


def _halo_args(channel_dim: int, scale: int, phase_split: bool) -> dict:
    """How :func:`K.halo_call` stages and crops the up path: time axis in,
    time axis out and the output frames per input frame."""
    t_dim = 3 - channel_dim
    if phase_split:
        return {"axis": t_dim, "out_axis": -1, "scale": 1}
    return {"axis": t_dim, "out_axis": t_dim, "scale": scale}


def up_fused_plain(x: torch.Tensor, w: UpWeights, *, scale: int, channel_dim: int,
                   phase_split: bool = False, lh: torch.Tensor | None = None,
                   rh: torch.Tensor | None = None, edges: tuple[int, int] | None = None):
    """The up path in plain PyTorch. ``channel_dim`` is 1 for (B, C, T) and
    2 for (B, T, C). Returns the interleaved (.., T * scale, ..) tensor, or
    with ``phase_split`` the tuple of ``scale`` phase tensors. ``lh`` / ``rh``
    / ``edges``: SP halo frames (one a side, in x's layout), staged as the
    kernel's wrapper stages them."""
    if lh is not None or rh is not None:
        return K.halo_call(lambda b: up_fused_plain(b, w, scale=scale, channel_dim=channel_dim,
                                                    phase_split=phase_split),
                           x, lh, rh, edges, **_halo_args(channel_dim, scale, phase_split))
    t_dim = 3 - channel_dim
    if channel_dim == 1:
        z = torch.einsum("oc,bct->bot", w.w, x) + w.b[:, None]
    else:
        z = F.linear(x, w.w, w.b)
    phases = upsample_phases(z, scale, t_dim) if scale > 1 else [z]
    if w.norm_w is not None:
        phases = [channel_norm(p, w.norm_w, w.norm_b, dim=channel_dim) for p in phases]
    return tuple(phases) if phase_split else interleave(phases, t_dim)


def up_fused_plain_bf16(x: torch.Tensor, w: UpWeights, *, scale: int, channel_dim: int,
                        phase_split: bool = False, lh: torch.Tensor | None = None,
                        rh: torch.Tensor | None = None, edges: tuple[int, int] | None = None):
    """The bf16 kernels' function in plain PyTorch: the bf16 values in fp32
    (the conv's products exact, its sums fp32), the blend and the norm in
    fp32, one rounding to x's dtype at the end. Halos as
    :func:`up_fused_plain` takes them."""
    if lh is not None or rh is not None:
        return K.halo_call(lambda b: up_fused_plain_bf16(b, w, scale=scale,
                                                         channel_dim=channel_dim,
                                                         phase_split=phase_split),
                           x, lh, rh, edges, **_halo_args(channel_dim, scale, phase_split))
    w32 = UpWeights(*(None if t is None else t.float() for t in w))
    out = up_fused_plain(x.float(), w32, scale=scale, channel_dim=channel_dim,
                         phase_split=phase_split)
    return tuple(p.to(x.dtype) for p in out) if phase_split else out.to(x.dtype)


def route_for(Ci: int, Co: int, channels_last: bool, bf16: bool = False,
              x_ptr: int = 0) -> str | None:
    """The kernel that takes this shape (and dtype: ``bf16``; and x's data
    address ``x_ptr``: the TMA of ``"wgmma"`` reads x from a 16-byte aligned
    base, an unaligned x takes ``"tc"``, whose copies of x go element by
    element there): ``"wgmma"``, ``"tc"``, ``"stream"``, ``"general"`` (any
    other Ci, Co >= 1), or None for Ci or Co < 1."""
    if Ci < 1 or Co < 1:
        return None
    if bf16 and channels_last and Ci % 8 == 0 and 8 <= Ci <= TC_WIDE_MAX_CI and \
            Co % 32 == 0 and 32 <= Co <= TC_MAX_CO and x_ptr % 16 == 0:
        return "wgmma"
    if channels_last and Ci % 4 == 0 and Co % 32 == 0 and 32 <= Co <= TC_MAX_CO:
        return "tc"
    if 1 <= Ci <= STREAM_MAX_CI and 1 <= Co <= STREAM_MAX_CO:
        return "stream"
    if channels_last and 1 <= Ci <= TC_WIDE_MAX_CI and 1 <= Co <= TC_WIDE_MAX_CO:
        return "tc"
    return "general"


def stream_buffer(dtype: torch.dtype, channels_last: bool) -> str:
    """The :class:`UpPrepared` buffer (and so the kernel) of the stream
    route: ``"stream_bf16"`` (``csrc/up_fused_bf16.cu``) for bf16 (B, C, T)
    input, else ``"stream"`` (``csrc/up_fused.cu``: fp32, and bf16 (B, T, C))."""
    return "stream_bf16" if dtype == torch.bfloat16 and not channels_last else "stream"


def tc_padded_co(Co: int) -> int:
    """Co as the tensor-core kernel's tile holds it: rounded up to 32, and
    above 256 to 64 (its warps cover 32 columns, in pairs above 256)."""
    q = 32 if Co <= TC_MAX_CO else 64
    return -(-Co // q) * q


def tc_row_elems(Ci: int, dtype: torch.dtype) -> int:
    """The row length of W in the ``"tc"`` buffer: Ci rounded up to 4 (fp32)
    or 8 (bf16), 16 bytes either way."""
    q = 8 if dtype == torch.bfloat16 else 4
    return -(-Ci // q) * q


def prepare_up(w: UpWeights, route: str) -> torch.Tensor:
    """One buffer: the conv weight as its kernel reads it, then b, then
    norm_w and norm_b where there is a norm. ``"tc"``: W (Co, Ci) in its
    nn.Linear layout (K-major), the tensor-core kernel's B operand (split
    into TF32 hi / lo as its fragments are loaded), its rows zero-padded to
    (:func:`tc_padded_co`) and its columns to :func:`tc_row_elems`, b and
    the norm to the same padded Co; in the weights' dtype (fp32, or bf16 for
    the bf16 kernel). ``"stream"``: W zero-padded to (Co rounded up to 16, Ci
    rounded up to 8, plus 4), the A operand's rows as the kernel stages them;
    fp32 for both of ``up_fused.cu``'s instances (a bf16 weight set's values,
    exact). ``"stream_bf16"`` (``up_fused_bf16.cu``): W zero-padded to (Co,
    Ci) rounded up to 16 in the A-fragment order of mma.sync m16n8k16
    (:func:`stream_bf16_fragments`), then b, norm_w and norm_b zero-padded to
    the same Co; all bf16. ``"general"``: W (Co, Ci) as it is, contiguous,
    in its dtype; ``"general_split"``: fp32 W split into TF32 hi / lo, (2,
    Co, Ci); ``"general_vec"``: b, norm_w, norm_b in fp32."""
    with torch.no_grad():
        Co, Ci = w.w.shape
        vec = lambda v: v
        dtype = torch.float32
        if route == "tc":
            Cp = tc_padded_co(Co)
            dtype = w.w.dtype
            wk = F.pad(w.w, (0, tc_row_elems(Ci, dtype) - Ci, 0, Cp - Co))
            vec = lambda v: F.pad(v, (0, Cp - Co))
        elif route == "stream":
            wk = F.pad(w.w, (0, -(-Ci // 8) * 8 + 4 - Ci, 0, -(-Co // 16) * 16 - Co))
        elif route == "stream_bf16":
            Mp = -(-Co // 16) * 16
            wk = stream_bf16_fragments(w.w)
            dtype = torch.bfloat16
            vec = lambda v: F.pad(v, (0, Mp - Co))
        elif route == "general":
            return w.w.contiguous()
        elif route == "general_split":
            return torch.stack(split_tf32(w.w.float().contiguous()))
        elif route == "general_vec":
            return torch.cat([v.float().reshape(-1) for v in (w.b, w.norm_w, w.norm_b)
                              if v is not None])
        else:
            raise ValueError(f"prepare_up: unknown route {route!r}")
        parts = [wk] + [vec(v) for v in (w.b, w.norm_w, w.norm_b) if v is not None]
        return torch.cat([t.reshape(-1).to(dtype) for t in parts])


def stream_bf16_fragments(w: torch.Tensor) -> torch.Tensor:
    """W (Co, Ci) zero-padded to multiples of 16 and laid out as
    ``up_fused_bf16.cu`` reads it: [m16 tile][k16 step][lane][register][pair],
    register j of lane 4 g + t holding row g + 8 (j % 2) and columns 2t + 8
    (j // 2) + (0, 1) of the tile (mma.sync m16n8k16's A fragment)."""
    Co, Ci = w.shape
    Mp, Kp = -(-Co // 16) * 16, -(-Ci // 16) * 16
    wp = F.pad(w, (0, Kp - Ci, 0, Mp - Co)).view(Mp // 16, 16, Kp // 16, 16).permute(0, 2, 1, 3)
    lane, j = torch.arange(32)[:, None, None], torch.arange(4)[None, :, None]
    rows = (lane // 4 + 8 * (j % 2)).expand(32, 4, 2)
    cols = 2 * (lane % 4) + 8 * (j // 2) + torch.arange(2)
    return wp[:, :, rows, cols].contiguous()   # (Mp / 16, Kp / 16, 32, 4, 2)


class UpPrepared(dict):
    """route -> :func:`prepare_up` buffer, each built at its first use; one
    object per weight set (its cache is :func:`prepared_up` or
    ``Stage.up_prepared``, through ``cached_prepare``)."""

    def buffer(self, route: str, w: UpWeights) -> torch.Tensor:
        if route not in self:
            self[route] = prepare_up(w, route)
        return self[route]


def _sources(w: UpWeights) -> tuple[torch.Tensor, ...]:
    return tuple(t for t in w if t is not None)


def prepared_up(w: UpWeights) -> UpPrepared:
    """The :class:`UpPrepared` of ``w``, cached on its tensors (rebuilt when
    one changes, never cached for inference tensors)."""
    return cached_prepare(w.w, _sources(w), UpPrepared)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 7 + \
    [ctypes.c_int, ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_TC_BF16_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_WGMMA_ARGTYPES = _TC_BF16_ARGTYPES
_CT_BF16_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_GENERAL_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p]
_TAPS: dict[tuple, torch.Tensor] = {}


def phase_taps(scale: int, device: torch.device) -> torch.Tensor:
    """The (scale, 3) fp32 (prev, cur, next) weights of each phase
    (``ops.resample.phase_weights``) on ``device``, cached."""
    key = (scale, str(device))
    if key not in _TAPS:
        _TAPS[key] = torch.tensor(phase_weights(scale), dtype=torch.float32, device=device)
    return _TAPS[key]
ORDER_TIME, ORDER_CHANNEL, ORDER_PHASE = 0, 1, 2  # fastest axis of the stores


def _launch(x: torch.Tensor, w: UpWeights, scale: int, *, channels_last: bool,
            phase_split: bool, name: str, prepared: UpPrepared | None):
    B = x.shape[0]
    Ci, T = (x.shape[2], x.shape[1]) if channels_last else (x.shape[1], x.shape[2])
    Co = w.w.shape[0]
    if w.w.shape != (Co, Ci) or w.b.shape != (Co,):
        raise ValueError(f"{name}: weight {tuple(w.w.shape)} does not map Ci = {Ci}")
    if not 1 <= scale <= MAX_SCALE:
        raise ValueError(f"{name}: scale {scale} outside 1..{MAX_SCALE}")
    if (w.norm_w is None) != (w.norm_b is None):
        raise ValueError(f"{name}: norm weight and bias go together")
    if w.w.dtype != x.dtype:
        raise TypeError(f"{name}: x is {x.dtype} but the weights are {w.w.dtype}")
    bf16 = x.dtype == torch.bfloat16
    route = route_for(Ci, Co, channels_last, bf16, x.data_ptr())
    if route is None:
        raise ValueError(f"{name}: Ci = {Ci}, Co = {Co} is not a width")
    kind = stream_buffer(x.dtype, channels_last) if route == "stream" else \
        "general" if route == "general" else "tc"
    buf = (prepared if prepared is not None else prepared_up(w)).buffer(kind, w)
    K.check_cuda({"x": x}, x.device, dtype=K.DTYPES)
    K.check_cuda({"prepared": buf}, x.device,
                 dtype=torch.bfloat16 if bf16 and kind != "stream" else torch.float32)
    if phase_split:
        out = torch.empty((scale, B, Co, T), device=x.device, dtype=x.dtype)
        os_ = (Co * T, T, 1, B * Co * T)
    elif channels_last:
        out = torch.empty((B, T * scale, Co), device=x.device, dtype=x.dtype)
        os_ = (T * scale * Co, 1, scale * Co, Co)
    else:
        out = torch.empty((B, Co, T * scale), device=x.device, dtype=x.dtype)
        os_ = (Co * T * scale, T * scale, scale, 1)
    if route == "general":
        vec = (prepared if prepared is not None else prepared_up(w)).buffer("general_vec", w)
        K.check_cuda({"general_vec": vec}, x.device)
        z = torch.empty((B * T, Co), device=x.device)
        a_map = (T, x.stride(0), Ci, 1) if channels_last else (T, x.stride(0), 1, T)
        if bf16:
            b, b_lo = buf, None
        else:  # the TF32 hi / lo pair, as the fp32 tensor-core product reads B
            b, b_lo = (prepared if prepared is not None else prepared_up(w)).buffer(
                "general_split", w)
        general_gemm(x, a_map, b, b_lo, vec[:Co], z, (B * T, 0, Co, 1), B * T)
        p_nw, p_nb = (None, None) if w.norm_w is None else (vec[Co:2 * Co], vec[2 * Co:])
        fn = _build.function("l3ac_general_up", _GENERAL_ARGTYPES)
        err = fn(z.data_ptr(), phase_taps(scale, x.device).data_ptr(), _build.ptr(p_nw),
                 _build.ptr(p_nb), out.data_ptr(), *os_, B, T, Co, scale, int(bf16),
                 _build.stream_ptr())
    elif route in ("tc", "wgmma"):
        Cp, es = tc_padded_co(Co), buf.element_size()
        p_b = buf.data_ptr() + es * Cp * tc_row_elems(Ci, buf.dtype)
        p_nw, p_nb = (None, None) if w.norm_w is None else (p_b + es * Cp, p_b + 2 * es * Cp)
        if route == "wgmma":
            fn = _build.function("l3ac_up_fused_wgmma_bf16", _WGMMA_ARGTYPES)
            err = fn(x.data_ptr(), buf.data_ptr(), p_b, p_nw, p_nb, out.data_ptr(), B, Ci, Co, T,
                     scale, _build.stream_ptr())
        elif bf16:
            fn = _build.function("l3ac_up_fused_tc_bf16", _TC_BF16_ARGTYPES)
            err = fn(x.data_ptr(), buf.data_ptr(), p_b, p_nw, p_nb, out.data_ptr(), B, Ci, Co, T,
                     scale, _build.stream_ptr())
        else:
            fn = _build.function("l3ac_up_fused_tc", _TC_ARGTYPES)
            err = fn(x.data_ptr(), buf.data_ptr(), None, p_b, p_nw, p_nb, out.data_ptr(), B, Ci,
                     Co, T, scale, _build.stream_ptr())
    elif kind == "stream_bf16":
        fn = _build.function("l3ac_up_fused_ct_bf16", _CT_BF16_ARGTYPES)
        err = fn(x.data_ptr(), buf.data_ptr(), out.data_ptr(), int(w.norm_w is not None), B, Ci,
                 Co, T, scale, int(phase_split), _build.stream_ptr())
    else:
        order = ORDER_PHASE if phase_split else ORDER_CHANNEL if channels_last else ORDER_TIME
        xs = (x.stride(0), 1, Ci) if channels_last else (x.stride(0), T, 1)
        fn = _build.function("l3ac_up_fused_bf16" if bf16 else "l3ac_up_fused", _ARGTYPES)
        err = fn(x.data_ptr(), buf.data_ptr(), out.data_ptr(), int(w.norm_w is not None),
                 B, Ci, Co, T, scale, *xs, *os_, order, _build.stream_ptr())
    _build.check(err, name)
    ROUTES[route] += 1
    K.LAUNCHES[name] += 1
    return out


def _call(x: torch.Tensor, w: UpWeights, scale: int, *, channels_last: bool,
          phase_split: bool, name: str, prepared: UpPrepared | None, lh=None, rh=None,
          edges=None):
    """The launch through ``autograd.call``: under autograd the backward
    differentiates :func:`up_fused_plain` (its phases stacked as the launch
    returns them, (scale, B, Co, T)) on the weights. With halos the launch
    runs on the staged buffer and its outputs are cropped."""
    cd = 2 if channels_last else 1
    halo = _halo_args(cd, scale, False)
    for h in (lh, rh):
        if h is not None and h.shape[halo["axis"]] != 1:
            raise ValueError(f"{name}: an up path's halo is one frame, got {tuple(h.shape)}")

    def launch():
        return K.halo_call(lambda b: _launch(b, w, scale, channels_last=channels_last,
                                             phase_split=phase_split, name=name,
                                             prepared=prepared),
                           x, lh, rh, edges, axis=halo["axis"],
                           out_axis=-1 if phase_split else halo["out_axis"],
                           scale=1 if phase_split else scale)

    def plain(x, lh, rh, *ws):
        out = up_fused_plain(x, UpWeights(*ws), scale=scale, channel_dim=cd,
                             phase_split=phase_split, lh=lh, rh=rh, edges=edges)
        return torch.stack(out) if phase_split else out

    # the halos are inputs too: under SP training their gradient goes back
    # to the neighbours (parallel.sp)
    out = autograd.call(name, launch, plain, x, lh, rh, *w)
    return tuple(out.unbind(0)) if phase_split else out


def up_fused_ct(x: torch.Tensor, w: UpWeights, *, scale: int, phase_split: bool = False,
                prepared: UpPrepared | None = None, lh: torch.Tensor | None = None,
                rh: torch.Tensor | None = None, edges: tuple[int, int] | None = None):
    """(B, Ci, T) -> (B, Co, T * scale), or with ``phase_split`` the tuple of
    ``scale`` phases (B, Co, T) with ``out[.., t * scale + p] ==
    phases[p][.., t]``; fp32 or bf16. Kernel on CUDA (under autograd with the
    plain version's gradient), plain on CPU. ``prepared``: the weights'
    :class:`UpPrepared` (default: :func:`prepared_up`). ``lh`` / ``rh``: JAX's
    SP operands, the neighbours' boundary frame (B, Ci, 1) each (on an edge
    shard JAX passes the shard's own edge frame, the clamp); with ``edges``
    the halo of an edge shard is not staged and the kernel clamps there."""
    K.check_input(x, "up_fused_ct x", ndim=3, dtype=K.DTYPES)
    if not K.route(x, "up_fused_ct"):
        plain = up_fused_plain_bf16 if x.dtype == torch.bfloat16 else up_fused_plain
        return plain(x, w, scale=scale, channel_dim=1, phase_split=phase_split, lh=lh, rh=rh,
                     edges=edges)
    return _call(x, w, scale, channels_last=False, phase_split=phase_split,
                 name="up_fused_ct", prepared=prepared, lh=lh, rh=rh, edges=edges)


def up_fused(x: torch.Tensor, w: UpWeights, *, scale: int,
             prepared: UpPrepared | None = None, lh: torch.Tensor | None = None,
             rh: torch.Tensor | None = None,
             edges: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, T, Ci) -> (B, T * scale, Co), fp32 or bf16. Kernel on CUDA (under
    autograd with the plain version's gradient), plain on CPU. Halos (B, 1,
    Ci) as :func:`up_fused_ct` takes them."""
    K.check_input(x, "up_fused x", ndim=3, dtype=K.DTYPES)
    if not K.route(x, "up_fused"):
        plain = up_fused_plain_bf16 if x.dtype == torch.bfloat16 else up_fused_plain
        return plain(x, w, scale=scale, channel_dim=2, lh=lh, rh=rh, edges=edges)
    return _call(x, w, scale, channels_last=True, phase_split=False, name="up_fused",
                 prepared=prepared, lh=lh, rh=rh, edges=edges)
