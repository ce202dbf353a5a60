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

The kernel runs the products on the tensor cores (3xTF32 mma.sync, time as
the M axis, the dilated k7 conv as 7 row-shifted products) from one weight
buffer, :func:`pack`: the k7 and 1x1 weights in (out, in) rows zero-filled to
multiples of 8 and split into TF32 hi / lo, the biases and alphas, and the
snakes' reciprocals 1 / (alpha + eps). A caller that holds its weights
prepares it once: :func:`prepared_tail` caches it on the weight tensors
(``conv_unit.cached_prepare``: rebuilt when one of them is replaced or changed
in place, never cached for an inference tensor), and ``models.decoder``
passes the buffer it cached with its stacked weights. Bound on the H100 and
design: the note at the head of ``csrc/legacy_tail.cu``.

Widths: every C >= 1, as the JAX kernel takes (its BlockSpecs hold the
whole C, ``l3ac_tpu/ops/pallas/legacy_tail.py:245``; ROADMAP C3).
:func:`route_for` is the rule (:func:`admits` refuses only C < 1). The
tensor-core kernels take C a multiple of 4 up to ``MAX_C`` (64); up to 24
channels they keep every weight in shared memory, wider they read the
matrices from device memory. Every other C runs the general route: seven
launches of the general product, ``csrc/general_gemm.cu``
(``conv_unit.window_gemm``; ``GENERAL_PRODUCTS``, each counted in
``conv_unit.GEMM_ROUTES["mma"]``), and no elementwise pass: per unit the k7
conv and the 1x1 conv, then the output conv. Each snake is the prologue of
the product that reads its output, applied once per staged element of the
product's window (a k7 conv is seven products on row-shifted views of one
window, all of C up to 256 channels where shared memory allows); the first
unit reads the phase pair or the
interleaved input in place, for its k7 conv's window and, through the
same address map, for the residual of its 1x1 conv. Each 1x1 conv adds the
residual in its epilogue (rounding the product + bias first where bf16
rounds, ``round_mid``), the output conv applies tanh there. Scratch: the
residual stream and the k7 convs' output, two (B, C, T) buffers. Its
operands are :func:`prepared_general`'s tap-major weights and fp32 vectors
(cached like the pack). ``ROUTES`` counts the launches of each route.

bf16 (x bf16 with bf16 weights): ``csrc/legacy_tail_bf16.cu``, one bf16
tensor-core pass per product (m16n8k16, the k7 conv's taps folded into one K),
rounding where ``l3ac_tpu/ops/pallas/legacy_tail.py`` does (its activations
stay in the input dtype between steps: each snake in fp32 then rounded, each
conv's fp32 sum + bias rounded, the residual ``x + h`` rounded after every
unit; the output conv and tanh in fp32, the audio rounded once). Its buffer
is :func:`pack_bf16` (``pack`` of bf16 weights). :func:`legacy_tail_plain_bf16`
rounds at the same points.

Sequence parallelism: both entry points take JAX's ``lh`` / ``rh`` /
``edges`` (HALO = 42 frames a side, PHALO = 21 of each phase, and the
(first, last) shard flags). The wrapper stages ``[lh | x | rh]`` (no halo on
the side of a global edge, where the kernel's per-conv zero padding is the
monolithic one), launches the kernel on it and crops the halo's audio
(``ops.kernels.halo_call``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...parallel import sp
from .. import kernels as K
from ..activations import EPS, snake
from ..resample import interleave
from . import _build, autograd
from .conv_unit import ACT_TANH, cached_prepare, window_gemm
from .tc_gemm import split_tf32

DILATIONS = (1, 3, 9)
HALO = 42       # SP halo a side: the receptive field, 3 (1 + 3 + 9) + 3
PHALO = 21      # ... of each phase of the polyphase input
MAX_C = 64      # the tensor-core kernels: C a multiple of 4 up to this (released: 24)
ALIGN_C = 4
ROUTES: dict[str, int] = {"tc": 0, "general": 0}  # launches of either entry point by route
GENERAL_PRODUCTS = 7  # the general tail's launches: 3 k7, 3 1x1, the output conv


def admits(C: int) -> str | None:
    """Why no kernel takes C channels, or None when one does: every C >= 1
    (:func:`route_for` names the kernel)."""
    return None if C >= 1 else f"the kernel takes C >= 1, got {C}"


def route_for(C: int) -> str:
    """``"tc"`` (``csrc/legacy_tail.cu`` / ``legacy_tail_bf16.cu``) for C a
    multiple of ALIGN_C up to MAX_C, else ``"general"``."""
    return "tc" if ALIGN_C <= C <= MAX_C and C % ALIGN_C == 0 else "general"


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


def legacy_tail_plain(x: torch.Tensor, w: TailWeights, *, lh: torch.Tensor | None = None,
                      rh: torch.Tensor | None = None,
                      edges: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, C, T) interleaved -> audio (B, T), in plain PyTorch (any float
    dtype: float64 is the decoder's fp64 tail). ``lh`` / ``rh`` / ``edges``:
    SP halos staged as the kernel's wrapper stages them."""
    if lh is not None or rh is not None:
        return _staged(lambda a, _: legacy_tail_plain(a, w), x, None, lh, rh, edges)
    for u, d in enumerate(DILATIONS):
        h = snake(x, w.a1[u][:, None])
        h = F.conv1d(h, w.w1[u], w.b1[u], padding=3 * d, dilation=d)
        h = snake(h, w.a2[u][:, None])
        x = x + torch.einsum("oc,bct->bot", w.w2[u], h) + w.b2[u][:, None]
    h = F.conv1d(snake(x, w.ao[:, None]), w.wo, w.bo, padding=3)
    return torch.tanh(h)[:, 0]


def _conv_taps(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """The zero-padded k7 conv at dilation d as the kernel sums it: one fp32
    product per tap, the taps added in order, then the bias."""
    T = x.shape[-1]
    xp = F.pad(x, (3 * d, 3 * d))
    y = sum(torch.einsum("oc,bct->bot", w[..., k], xp[..., k * d:k * d + T]) for k in range(7))
    return y + b[:, None]


def legacy_tail_plain_bf16(x: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """The bf16 kernel's function in plain PyTorch: bf16 activations between
    the steps, each product on the bf16 values with an fp32 sum (+ bias),
    rounded, the k7 convs summed tap by tap as the kernel sums them; the
    output conv and tanh in fp32, the audio rounded once."""
    bf, f = x.dtype, lambda t: t.float()
    for u, d in enumerate(DILATIONS):
        h = snake(x, w.a1[u][:, None])
        h = _conv_taps(f(h), f(w.w1[u]), f(w.b1[u]), d).to(bf)
        h = snake(h, w.a2[u][:, None])
        h = (torch.einsum("oc,bct->bot", f(w.w2[u]), f(h)) + f(w.b2[u])[:, None]).to(bf)
        x = x + h
    h = F.conv1d(f(snake(x, w.ao[:, None])), f(w.wo), f(w.bo), padding=3)
    return torch.tanh(h).to(bf)[:, 0]


class PreparedTail(NamedTuple):
    """A tail's weights as both versions take them."""
    weights: TailWeights  # stacked: the plain version's operands
    packed: torch.Tensor  # the kernel's buffer (:func:`pack`)


def padded_channels(C: int) -> int:
    """Channels rounded up to the kernel's n8 tiles."""
    return -(-C // 8) * 8


def packed_floats(C: int) -> int:
    """The floats of :func:`pack`'s buffer (``csrc/legacy_tail.cu`` Layout)."""
    Cp = padded_channels(C)
    return 2 * 3 * 7 * Cp * (Cp + 4) + 2 * 3 * Cp * (Cp + 4) + 27 * Cp + 4


def _check_shapes(w: TailWeights, C: int, name: str) -> None:
    shapes = {"a1": (3, C), "w1": (3, C, C, 7), "b1": (3, C), "a2": (3, C),
              "w2": (3, C, C), "b2": (3, C), "ao": (C,), "wo": (1, C, 7), "bo": (1,)}
    for k, shape in shapes.items():
        if tuple(getattr(w, k).shape) != shape:
            raise ValueError(f"{name}: {k} {tuple(getattr(w, k).shape)} is not {shape}")


def _vectors(w: TailWeights, Cp: int) -> list[torch.Tensor]:
    """The fp32 vectors of both buffers, zero-filled to Cp: (3, Cp) b1, a1,
    1 / (a1 + eps), a2, 1 / (a2 + eps), b2; (Cp) ao, 1 / (ao + eps); wo (7,
    Cp); bo and three zeros. The reciprocals are fp32 quotients of the fp32
    ``alpha + EPS``."""
    C = w.ao.shape[0]
    w = TailWeights(*(t.float() for t in w))
    vec = lambda t: F.pad(t, (0, Cp - C))
    recip = lambda a: vec(1.0 / (a + EPS))
    return [vec(w.b1), vec(w.a1), recip(w.a1), vec(w.a2), recip(w.a2), vec(w.b2), vec(w.ao),
            recip(w.ao), vec(w.wo[0].t()), F.pad(w.bo, (0, 3))]


def pack(w: TailWeights) -> torch.Tensor:
    """The kernel's one weight buffer on the weights' device, in the order of
    its shared-memory image; for bf16 weights :func:`pack_bf16`. fp32: w1
    (3, 7, Cout, Cin) TF32 hi, then lo; w2 (3, Cout, Cin) hi, then lo, rows of
    Cp + 4 floats (Cp = C rounded up to 8; the rest zero); then the vectors
    (:func:`_vectors`)."""
    if w.w1.dtype == torch.bfloat16:
        return pack_bf16(w)
    C = w.ao.shape[0]
    _check_shapes(w, C, "legacy_tail pack")
    Cp = padded_channels(C)
    with torch.no_grad():
        w1 = w.w1.new_zeros(3, 7, Cp, Cp + 4)
        w1[:, :, :C, :C] = w.w1.permute(0, 3, 1, 2)
        w2 = w.w2.new_zeros(3, Cp, Cp + 4)
        w2[:, :C, :C] = w.w2
        parts = [*split_tf32(w1), *split_tf32(w2), *_vectors(w, Cp)]
        return torch.cat([p.reshape(-1) for p in parts])


def bf16_shape(C: int) -> tuple[int, int, int]:
    """(C8, P, J1) of the bf16 kernel at C channels: n8 tiles of channels,
    pairs of them (the 1x1's k16 steps), k16 steps of the folded k7 conv."""
    C8 = -(-C // 8)
    return C8, -(-C8 // 2), -(-7 * C8 // 2)


def packed_bytes_bf16(C: int) -> int:
    """The bytes of :func:`pack_bf16`'s buffer (``legacy_tail_bf16.cu`` Layout)."""
    C8, P, J1 = bf16_shape(C)
    return 3 * (J1 + P) * P * 512 + 4 * (27 * 8 * C8 + 4)


def _fragments(m: torch.Tensor) -> torch.Tensor:
    """(..., 16 P rows n, 16 J columns k) bf16 in B-fragment order (..., J,
    P, 32 lanes, 8): lane 4 g + t holds m[16 p + 8 s + g][16 j + 8 h + 2 t
    + e] in the order (s, h, e), two n8 tiles' fragments in 16 bytes."""
    *lead, N, Kd = m.shape
    v = m.reshape(*lead, N // 16, 2, 8, Kd // 16, 2, 4, 2)
    n = len(lead)
    return v.permute(*range(n), n + 3, n, n + 2, n + 5, n + 1, n + 4, n + 6).contiguous()


def pack_bf16(w: TailWeights) -> torch.Tensor:
    """The bf16 kernel's one buffer (uint8 on the weights' device, 16-byte
    pieces, ``csrc/legacy_tail_bf16.cu``): the k7 weights folded to (3, Cout,
    7 x 8 C8) with column 8 C8 tap + c = w1[u, :, c, tap] (zero past C, K
    zero-filled to steps of 16), then w2 (3, Cout, Cin), both bf16 in
    B-fragment order (:func:`_fragments`, Cout zero-filled to pairs of n8
    tiles); then the fp32 vectors of :func:`_vectors` at Cp = 8 C8."""
    C = w.ao.shape[0]
    _check_shapes(w, C, "legacy_tail pack_bf16")
    C8, P, J1 = bf16_shape(C)
    with torch.no_grad():
        w1 = torch.zeros(3, 16 * P, 7, 8 * C8, dtype=torch.bfloat16, device=w.w1.device)
        w1[:, :C, :, :C] = w.w1.bfloat16().permute(0, 1, 3, 2)
        w1 = F.pad(w1.reshape(3, 16 * P, 7 * 8 * C8), (0, 16 * J1 - 7 * 8 * C8))
        w2 = torch.zeros(3, 16 * P, 16 * P, dtype=torch.bfloat16, device=w.w1.device)
        w2[:, :C, :C] = w.w2.bfloat16()
        parts = [_fragments(w1).view(torch.uint8), _fragments(w2).view(torch.uint8),
                 *(v.contiguous().view(torch.uint8) for v in _vectors(w, 8 * C8))]
        return torch.cat([p.reshape(-1) for p in parts])


def prepared_tail(w: TailWeights) -> torch.Tensor:
    """:func:`pack`, cached on ``w``'s tensors by ``cached_prepare``."""
    return cached_prepare(w.w1, tuple(w), lambda: pack(w))


def general_vectors(w: TailWeights) -> torch.Tensor:
    """The general route's fp32 vectors, one buffer: (3, C) a1, b1, a2, b2,
    then (C) ao and bo (the fp32 values of bf16 parameters)."""
    with torch.no_grad():
        return torch.cat([t.float().reshape(-1) for t in (w.a1, w.b1, w.a2, w.b2, w.ao, w.bo)])


def general_ldb(C: int) -> int:
    """The row of the general route's tap-major weights: C rounded up to 8
    (16-byte rows for the product's cp.async, fp32 and bf16)."""
    return -(-C // 8) * 8


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """A k7 conv's weight (..., N, C, 7) as the general product reads it:
    (..., 7, N, ldb), B[tap][n][c] = w[n, c, tap], zero past C."""
    C = w.shape[-2]
    t = w.movedim(-1, -3)
    return F.pad(t, (0, general_ldb(C) - C)).contiguous()


_GENERAL: dict[int, tuple] = {}


def prepared_general(w: TailWeights) -> tuple[torch.Tensor, ...]:
    """The general route's operands, cached on ``w``'s tensors by
    ``cached_prepare``: w1 (3, 7, C, ldb) and wo (7, 1, ldb) tap-major
    (:func:`tap_major`), w2 (3, C, ldb), all zero past C, in the weights'
    dtype; :func:`general_vectors`."""
    def build():
        with torch.no_grad():
            C = w.ao.shape[0]
            w2 = F.pad(w.w2, (0, general_ldb(C) - C)).contiguous()
            return tap_major(w.w1), w2, tap_major(w.wo), general_vectors(w)
    return cached_prepare(w.w1, tuple(w), build, store=_GENERAL)


def general_plan(x0: torch.Tensor, x1: torch.Tensor | None, w: TailWeights, T: int,
                 xbuf: torch.Tensor, hbuf: torch.Tensor, out: torch.Tensor) -> list[dict]:
    """The general tail's seven products as ``conv_unit.window_gemm``
    arguments, in order: per unit u the k7 conv (A: the residual stream,
    with a1[u]'s snake as its prologue, into hbuf) and the 1x1 conv (A:
    hbuf with a2[u]'s snake, + b2[u], the residual added into xbuf; bf16:
    the product + bias rounded first), then the output conv (A: xbuf with
    ao's snake, tanh, into out (B, T)). The first unit reads x0 (and x1,
    the phase pair) in place for its k7 conv's window and for its residual;
    xbuf is the residual stream after it."""
    B, C = x0.shape[:2]
    w1, w2, wo, vec = prepared_general(w)
    a1, b1, a2, b2 = vec[:12 * C].view(4, 3, C)
    ao, bo = vec[12 * C:13 * C], vec[13 * C:]
    ct = (T, C * T, 1, T)  # (rows, sb, st, sk) of a contiguous (B, C, T) buffer
    src = (x0, x1, (T, x0.stride(0), x0.stride(2), x0.stride(1)))
    bf16 = x0.dtype == torch.bfloat16
    plan = []
    for u, d in enumerate(DILATIONS):
        a, a_1, a_map = src if u == 0 else (xbuf, None, ct)
        common = dict(C=C, M=B * T, N=C)
        plan.append(dict(a=a, a_map=a_map, b=w1[u], out=hbuf, o_map=ct, a1=a_1, taps=7, dil=d,
                         pro=a1[u], bias=b1[u], **common))
        plan.append(dict(a=hbuf, a_map=ct, b=w2[u], out=xbuf, o_map=ct, pro=a2[u], bias=b2[u],
                         res=a, res1=a_1, r_map=a_map, round_mid=bf16, **common))
    plan.append(dict(a=xbuf, a_map=ct, C=C, b=wo, out=out, o_map=(T, T, 1, 0), M=B * T, N=1,
                     taps=7, dil=1, pro=ao, bias=bo, act=ACT_TANH))
    return plan


def _launch_general(x0: torch.Tensor, x1: torch.Tensor | None, w: TailWeights, T: int,
                    name: str) -> torch.Tensor:
    """The general tail on x0 (and x1: the phase pair), any C: the seven
    products of :func:`general_plan`, ``csrc/general_gemm.cu``."""
    B, C = x0.shape[:2]
    _check_shapes(w, C, name)
    w1, w2, wo, vec = prepared_general(w)
    K.check_cuda({"x0": x0, "x1": x1, "w1": w1, "w2": w2, "wo": wo}, x0.device, dtype=x0.dtype)
    K.check_cuda({"vectors": vec}, x0.device)
    xbuf, hbuf = (torch.empty((B, C, T), device=x0.device, dtype=x0.dtype) for _ in range(2))
    out = torch.empty((B, T), device=x0.device, dtype=x0.dtype)
    for p in general_plan(x0, x1, w, T, xbuf, hbuf, out):
        window_gemm(**p)
    return out


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_void_p]


def _launch(x0: torch.Tensor, x1: torch.Tensor | None, w: TailWeights | PreparedTail,
            T: int, name: str) -> torch.Tensor:
    B, C = x0.shape[:2]
    why = admits(C)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    w_dtype = _plain_weights(w).w1.dtype
    if w_dtype != x0.dtype:
        raise TypeError(f"{name}: x is {x0.dtype} but the weights are {w_dtype}")
    if route_for(C) == "general":
        out = _launch_general(x0, x1, _plain_weights(w), T, name)
        K.LAUNCHES[name] += 1
        ROUTES["general"] += 1
        return out
    if isinstance(w, PreparedTail):
        wp = w.packed
    else:
        _check_shapes(w, C, name)
        wp = prepared_tail(w)
    bf16 = x0.dtype == torch.bfloat16
    if wp.shape != ((packed_bytes_bf16(C),) if bf16 else (packed_floats(C),)):
        raise ValueError(f"{name}: packed weights {tuple(wp.shape)} do not match C = {C}")
    K.check_cuda({"x0": x0, "x1": x1}, x0.device, dtype=x0.dtype)
    K.check_cuda({"weights": wp}, x0.device, dtype=torch.uint8 if bf16 else torch.float32)
    if not bf16 and \
            _build.function("l3ac_legacy_tail_weight_floats", [ctypes.c_int])(C) != wp.numel():
        raise RuntimeError(f"{name}: pack's layout differs from the kernel's")
    out = torch.empty((B, T), device=x0.device, dtype=x0.dtype)
    fn = _build.function("l3ac_legacy_tail_bf16" if bf16 else "l3ac_legacy_tail", _ARGTYPES)
    err = fn(x0.data_ptr(), _build.ptr(x1), wp.data_ptr(), out.data_ptr(), B, C, T,
             x0.stride(0), x0.stride(1), _build.stream_ptr())
    _build.check(err, name)
    K.LAUNCHES[name] += 1
    ROUTES["tc"] += 1
    return out


def _plain_weights(w: TailWeights | PreparedTail) -> TailWeights:
    return w.weights if isinstance(w, PreparedTail) else w


def _plain(x: torch.Tensor):
    return legacy_tail_plain_bf16 if x.dtype == torch.bfloat16 else legacy_tail_plain


def _staged(fn, x0: torch.Tensor, x1: torch.Tensor | None, lh, rh, edges) -> torch.Tensor:
    """``fn(x0, x1)`` -> audio, on the staged ``[lh | x | rh]`` of each input
    (``lh`` / ``rh`` a pair for the phase pair), the halo's audio cropped."""
    if lh is None and rh is None:
        return fn(x0, x1)
    if x1 is None:
        return K.halo_call(lambda b: fn(b, None), x0, lh, rh, edges, axis=2, out_axis=1)
    lh, rh = lh or (None, None), rh or (None, None)
    b0, left, right = K.stage_halos(x0, lh[0], rh[0], edges, 2)
    b1, _, _ = K.stage_halos(x1, lh[1], rh[1], edges, 2)
    with sp.suspended():
        y = fn(b0, b1)
    return K.crop_halos(y, 2 * left, 2 * right, 1)


def _check_halos(name: str, x: torch.Tensor, width: int, *halos) -> None:
    for h in halos:
        if h is not None and h.shape != (*x.shape[:2], width):
            raise ValueError(f"{name}: halo {tuple(h.shape)} is not "
                             f"{(*x.shape[:2], width)}")


def _call(x0: torch.Tensor, x1: torch.Tensor | None, w: TailWeights | PreparedTail,
          name: str, lh=None, rh=None, edges=None) -> torch.Tensor:
    """The launch through ``autograd.call``: under autograd the backward
    differentiates the plain tail on the weights (``w``'s own, or a
    PreparedTail's, which a trainer builds from the live parameters)."""
    pair = x1 is not None
    flat = lambda h: (tuple(h) if h is not None else (None, None)) if pair else (h,)
    halos = (*flat(lh), *flat(rh))

    def plain(x0, x1, *rest):
        n = len(halos) // 2
        hl, hr = rest[:n], rest[n:2 * n]
        tw = TailWeights(*rest[2 * n:])
        unflat = lambda h: (None if h[0] is None else h) if pair else h[0]
        return _staged(lambda a, b: legacy_tail_plain(a if b is None else interleave([a, b], 2),
                                                      tw), x0, x1, unflat(hl), unflat(hr), edges)

    def launch():
        return _staged(lambda a, b: _launch(a, b, w, a.shape[2] * (1 if b is None else 2), name),
                       x0, x1, lh, rh, edges)

    # the halos are inputs too: under SP training their gradient goes back
    # to the neighbours (parallel.sp)
    return autograd.call(name, launch, plain, x0, x1, *halos, *_plain_weights(w))


def legacy_tail_poly_ct(x0: torch.Tensor, x1: torch.Tensor,
                        w: TailWeights | PreparedTail, *, lh=None, rh=None,
                        edges: tuple[int, int] | None = None) -> torch.Tensor:
    """Phase pair x0, x1 (B, C, Tt) of the interleaved input
    (``x[.., 2 t + q] = x_q[.., t]``) -> audio (B, 2 Tt) in x's dtype (fp32
    or bf16). ``w``: the weights, or a :class:`PreparedTail` whose buffer
    the kernel takes as it is. Kernel on CUDA (under autograd with the plain
    version's gradient), plain on CPU. ``lh`` / ``rh``: SP halo pairs, one
    (B, C, PHALO) block per phase; ``edges``: the (first, last) shard flags."""
    K.check_input(x0, "legacy_tail_poly_ct x0", ndim=3, dtype=K.DTYPES)
    K.check_input(x1, "legacy_tail_poly_ct x1", ndim=3, dtype=x0.dtype)
    if x0.shape != x1.shape:
        raise ValueError(f"legacy_tail_poly_ct: phases {tuple(x0.shape)} and "
                         f"{tuple(x1.shape)} differ")
    _check_halos("legacy_tail_poly_ct", x0, PHALO, *(lh or ()), *(rh or ()))
    if not K.route(x0, "legacy_tail_poly_ct"):
        return _staged(lambda a, b: _plain(a)(interleave([a, b], 2), _plain_weights(w)),
                       x0, x1, lh, rh, edges)
    return _call(x0, x1, w, "legacy_tail_poly_ct", lh, rh, edges)


def legacy_tail_ct(x: torch.Tensor, w: TailWeights | PreparedTail, *,
                   lh: torch.Tensor | None = None, rh: torch.Tensor | None = None,
                   edges: tuple[int, int] | None = None) -> torch.Tensor:
    """Interleaved (B, C, T) -> audio (B, T) in x's dtype (fp32 or bf16).
    Kernel on CUDA (under autograd with the plain version's gradient), plain
    on CPU. ``lh`` / ``rh``: SP halo blocks (B, C, HALO); ``edges``: the
    (first, last) shard flags."""
    K.check_input(x, "legacy_tail_ct x", ndim=3, dtype=K.DTYPES)
    _check_halos("legacy_tail_ct", x, HALO, lh, rh)
    if not K.route(x, "legacy_tail_ct"):
        return _staged(lambda a, _: _plain(a)(a, _plain_weights(w)), x, None, lh, rh, edges)
    return _call(x, None, w, "legacy_tail_ct", lh, rh, edges)
