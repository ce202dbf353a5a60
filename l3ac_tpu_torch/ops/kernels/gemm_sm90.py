"""The bf16 wgmma GEMM core (``csrc/gemm_sm90.cuh``) from Python: its route
rule, the weights' tensor maps, a count of launches per route, one bf16
product on the core alone (for its tests and timings), and host twins of
the core's layout arithmetic.

The core computes ``epilogue(A @ B.T)`` with bf16 A (M, K) and a bf16 or
int8 B (N, K) in ``nn.Linear`` layout, fp32 sums in one wgmma accumulator
across K and one rounding of the output to bf16. Two kernels run on it: the
bf16 ``conv_unit`` on (B, T, C) (its two products, ``ops/kernels/conv_unit.py``)
and ``int8_matmul`` on bf16 x (``ops/kernels/int8_matmul.py``).

Routes (:func:`route_for`, the one rule): ``"tma"`` where TMA can address
the operands (row strides and bases 16-byte aligned: bf16 K % 8 == 0, int8
K % 16 == 0), else ``"cp_async"`` (the producer warpgroup copies into the
same swizzled tiles, zero-filled past the edges). Every M, N, K >= 1 runs
on one of the two; a launch never changes route on its own.

Tensor maps: a weight's map is built once (:func:`weight_map`, cached on
the weight like the prepared weights) and handed to each launch; the
activation's map is encoded per call in C (``l3ac_sm90_encode_seconds``
times that host cost).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels as K
from . import _build

BK = 64               # K per ring stage: one 128-byte swizzle row of bf16
ROW_BYTES = 2 * BK
MAX_SMEM = 232448     # shared memory a block may use (227 KB)
ROUTE_CODE = {"tma": 0, "cp_async": 1}
# launches of the core per route, counted by the wrappers that launch it
ROUTES: dict[str, int] = dict.fromkeys(ROUTE_CODE, 0)
EPI_CODE = {None: 0, "snake": 1, "gelu": 2, "residual": 3}


class Config(NamedTuple):
    """A configuration of the core (``gemm_sm90.cuh:Config``)."""
    bn: int         # output columns per tile
    stages: int     # ring depth
    coop: bool      # both consumer warpgroups on one 128-row tile, else ping-pong
    int8: bool      # int8 B (a staging buffer per stage)
    mb: int = 1     # ping-pong: m64 blocks per consumer group (tiles of 64 mb rows)

    @property
    def bm(self) -> int:
        return 128 if self.coop else 64 * self.mb

    @property
    def stage_bytes(self) -> int:
        return (self.bm + self.bn) * ROW_BYTES + (self.bn * BK if self.int8 else 0)

    @property
    def smem(self) -> int:
        """Dynamic shared memory of one block: the ring, 3 barriers a stage,
        1 KB to align the ring to 1024 bytes (``Config::kSmem``)."""
        return 1024 + self.stages * self.stage_bytes + 24 * self.stages

    def fits(self) -> bool:
        return self.smem <= MAX_SMEM


# what the port runs (gemm_sm90.cuh: Bf16Config, Int8Config)
BF16_CONFIG = Config(128, 4, False, False)
INT8_CONFIG = Config(128, 4, False, True, 2)


def tma_multiple(int8: bool) -> int:
    """K must be a multiple of this for TMA: 16-byte row strides."""
    return 16 if int8 else 8


def route_for(M: int, N: int, Kd: int, *, int8: bool, a_ptr: int, b_ptr: int) -> str:
    """The core's loader for a product of (M, K) by (N, K): ``"tma"`` when
    the row strides (K elements) and both bases are 16-byte aligned, else
    ``"cp_async"``. Raises on an empty shape."""
    if min(M, N, Kd) < 1:
        raise ValueError(f"gemm_sm90: empty product (M={M}, N={N}, K={Kd})")
    if Kd % tma_multiple(int8) == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0:
        return "tma"
    return "cp_async"


def swizzle128(r: int, j: int) -> int:
    """Byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile:
    what the cp.async route stores (``gemm_sm90.cuh:swizzle128``) and TMA's
    ``CU_TENSOR_MAP_SWIZZLE_128B`` writes."""
    return r * ROW_BYTES + ((j ^ (r & 7)) << 4)


def wgmma_read_offset(start: int, r: int, kbyte: int) -> int:
    """The byte wgmma reads for row r, byte kbyte (0..31) of its k16 slice,
    from a K-major 128-byte-swizzle descriptor whose start is ``start``
    bytes into a 1024-byte-aligned tile: the unswizzled address start +
    (r / 8) SBO + (r % 8) 128 + kbyte, SBO = 1024, then address bits 4-6
    XOR bits 7-9 (the hardware's 128-byte swizzle)."""
    addr = start + (r // 8) * 1024 + (r % 8) * ROW_BYTES + kbyte
    return addr ^ (((addr >> 7) & 7) << 4)


def byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm``: byte n of the result is byte ``sel``'s nibble
    n (0-7) of the eight bytes (y << 32) | x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def widen_int8(word: int, i: int) -> float:
    """Host twin of the core's int8 widening (``gemm_sm90.cuh:dequant8``):
    byte i of a little-endian word as fp32, by placing q + 128 in the
    mantissa of 2^23 and subtracting 2^23 + 128 (no I2F)."""
    bits = byte_perm(word ^ 0x80808080, 0x4B000000, 0x7440 | i)
    f = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    return (f - torch.tensor(8388736.0)).item()


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 fmaf modelled in float64: the product of two fp32 values is exact
    there, the sum rounded to float64 and then to fp32 (a double rounding
    that can differ from one fused rounding in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def sin_ilp(x: torch.Tensor) -> torch.Tensor:
    """Host twin of ``common.cuh:sin_ilp`` on fp32 x, valid for |x| <=
    8192 (the kernel calls sinf beyond): j = rint(x 2/pi), r = x - j pi/2 in
    three parts, the sin / cos polynomials of [-pi/4, pi/4] by quadrant."""
    f = torch.float32
    j = torch.round((x * torch.tensor(0.636619772367581343, dtype=f)).to(f))
    r = _fma32(-j, torch.tensor(1.5703125, dtype=f), x)
    r = _fma32(-j, torch.tensor(4.837512969970703125e-4, dtype=f), r)
    r = _fma32(-j, torch.tensor(7.54978995489188216e-8, dtype=f), r)
    c = lambda v: torch.tensor(v, dtype=f)
    z = r * r
    sn = _fma32(r * z, _fma32(_fma32(c(-1.9515295891e-4), z, c(8.3321608736e-3)), z,
                              c(-1.6666654611e-1)), r)
    cs = _fma32(z * z, _fma32(_fma32(c(2.443315711809948e-5), z, c(-1.388731625493765e-3)), z,
                              c(4.166664568298827e-2)), _fma32(c(-0.5), z, c(1.0)))
    q = j.to(torch.int64)
    v = torch.where((q & 1) == 1, cs, sn)
    return torch.where((q & 2) == 2, -v, v)


def sin2_ilp(x: torch.Tensor) -> torch.Tensor:
    """Host twin of ``common.cuh:sin2_ilp``: sin^2 x on fp32 x (|x| <= 8192)
    from sin_ilp's reduction and its sine polynomial alone, 1 - sin^2 r in
    the odd quadrants."""
    f = torch.float32
    c = lambda v: torch.tensor(v, dtype=f)
    j = torch.round((x * c(0.636619772367581343)).to(f))
    r = _fma32(-j, c(1.5703125), x)
    r = _fma32(-j, c(4.837512969970703125e-4), r)
    r = _fma32(-j, c(7.54978995489188216e-8), r)
    z = r * r
    sn = _fma32(r * z, _fma32(_fma32(c(-1.9515295891e-4), z, c(8.3321608736e-3)), z,
                              c(-1.6666654611e-1)), r)
    s2 = sn * sn
    return torch.where((j.to(torch.int64) & 1) == 1, 1.0 - s2, s2)


def newton_quotient(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Host twin of the kernels' n / d without a branch: q0 = n rcp with rcp
    the correctly rounded 1 / d, then one Newton step fma(fma(-q0, d, n),
    rcp, q0) (``common.cuh:quotient``: the bf16 kernels' snakes and norms)."""
    rcp = 1.0 / d
    q0 = n * rcp
    return _fma32(_fma32(-q0, d, n), rcp, q0)


class TensorMap:
    """128 bytes of a ``CUtensorMap``, 64-byte aligned, kept alive with the
    weight it maps."""

    def __init__(self):
        self._buf = (ctypes.c_uint8 * 192)()
        base = ctypes.addressof(self._buf)
        self.ptr = base + (-base) % 64


def map_ptr(m: TensorMap | None) -> int | None:
    """The address to pass for a map, or None. The caller keeps ``m``
    referenced until the launch has returned: the launch copies the map, and
    a map built per call (inference-mode weights are never cached) would
    otherwise be freed before it is read."""
    return None if m is None else m.ptr


def _encode_weight_map(w: torch.Tensor, int8: bool) -> TensorMap:
    m = TensorMap()
    fn = _build.function("l3ac_sm90_weight_map", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(w.data_ptr(), int(int8), w.shape[0], w.shape[1], m.ptr), "gemm_sm90 weight map")
    return m


# id(weight) -> its TensorMap (conv_unit.cached_prepare's entries)
_MAPS: dict[int, tuple] = {}


def weight_map(w: torch.Tensor) -> TensorMap:
    """The TMA map of a contiguous (N, K) bf16 or int8 weight on the card,
    for the configuration of its kind (:data:`BF16_CONFIG`,
    :data:`INT8_CONFIG`); built once and cached on the weight (rebuilt
    when it is replaced or changed in place)."""
    from .conv_unit import cached_prepare
    int8 = w.dtype == torch.int8
    return cached_prepare(w, (w,), lambda: _encode_weight_map(w, int8), store=_MAPS)


def encode_seconds(a: torch.Tensor, iters: int = 1000) -> float:
    """Host seconds per encoding of an activation's map (the TMA route's
    per-call cost), over ``iters`` encodings of a's (rows, K) map."""
    fn = getattr(_build.library(), "l3ac_sm90_encode_seconds")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_double
    s = fn(a.data_ptr(), a.shape[0], a.shape[1], iters)
    if s < 0:
        raise RuntimeError("gemm_sm90: tensor map encoding failed")
    return s


def gemm_plain_bf16(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                    alpha: torch.Tensor | None = None, res: torch.Tensor | None = None,
                    act: str | None = None) -> torch.Tensor:
    """The core's bf16 product in plain PyTorch: the bf16 values multiplied
    with fp32 sums, the fp32 bias, the activation (``"snake"`` with alpha,
    ``"gelu"``) or the bf16 residual added in fp32, one rounding to bf16."""
    from ..activations import gelu, snake
    y = a.float() @ w.float().T
    if bias is not None:
        y = y + bias.float()
    if act == "snake":
        y = snake(y, alpha.float())
    elif act == "gelu":
        y = gelu(y)
    if res is not None:
        y = res.float() + y
    return y.to(torch.bfloat16)


ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
              alpha: torch.Tensor | None = None, res: torch.Tensor | None = None,
              act: str | None = None) -> torch.Tensor:
    """(M, N) bf16 = the core's product of a (M, K) bf16 and w (N, K) bf16,
    with bias / alpha fp32 (N,), res bf16 (M, N) (``act`` ``"snake"``,
    ``"gelu"`` or None; ``res`` given: the residual epilogue). On CUDA the
    core, its route from :func:`route_for` (counted in :data:`ROUTES`);
    plain on the CPU. The ConvUnit's products run on it through
    ``conv_unit``; this entry point is the core alone, for tests and
    timings."""
    K.check_input(a, "gemm_sm90 a", ndim=2, dtype=torch.bfloat16)
    if not K.route(a, "gemm_sm90"):
        return gemm_plain_bf16(a, w, bias, alpha, res, act)
    if res is not None and act is not None:
        raise ValueError("gemm_sm90: an activation or a residual, not both")
    if act == "snake" and alpha is None:
        raise ValueError("gemm_sm90: snake needs alpha")
    M, Kd = a.shape
    N = w.shape[0]
    if w.shape != (N, Kd) or (res is not None and res.shape != (M, N)):
        raise ValueError(f"gemm_sm90: a {tuple(a.shape)}, w {tuple(w.shape)} do not match")
    K.check_cuda({"a": a, "w": w, "res": res}, a.device, dtype=torch.bfloat16)
    K.check_cuda({"bias": bias, "alpha": alpha}, a.device)
    route = route_for(M, N, Kd, int8=False, a_ptr=a.data_ptr(), b_ptr=w.data_ptr())
    wmap = weight_map(w) if route == "tma" else None  # alive across the launch
    out = torch.empty(M, N, device=a.device, dtype=torch.bfloat16)
    fn = _build.function("l3ac_gemm_sm90_bf16", ARGTYPES)
    err = fn(a.data_ptr(), w.data_ptr(), map_ptr(wmap), _build.ptr(bias), _build.ptr(alpha),
             _build.ptr(res), out.data_ptr(), M, N, Kd,
             EPI_CODE["residual" if res is not None else act], ROUTE_CODE[route],
             _build.stream_ptr())
    _build.check(err, "gemm_sm90")
    ROUTES[route] += 1
    return out
