"""The tensor-core GEMM cores' variants side by side, at the product shapes
of one 1kbps 8 x 10 s request: the measurement behind ``Fp32Tiling`` and
``Int8Tiling`` in ``csrc/tc_gemm.cuh`` and behind ``Bf16Config`` and
``Int8Config`` in ``csrc/gemm_sm90.cuh``.

    python3 -m l3ac_tpu_torch.tools.tc_variants

Card only. Builds ``tools/tc_variants.cu`` (the fp32 core's alternatives,
and the bf16 products' former one-pass mma.sync core as the baseline) and
``tools/sm90_variants.cu`` once per configuration of the wgmma core in
:data:`SM90` (text substitutions of its Config and grid lines, all nvcc
processes at once) against ``csrc/`` with the kernel library's nvcc flags.
Holds every variant against its plain version (fp32: max abs error <= 1e-4
x max(1, max |plain|); bf16: 2^-6), times each with CUDA events and prints,
per shape and summed over one request: the fp32 wide ConvUnits' two products
and the int8 roundtrip's 48 products; the bf16 ConvUnits' products (encode
and decode, snake and residual epilogues) and the bf16 int8 roundtrip's 48
products, each beside ``F.linear`` in bf16 (on the dequantized weight for
int8) and with its TFLOP/s. Variant 0 of each kind is what the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import torch

import torch.nn.functional as F

from . import build_variants, describe, time_ms
from ..ops.activations import snake
from ..ops.kernels import _build
from ..ops.kernels.gemm_sm90 import BF16_CONFIG, INT8_CONFIG, Config, gemm_plain_bf16
from ..ops.kernels.int8_matmul import dequantize_weight, int8_matmul_plain_bf16
from ..ops.kernels.tc_gemm import split_tf32
from ..ops.quantized import quantize_weight

SOURCE = _build.PKG_DIR / "tools" / "tc_variants.cu"
FP32 = ("512 threads, 32 x 32 warps", "256 threads, 32 x 64 warps")
INT8 = ("256 threads, 32 x 64, 3 bf16 passes", "256 threads, 32 x 64, 2 TF32 passes",
        "512 threads, 32 x 32, 3 bf16 passes")
# (M, K, N, epilogue 0 snake / 1 residual, products per 8 x 10 s request)
FP32_SHAPES = ((14232, 512, 2048, 0, 3), (14232, 2048, 512, 1, 3), (71160, 256, 1024, 0, 3),
               (71160, 1024, 256, 1, 3), (14232, 192, 768, 0, 2), (14232, 768, 192, 1, 2))
# (M, K, N, products per int8 8 x 10 s roundtrip)
INT8_SHAPES = ((18000, 128, 576, 3), (18000, 192, 128, 3), (18000, 128, 682, 3),
               (18000, 341, 128, 3), (6000, 128, 576, 5), (6000, 192, 128, 5),
               (6000, 128, 682, 5), (6000, 341, 128, 5), (14232, 192, 768, 2),
               (14232, 768, 192, 2), (14232, 512, 2048, 3), (14232, 2048, 512, 3),
               (71160, 256, 1024, 3), (71160, 1024, 256, 3))
TOL = 1e-4
BF16_TOL = 2.0 ** -6
ITERS = 20

SM90_SOURCE = _build.PKG_DIR / "tools" / "sm90_variants.cu"
_LINES = ("using Bf16 = sm90::Bf16Config;", "using Int8 = sm90::Int8Config;",
          "constexpr bool kPersistent = true;")


def _config(c: Config) -> str:
    b = lambda v: "true" if v else "false"
    mb = f", {c.mb}" if c.mb != 1 else ""
    return f"sm90::Config<{c.bn}, {c.stages}, {b(c.coop)}, {b(c.int8)}{mb}>"


def sm90_subs(bf16: Config, int8: Config, persistent: bool) -> list[tuple[str, str]]:
    """The substitutions of sm90_variants.cu for one pair of configurations."""
    subs = []
    if bf16 != BF16_CONFIG:
        subs.append((_LINES[0], f"using Bf16 = {_config(bf16)};"))
    if int8 != INT8_CONFIG:
        subs.append((_LINES[1], f"using Int8 = {_config(int8)};"))
    if not persistent:
        subs.append((_LINES[2], "constexpr bool kPersistent = false;"))
    return subs


# (label, bf16 B config, int8 B config, persistent grid): config = Config(BN,
# stages, coop (two groups on a 128-row tile) or ping-pong (64-row tiles), int8)
SM90 = (
    ("port: ping-pong 64x128 4 st | int8 ping-pong 128x128 (two m64 a group) 4 st, persistent",
     BF16_CONFIG, INT8_CONFIG, True),
    ("the same, one block per tile", BF16_CONFIG, INT8_CONFIG, False),
    ("ping-pong 128x128 (two m64 a group) 4 st | int8 128x128 coop 4 st",
     Config(128, 4, False, False, 2), Config(128, 4, True, True), True),
    ("ping-pong 128x128 (two m64 a group) 5 st | int8 128x128 coop 5 st",
     Config(128, 5, False, False, 2), Config(128, 5, True, True), True),
    ("128x128 coop 4 st | int8 128x256 coop 3 st", Config(128, 4, True, False),
     Config(256, 3, True, True), True),
    ("ping-pong 64x128 6 st | int8 ping-pong 64x128 6 st", Config(128, 6, False, False),
     Config(128, 6, False, True), True),
    ("128x256 coop 4 st | int8 ping-pong 64x128 4 st", Config(256, 4, True, False),
     Config(128, 4, False, True), True),
)
# (M, K, N, epilogue 1 snake / 3 residual, products per bf16 8 x 10 s roundtrip)
BF16_SHAPES = ((14232, 512, 2048, 1, 3), (14232, 2048, 512, 3, 3), (71160, 256, 1024, 1, 3),
               (71160, 1024, 256, 3, 3), (14232, 192, 768, 1, 2), (14232, 768, 192, 3, 2))
_BF16_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_INT8_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def build() -> ctypes.CDLL:
    """Compile tc_variants.cu into the build directory, keyed by its source
    and the library's; load it."""
    h = hashlib.sha256(SOURCE.read_bytes() + _build.source_hash().encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"tc_variants-{h}" / "libtc_variants.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
                        str(SOURCE), "-o", str(out)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.l3ac_tcv_fp32.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.l3ac_tcv_int8.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.l3ac_tcv_bf16_mma.argtypes = _BF16_ARGS
    lib.l3ac_tcv_int8_bf16_mma.argtypes = _INT8_ARGS
    return lib


def build_sm90() -> list[ctypes.CDLL]:
    """sm90_variants.cu built once per entry of :data:`SM90`, in parallel."""
    libs = build_variants("sm90_variants", SM90_SOURCE,
                          [sm90_subs(b, q, p) for _, b, q, p in SM90], "l3ac_sm90v_bf16",
                          _BF16_ARGS)
    for lib, _ in libs:
        lib.l3ac_sm90v_int8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.l3ac_sm90v_int8.restype = ctypes.c_int
    return [lib for lib, _ in libs]


def _check(label: str, got: torch.Tensor, want: torch.Tensor, tol: float = TOL) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol * max(1.0, want.float().abs().max().item()):
        raise AssertionError(f"{label}: max abs error {err}")
    return err


def _timed(label: str, call, got: torch.Tensor, want: torch.Tensor, dev, flops: float,
           tol: float) -> tuple[float, str]:
    """Run ``call`` once, hold ``got`` against ``want``, time it; (ms, text)."""
    call()
    err = _check(label, got, want, tol)
    ms = time_ms(call, dev, ITERS)
    return ms, f" {ms:.4f} ({flops / ms / 1e9:.0f} TF/s, {err:.1e})"


def _raise(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"tc_variants {name}: CUDA error {err}")


def bf16_variants(lib, sm90_libs, dev, normal, stream) -> None:
    """The bf16 products, one core at a time (a fault names its core and
    keeps what was printed before it): the former one-pass core [m], each
    wgmma configuration [0..] of SM90, F.linear bf16 [lib]."""
    bf = torch.bfloat16
    cases = []
    for M, K, N, epi, per in BF16_SHAPES:
        a, w = normal(M, K).to(bf), normal(N, K, std=K ** -0.5).to(bf)
        b, alpha = normal(N, std=0.1), 1.0 + normal(N, std=0.2).abs()
        res = normal(M, N).to(bf) if epi == 3 else None
        want = (gemm_plain_bf16(a, w, b, alpha, act="snake") if epi == 1
                else gemm_plain_bf16(a, w, b, res=res))
        out = torch.empty(M, N, device=dev, dtype=bf)
        rp = None if res is None else res.data_ptr()
        cases.append((f"bf16 (M={M}, K={K}, N={N}, {'snake' if epi == 1 else 'residual'})", per,
                      2 * M * K * N, want, out,
                      (a.data_ptr(), w.data_ptr(), b.data_ptr(), alpha.data_ptr(), rp,
                       out.data_ptr(), M, N, K, epi, stream), lambda a=a, w=w: F.linear(a, w),
                      (a, w, b, alpha, res)))  # the operands the pointers point into
    for M, K, N, per in INT8_SHAPES:
        x, b = normal(M, K).to(bf), normal(N, std=0.1).to(bf)
        w_q, scale = quantize_weight(normal(N, K, std=K ** -0.5))
        wd = dequantize_weight(w_q, scale, bf)
        out = torch.empty(M, N, device=dev, dtype=bf)
        route = 0 if K % 16 == 0 else 1
        cases.append((f"int8 bf16 (M={M}, K={K}, N={N}, {'tma' if route == 0 else 'cp_async'})",
                      per, 2 * M * K * N, int8_matmul_plain_bf16(x, w_q, scale, b), out,
                      (x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), b.data_ptr(),
                       out.data_ptr(), M, N, K, route), lambda x=x, wd=wd, b=b: F.linear(x, wd, b),
                      (x, b, w_q, scale)))

    def run(tag, name, bf16_fn, int8_fn):
        print(f"[{tag}] {name}:", flush=True)
        sums = {"bf16": 0.0, "int8": 0.0}
        for label, per, flops, want, out, args, linear, _ in cases:
            kind = "int8" if label.startswith("int8") else "bf16"
            fn = bf16_fn if kind == "bf16" else int8_fn
            if fn is None:
                ms, txt = time_ms(linear, dev, ITERS), ""
                txt = f" {ms:.4f} ({flops / ms / 1e9:.0f} TF/s)"
            else:
                print(f"  {label} ...", end="\r", flush=True)  # names a fault
                ms, txt = _timed(f"[{tag}] {label}", lambda: _raise(f"[{tag}]", fn(args)), out, want,
                                 dev, flops, BF16_TOL)
            sums[kind] += per * ms
            print(f"  {label}:{txt}", flush=True)
        print(f"  summed per 8 x 10 s roundtrip: bf16 conv-unit products {sums['bf16']:.3f} ms, "
              f"bf16 int8 products {sums['int8']:.3f} ms", flush=True)

    run("m", "the former one-pass mma.sync core", lambda a: lib.l3ac_tcv_bf16_mma(*a),
        lambda a: lib.l3ac_tcv_int8_bf16_mma(*a[:8], stream))
    run("lib", "F.linear bf16 (int8: on the dequantized weight)", None, None)
    for v, ((label, *_), vl) in enumerate(zip(SM90, sm90_libs)):
        run(str(v), label, lambda a, vl=vl: vl.l3ac_sm90v_bf16(*a),
            lambda a, vl=vl: vl.l3ac_sm90v_int8(*a, stream))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_variants: CUDA is not available (it times kernels on the card)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    lib = build()
    sm90_libs = build_sm90()
    print(f"[{describe(dev)}] tc_gemm variants, ms per call (max abs error)", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    stream = torch.cuda.current_stream().cuda_stream
    fp32_sum, int8_sum = [0.0] * len(FP32), [0.0] * len(INT8)
    for M, K, N, epi, per in FP32_SHAPES:
        a, w, b, res = normal(M, K), normal(N, K, std=K ** -0.5), normal(N, std=0.1), normal(M, N)
        alpha = 1.0 + normal(N, std=0.2).abs()
        hi, lo = split_tf32(w)
        y = a @ w.T + b
        want = snake(y, alpha) if epi == 0 else res + y
        out = torch.empty(M, N, device=dev)
        line = f"fp32 (M={M}, K={K}, N={N}, {'snake' if epi == 0 else 'residual'}):"
        for v in range(len(FP32)):
            def call(v=v):
                err = lib.l3ac_tcv_fp32(v, a.data_ptr(), hi.data_ptr(), lo.data_ptr(), b.data_ptr(),
                                        alpha.data_ptr(), res.data_ptr(), out.data_ptr(), M, N, K,
                                        epi, stream)
                if err:
                    raise RuntimeError(f"tc_variants fp32 {v}: CUDA error {err}")
            call()
            err = _check(f"fp32 variant {v}", out, want)
            ms = time_ms(call, dev, ITERS)
            fp32_sum[v] += per * ms
            line += f" [{v}] {ms:.4f} ({err:.1e})"
        print(line, flush=True)
    for M, K, N, per in INT8_SHAPES:
        x, b = normal(M, K), normal(N, std=0.1)
        w_q, scale = quantize_weight(normal(N, K, std=K ** -0.5))
        want = x @ (w_q.float() * scale[:, None]).T + b
        out = torch.empty(M, N, device=dev)
        line = f"int8 (M={M}, K={K}, N={N}):"
        for v in range(len(INT8)):
            def call(v=v):
                err = lib.l3ac_tcv_int8(v, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                                        b.data_ptr(), out.data_ptr(), M, N, K, stream)
                if err:
                    raise RuntimeError(f"tc_variants int8 {v}: CUDA error {err}")
            call()
            err = _check(f"int8 variant {v}", out, want)
            ms = time_ms(call, dev, ITERS)
            int8_sum[v] += per * ms
            line += f" [{v}] {ms:.4f} ({err:.1e})"
        print(line, flush=True)
    print("summed per 8 x 10 s request (wide ConvUnit products, encode + decode):")
    for v, name in enumerate(FP32):
        print(f"  fp32 [{v}] {name}: {fp32_sum[v]:.3f} ms")
    print("summed per int8 8 x 10 s roundtrip (48 products):")
    for v, name in enumerate(INT8):
        print(f"  int8 [{v}] {name}: {int8_sum[v]:.3f} ms")
    print("bf16 cores, ms per call (TFLOP/s, max abs error):", flush=True)
    bf16_variants(lib, sm90_libs, dev, normal, stream)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
