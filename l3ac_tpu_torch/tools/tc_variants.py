"""The tensor-core GEMM core's tilings and int8 splits side by side, at the
product shapes of one 1kbps 8 x 10 s request: the measurement behind
``Fp32Tiling`` and ``Int8Tiling`` in ``csrc/tc_gemm.cuh``.

    python3 -m l3ac_tpu_torch.tools.tc_variants

Card only. Builds ``tools/tc_variants.cu`` against ``csrc/`` with the kernel
library's nvcc flags, holds every variant against the plain fp32 product
(max abs error <= 1e-4 x max(1, max |plain|)), times each with CUDA events
and prints, per shape and summed over one request, the wide ConvUnits' two
products (encode and decode, snake and residual epilogues; their weights
split as ``conv_unit.prepare_weights`` does) and the int8 roundtrip's 48
products. Variant 0 of each kind is what the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import torch

from . import describe, time_ms
from ..ops.activations import snake
from ..ops.kernels import _build
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
ITERS = 20


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
    return lib


def _check(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= TOL * max(1.0, want.abs().max().item()):
        raise AssertionError(f"{label}: max abs error {err}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_variants: CUDA is not available (it times kernels on the card)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build()
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
