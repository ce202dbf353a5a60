"""The attention kernel (``csrc/local_attention.cu``) beside its measured
alternatives and ablations, at the two window shapes of one 1kbps 8 x 10 s
request, q / k / v as the model's strided head views and the bias as its
table.

    python3 -m l3ac_tpu_torch.tools.attention_variants

Card only. Each variant is the kernel's source with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library, called on the same seeded inputs
and timed with CUDA events. Variants that compute the attention are held
against the plain version (max abs error <= 1e-4 x max(1, max |plain|));
ablations drop a part of the work, are only timed, and say where the time
goes. Prints ptxas's registers and spills of each variant at D = 32 with the
table, its ms per shape and the sum per request (encode, decode). Variant 0
is what the port runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import build_variants, describe, ptxas_usage, time_ms
from ..ops.attention import expand_position_table
from ..ops.kernels import _build
from ..ops.kernels import local_attention as la

SOURCE = _build.CSRC_DIR / "local_attention.cu"
B, H, D = 8, 6, 32
# (n, T, launches per 8 x 10 s request (encode, decode)): chip_smoke.py phase 3
SHAPES = ((750, 2250, (1, 2)), (250, 750, (2, 3)))
TOL = 1e-4
ITERS = 20

# (name, substitutions, computes the attention)
VARIANTS = (
    ("4 warps x 16 query rows, 64-key tiles, 2-stage ring", (), True),
    ("3-stage ring", (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),), True),
    ("8 warps x 16 query rows (128-query blocks)",
     (("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),), True),
    ("ablation: no exp in the softmax",
     (("const float p = expf(s[nt][e] - (e < 2 ? mu_a : mu_b));",
       "const float p = s[nt][e] - (e < 2 ? mu_a : mu_b);"),), False),
    ("ablation: one TF32 pass per product step (hi . hi)",
     (("  ptx::mma_tf32(d, al, bh);\n  ptx::mma_tf32(d, ah, bl);\n", ""),), False),
    ("ablation: no P V", (("for (int half = 0; half < 2; ++half) {",
                           "for (int half = 0; half < 0; ++half) {"),), False),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: CUDA is not available (it times kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    libs = build_variants("attention_variants", SOURCE, [subs for _, subs, _ in VARIANTS],
                          "l3ac_local_attention", la._ARGTYPES)
    print(f"[{describe(dev)}] local_attention variants, ms per call (max abs error)", flush=True)
    for i, ((name, _, _), (_, log)) in enumerate(zip(VARIANTS, libs)):
        print(f"  [{i}] {name}: {ptxas_usage(log, 'attention_kernelILi4ELi2E')}", flush=True)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    sums = [[0.0, 0.0] for _ in VARIANTS]
    for n, T, per in SHAPES:
        qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)).to(dev)
        q, k, v = (c.view(B, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1))
        table = torch.from_numpy(rng.standard_normal((2 * n, H)).astype(np.float32)).to(dev)
        want = la.local_attention_plain(q, k, v, window_size=n, bias=expand_position_table(table))
        out = torch.empty(B, T, H, D, device=dev)
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        line = f"n={n} T={T}:"
        for i, ((name, _, exact), (lib, _)) in enumerate(zip(VARIANTS, libs)):
            def call(lib=lib):
                err = lib.l3ac_local_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                               table.data_ptr(), out.data_ptr(), B, H, T, n, D,
                                               *strides, D ** -0.5, stream)
                if err:
                    raise RuntimeError(f"attention_variants [{i}]: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (out.permute(0, 2, 1, 3) - want).abs().max().item()
            if exact and not err <= TOL * max(1.0, want.abs().max().item()):
                raise AssertionError(f"attention_variants [{i}] n={n}: max abs error {err}")
            ms = time_ms(call, dev, ITERS)
            sums[i][0] += per[0] * ms
            sums[i][1] += per[1] * ms
            line += f" [{i}] {ms:.4f}" + (f" ({err:.1e})" if exact else "")
        print(line, flush=True)
    print("summed per 8 x 10 s request (encode, decode):")
    for i, (name, _, _) in enumerate(VARIANTS):
        print(f"  [{i}] {sums[i][0]:.3f} / {sums[i][1]:.3f} ms  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
