"""Where the time of one encode request (or, with ``--decode``, one decode
request from FSQ indices) goes, on a CUDA card.

    python3 -m l3ac_tpu_torch.profile_encode [--model 1kbps] [--batch 8] [--seconds 10] [--decode] [--int8]
        [--dtype bfloat16]

Builds the model with seeded random weights, warms it up on the request
shape, then traces three requests with ``torch.profiler`` and prints, per
request: host wall time, summed kernel (device) time, the device's idle
share of the wall, and device time by kernel name, largest first; then the
same time summed by the port's kernel families (``FAMILIES``: the wrapper
calls behind each, and the GEMM core's int8 and fp32 instances apart) beside
the wrappers' launch counts per request. A decode request decodes seeded
random indices, as many tokens as the audio length gives. ``--int8``
quantizes the weights first (``ops.quantized.quantize_params``).
``--dtype bfloat16`` builds the model in bf16 (``get_model(dtype=)``): encode
and decode run the bf16 kernels, with ``--int8`` too. With ``--trace`` it
also writes a Chrome trace there.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .models.zoo import get_model
from .ops import kernels as K
from .ops.quantized import quantize_params

REQUESTS = 3
# (family, patterns searched for in the device kernel names): the CUDA
# kernels behind each wrapper; one conv_unit call on the tensor-core path is
# three launches (dw_norm_kernel, gemm_kernel<false, snake or gelu>,
# gemm_kernel<false, residual>); its bf16 call is dw_norm_bf16_kernel and two
# launches of the wgmma core (sm90::gemm_kernel, whose Config ends in the
# int8 flag). The other bf16 variants carry their dtype in a template
# argument (the last bool of up_fused_tc_kernel, the element type of
# up_fused_stream_kernel) or their name (narrow_bf16_kernel,
# legacy_tail_bf16_kernel, up_bf16_kernel, ...). Each device kernel counts in the first
# family that names it.
FAMILIES = (
    ("int8_matmul: tc_gemm int8 (3 bf16 passes)", ("gemm_kernel<true",)),
    ("int8_matmul bf16: wgmma core, int8 tiles widened in shared memory",
     (r"sm90::gemm_kernel<l3ac::sm90::Config<\d+, \d+, \w+, true[,>]",)),
    ("conv_unit bf16: wgmma core (pw1, pw2)", ("sm90::gemm_kernel",)),
    ("conv_unit bf16: dw conv + ChannelNorm", ("dw_norm_bf16_kernel",)),
    ("up_fused bf16 (B, T, C): TMA + wgmma, persistent, statistics from the accumulators",
     ("up_fused_tc_bf16_kernel",)),
    ("up_fused bf16 (B, T, C) off the wgmma shapes: tensor cores (1 bf16 pass)",
     (r"up_fused_tc_kernel<.*, true>",)),
    ("up_fused_ct bf16 (B, C, T): warp tiles, z in registers (1 bf16 pass)", ("up_bf16_kernel",)),
    ("up_fused bf16 (B, T, C) at stream shapes: streaming (1 bf16 pass)",
     (r"up_fused_stream_kernel<[^,]*bfloat16",)),
    ("legacy_tail bf16: tensor cores (1 bf16 pass, taps folded into K)",
     ("legacy_tail_bf16_kernel",)),
    ("conv_unit_ct bf16: narrow fused, tensor cores (1 bf16 pass)", ("narrow_bf16_kernel",)),
    ("local_attention bf16: TMA + wgmma, ex2 softmax", ("attention_bf16_kernel",)),
    ("first_block bf16: a block per tile, GELU behind a warp vote (1 bf16 pass)",
     ("first_block_bf16",)),
    ("general routes (C3 widths): dw conv + ChannelNorm, up blend + ChannelNorm",
     ("general_dw_norm_kernel", "general_up_kernel")),
    ("conv_unit (C % 64 == 0): tc_gemm fp32 (3xTF32)", ("gemm_kernel<false",)),
    ("conv_unit (C % 64 == 0): dw conv + ChannelNorm", ("dw_norm_kernel",)),
    ("conv_unit_ct: narrow fused, tensor cores (3xTF32)", ("narrow_kernel",)),
    ("local_attention: tensor cores (3xTF32)", ("attention_kernel",)),
    ("up_fused (B, T, C): tensor cores (3xTF32)", ("up_fused_tc_kernel",)),
    ("up_fused_ct (B, C, T): streaming, tensor cores (3xTF32)", ("up_fused_stream_kernel",)),
    ("legacy_tail: tensor cores (3xTF32)", ("legacy_tail",)),
    ("first_block", ("first_block",)),
)


def _device_us(evt) -> float:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="1kbps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--decode", action="store_true",
                    help="profile decode_audio(indices=...) instead of encode_audio")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only: quantize_params(model.codec) before profiling")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the model's dtype")
    ap.add_argument("--trace", default=None, help="write a Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    model = get_model(args.model, device="cuda", seed=0, dtype=getattr(torch, args.dtype))
    if args.int8:
        quantize_params(model.codec)
    n = int(args.seconds * model.config.sample_rate)
    rng = np.random.default_rng(0)
    if args.decode:
        n_tok = -(-n // model.mc.hop_length)
        idx = torch.from_numpy(rng.integers(0, model.mc.vq.codebook_size, (args.batch, n_tok))
                               .astype(np.int32)).cuda()

        def request():
            return model.decode_audio(indices=idx)
    else:
        audio = torch.from_numpy((rng.standard_normal((args.batch, n)) * 0.1)
                                 .astype(np.float32)).cuda()

        def request():
            return model.encode_audio(audio)
    for _ in range(3):
        request()
    torch.cuda.synchronize()

    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / REQUESTS
    if args.trace:
        prof.export_chrome_trace(args.trace)

    rows = [(e.key, _device_us(e) / 1e3 / REQUESTS, e.count // REQUESTS)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    if not rows:
        raise SystemExit("profile_encode: the trace holds no device time")
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    what = ("int8 " if args.int8 else "") + ("bf16 " if args.dtype == "bfloat16" else "") + \
        ("decode" if args.decode else "encode")
    print(f"[{card}] {args.model} {what} B={args.batch} x {args.seconds} s: wall {wall_ms:.3f} ms "
          f"per request, device {device_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}, {sum(r[2] for r in rows)} kernels")
    for key, ms, cnt in rows[:25]:
        print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f} %  x{cnt:<4d} {key[:110]}")
    print(f"  by family (wrapper launches per request: "
          f"{ {k: v // REQUESTS for k, v in K.LAUNCHES.items() if v} }):")
    taken = set()
    for family, keys in FAMILIES:
        mine = [r for r in rows if r[0] not in taken and any(re.search(k, r[0]) for k in keys)]
        taken.update(r[0] for r in mine)
        if mine:
            ms = sum(r[1] for r in mine)
            print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f} %  x{sum(r[2] for r in mine):<4d} "
                  f"{family}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
