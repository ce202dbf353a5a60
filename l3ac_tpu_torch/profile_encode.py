"""Where the time of one encode request (or, with ``--decode``, one decode
request from FSQ indices) goes, on a CUDA card.

    python3 -m l3ac_tpu_torch.profile_encode [--model 1kbps] [--batch 8] [--seconds 10] [--decode] [--int8]

Builds the model with seeded random weights, warms it up on the request
shape, then traces three requests with ``torch.profiler`` and prints, per
request: host wall time, summed kernel (device) time, the device's idle
share of the wall, and device time by kernel name, largest first. A decode
request decodes seeded random indices, as many tokens as the audio length
gives. ``--int8`` quantizes the weights first (``ops.quantized.quantize_params``).
With ``--trace`` it also writes a Chrome trace there.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .models.zoo import get_model
from .ops.quantized import quantize_params

REQUESTS = 3


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
    ap.add_argument("--trace", default=None, help="write a Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    model = get_model(args.model, device="cuda", seed=0)
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
    what = ("int8 " if args.int8 else "") + ("decode" if args.decode else "encode")
    print(f"[{card}] {args.model} {what} B={args.batch} x {args.seconds} s: wall {wall_ms:.3f} ms "
          f"per request, device {device_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}, {sum(r[2] for r in rows)} kernels")
    for key, ms, cnt in rows[:25]:
        print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f} %  x{cnt:<4d} {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
