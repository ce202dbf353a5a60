"""Tool entry points of the port: the counterparts of the repo's ``tools/``
probes, run on the card.

    python3 -m l3ac_tpu_torch.tools.interleave_probe [--device cpu]
    python3 -m l3ac_tpu_torch.tools.bisect_kernel [--device cpu]

Each runs on CUDA unless given ``--device cpu``, where the kernel wrappers run
their plain versions and the times are host-clock times of those.
"""

from __future__ import annotations

import subprocess
import time
from collections.abc import Callable

import torch


def device(name: str, prog: str) -> torch.device:
    """The device a tool runs on; CUDA without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: CUDA is not available (--device cpu runs the plain versions)")
    return torch.device(name)


def describe(dev: torch.device) -> str:
    """The card as nvidia-smi names it, with its power limit, or the CPU."""
    if dev.type != "cuda":
        return "cpu: plain versions, host clock"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn: Callable, dev: torch.device, iters: int) -> float:
    """Mean ms per call after two warm-up calls: CUDA events around ``iters``
    calls on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
