"""Tool entry points of the port: the counterparts of the repo's ``tools/``
probes, run on the card.

    python3 -m l3ac_tpu_torch.tools.interleave_probe [--device cpu]
    python3 -m l3ac_tpu_torch.tools.bisect_kernel [--device cpu]

Each runs on CUDA unless given ``--device cpu``, where the kernel wrappers run
their plain versions and the times are host-clock times of those.

The variant tools (``narrow_variants``, ``attention_variants``,
``tail_variants``, ``up_variants``, ``rows_variants``; card only) time a
kernel beside text substitutions of its source, built by
:func:`build_variants`.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import time
from collections.abc import Callable
from pathlib import Path

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


def queued_ms(fn: Callable, iters: int, repeats: int = 3) -> float:
    """The card's time for one call of ``fn``, ms, without the host's: CUDA
    events around ``iters`` calls (after two warm-up calls) that the host
    enqueues while a sleeping kernel (``torch.cuda._sleep``, twice the host's
    enqueue time long) keeps the card busy, so that the calls run back to
    back; the least of ``repeats`` such measurements (a host stall longer
    than the sleep lets a gap in). A loop of launches shorter than the host's
    work per launch reads as host time under :func:`time_ms`."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0  # enqueue time of the calls (at least)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * 2e9))  # cycles: twice that at 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def variant_source(path: Path, subs, tool: str) -> str:
    """The source at ``path`` with ``subs`` ((old, new) pairs) applied; each
    must match exactly once."""
    src = path.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{tool}: {old[:60]!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(tool: str, path: Path, subs_list, symbol: str,
                   argtypes: list) -> list[tuple[ctypes.CDLL, str]]:
    """Each substitution set applied to ``path`` and built with the kernel
    library's nvcc flags into its own library (cached by its source), all
    nvcc processes started together; returns each library, its ``symbol``
    typed, and ptxas's output."""
    from ..ops.kernels import _build
    procs = []
    for i, subs in enumerate(subs_list):
        src = variant_source(path, subs, tool)
        h = hashlib.sha256(src.encode() + _build.source_hash().encode()).hexdigest()[:16]
        d = _build.BUILD_DIR / f"{tool}-{h}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"v{i}.cu").write_text(src)
        procs.append((d, i, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
             str(d / f"v{i}.cu"), "-o", str(d / f"v{i}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for d, i, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{tool}: variant {i} failed to build:\n{log}")
        lib = ctypes.CDLL(str(d / f"v{i}.so"))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out.append((lib, log))
    return out


def ptxas_usage(log: str, entry: str) -> str:
    """'registers / spill bytes' of the kernel whose mangled name contains
    ``entry``, from ptxas's -v output."""
    inside, regs, spill = False, None, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            inside = entry in line
        elif inside:
            r = re.search(r"Used (\d+) registers", line)
            s = re.search(r"(\d+) bytes spill stores", line)
            regs = r.group(1) if r else regs
            spill = s.group(1) if s else spill
    return f"{regs} regs / {spill} B spill"
