"""Where the time of one training step goes, on a CUDA card.

    python3 -m l3ac_tpu_torch.profile_train [--model 1kbps] [--batch 2] [--seconds 3]
        [--no-spectral]

Builds the codec as the trainer does (seeded weights, no position-bias
caches, fp32), warms up two Adam steps on a ``SyntheticAudio`` batch, then
traces ``STEPS`` steps with ``torch.profiler`` and prints per step: the host
wall time, the kernels' device time and the device's idle share of the wall;
the kernels' time inside the forward (``train:forward``), the backward and
the optimizer (``train:optimizer``); the forward's port kernels by family
(as ``profile_encode.FAMILIES`` names them) and the backward's plain
recomputes by kernel family (the kernels' time inside each
``backward:<name>`` range of ``ops/kernels/autograd.KernelFunction``). The
ranges' own spans on the device's timeline are not counted as kernels. CUDA
events around the forward, the backward and the optimizer give the split on
the host's view of the device, without the profiler.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .profile_encode import FAMILIES, _device_us

STEPS = 3


def _device_total_us(evt) -> float:
    """Device time of an event and its children (a ``record_function`` range)."""
    for key in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def step_events(codec, optimizer, audio: torch.Tensor, spectral: bool = True) -> dict:
    """One training step with CUDA events around its forward (the loss
    included), backward and optimizer step: their ms and the whole step's."""
    from .train import loss_fn
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with record_function("train:forward"):
        for p in codec.parameters():
            p.grad = None
        loss, _ = loss_fn(codec, audio, spectral=spectral)
    ev[1].record()
    with record_function("train:backward"):
        loss.backward()
    ev[2].record()
    with record_function("train:optimizer"):
        optimizer.step()
    ev[3].record()
    torch.cuda.synchronize()
    return {"forward_ms": ev[0].elapsed_time(ev[1]), "backward_ms": ev[1].elapsed_time(ev[2]),
            "optimizer_ms": ev[2].elapsed_time(ev[3]), "step_ms": ev[0].elapsed_time(ev[3])}


def _annotation(evt) -> bool:
    """A ``record_function`` range (on the device's timeline too), not a
    kernel."""
    return getattr(evt, "is_user_annotation", False) or evt.key.startswith(("train:",
                                                                           "backward:"))


def profile_steps(codec, optimizer, audio: torch.Tensor, spectral: bool = True,
                  steps: int = STEPS) -> dict:
    """``steps`` traced training steps -> per step: ``wall_ms``, ``device_ms``
    (the kernels' summed time), ``idle``, ``forward_kernels_ms`` (the port's
    kernels by family), ``backward_ms`` (by kernel family: the device time of
    the plain recompute's kernels inside each ``backward:<name>`` range),
    ``forward_total_ms`` / ``optimizer_ms`` (the kernels' time inside those
    ranges), ``backward_total_ms`` (the rest of the kernels' time),
    ``launches``."""
    from .ops import kernels as K
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_events(codec, optimizer, audio, spectral)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    kernels = [(e.key, _device_us(e) / 1e3 / steps) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and not _annotation(e)
               and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("profile_train: the trace holds no device time")
    device_ms = sum(ms for _, ms in kernels)
    forward, taken = {}, set()
    for family, keys in FAMILIES:
        mine = [(k, ms) for k, ms in kernels
                if k not in taken and any(re.search(p, k) for p in keys)]
        taken.update(k for k, _ in mine)
        if mine:
            forward[family] = sum(ms for _, ms in mine)
    ranges = {e.key: _device_total_us(e) / 1e3 / steps for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and _annotation(e)}
    backward = {k.split(":", 1)[1]: ms for k, ms in ranges.items() if k.startswith("backward:")}
    fwd, opt = ranges.get("train:forward", 0.0), ranges.get("train:optimizer", 0.0)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle": max(0.0, 1 - device_ms / wall_ms), "forward_kernels_ms": forward,
            "backward_ms": dict(sorted(backward.items(), key=lambda kv: -kv[1])),
            "forward_total_ms": fwd, "optimizer_ms": opt,
            "backward_total_ms": device_ms - fwd - opt,
            "launches": {k: v // steps for k, v in K.LAUNCHES.items() if v}}


def report(prof: dict, label: str, log=print) -> None:
    log(f"  {label}: wall {prof['wall_ms']:.3f} ms per step (under the profiler), device "
        f"{prof['device_ms']:.3f} ms, idle share {prof['idle']:.3f}; device ms of the forward "
        f"{prof['forward_total_ms']:.3f}, the backward {prof['backward_total_ms']:.3f}, the "
        f"optimizer {prof['optimizer_ms']:.3f}; forward launches {prof['launches']}")
    fk = prof["forward_kernels_ms"]
    log(f"    forward, the port's kernels: {sum(fk.values()):.3f} ms")
    for family, ms in sorted(fk.items(), key=lambda kv: -kv[1]):
        log(f"      {ms:9.4f} ms  {family}")
    bk = prof["backward_ms"]
    log(f"    backward, the plain recompute by kernel family: {sum(bk.values()):.3f} ms of "
        f"{prof['backward_total_ms']:.3f}")
    for name, ms in bk.items():
        log(f"      {ms:9.4f} ms  {100 * ms / max(prof['backward_total_ms'], 1e-9):5.1f} %  {name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="1kbps")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-spectral", action="store_true", help="the waveform loss alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    from .config import get_config
    from .trainer import SyntheticAudio, build_codec
    codec = build_codec(args.model, "cuda")
    optimizer = torch.optim.Adam(codec.parameters(), lr=1e-4)
    hop = codec.mc.hop_length
    samples = max(hop, int(args.seconds * get_config(args.model).sample_rate) // hop * hop)
    audio = torch.from_numpy(SyntheticAudio(args.batch, samples, 0)(0)).cuda()
    for _ in range(2):
        step_events(codec, optimizer, audio, not args.no_spectral)
    ev = step_events(codec, optimizer, audio, not args.no_spectral)
    print(f"[{card}] {args.model} training step B={args.batch} x {samples} samples, "
          f"spectral={not args.no_spectral}: {ev['step_ms']:.3f} ms (forward "
          f"{ev['forward_ms']:.3f}, backward {ev['backward_ms']:.3f}, optimizer "
          f"{ev['optimizer_ms']:.3f}), "
          f"{args.batch * samples / 16000 / (ev['step_ms'] / 1e3):.1f}x realtime")
    report(profile_steps(codec, optimizer, audio, not args.no_spectral), "traced", print)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
