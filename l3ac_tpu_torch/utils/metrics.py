"""Per-stream and host-level metrics (``l3ac_tpu/utils/metrics.py``).

Counters are plain host-side accumulators: metric collection never
synchronizes the device. Call ``torch.cuda.synchronize()`` before
``ThroughputMeter.stop`` and ``snapshot()`` when the timed work ran on the
card.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

log = logging.getLogger("l3ac_tpu_torch")


@dataclass
class ThroughputMeter:
    """Tracks audio-seconds processed vs wall time -> real-time factor."""

    name: str = "codec"
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    calls: int = 0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, audio_seconds: float):
        assert self._t0 is not None, "start() not called"
        self.wall_seconds += time.perf_counter() - self._t0
        self.audio_seconds += audio_seconds
        self.calls += 1
        self._t0 = None

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def snapshot(self) -> dict:
        return {"name": self.name, "rtf": round(self.rtf, 2),
                "audio_seconds": round(self.audio_seconds, 3),
                "wall_seconds": round(self.wall_seconds, 4),
                "calls": self.calls}


@dataclass
class StreamMetrics:
    """Aggregates per-stream codec throughput numbers."""

    meters: dict = field(default_factory=dict)

    def meter(self, name: str) -> ThroughputMeter:
        if name not in self.meters:
            self.meters[name] = ThroughputMeter(name=name)
        return self.meters[name]

    def log_snapshot(self):
        for m in self.meters.values():
            log.info("metrics %s", json.dumps(m.snapshot()))

    def snapshot(self) -> dict:
        return {k: m.snapshot() for k, m in self.meters.items()}


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def mse(a, b) -> float:
    """Mean squared difference in float64 of two arrays or tensors."""
    a, b = _f64(a), _f64(b)
    return float(((a - b) ** 2).mean())
