"""Minimal WAV I/O (stdlib ``wave`` + numpy; no librosa/soundfile dependency):
a copy of ``l3ac_tpu/utils/audio_io.py``.

PCM16 mono at the codec's sample rate. The reference's demo pulls librosa for
this (``example.py:7-31``); the CLI uses this dependency-free path.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path, *, expect_rate: int | None = None
             ) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} bytes")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if expect_rate is not None and rate != expect_rate:
        raise ValueError(
            f"{path}: sample rate {rate} != required {expect_rate}; resample "
            f"first (e.g. ffmpeg -i in.wav -ar {expect_rate} out.wav)")
    return data, rate


def write_wav(path: str | Path, samples: np.ndarray, rate: int) -> None:
    """Write float32 mono samples in [-1, 1] as PCM16 WAV."""
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
