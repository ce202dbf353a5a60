"""Losses and the single-device train step (``l3ac_tpu/train.py:28-142``).

Loss: L2 + 0.1 L1 on the waveform plus the (zero) commitment term, and with
``spectral`` the multi-resolution STFT loss (spectral convergence + log
magnitude L1, Hann window) and the log-mel L1 (HTK mel filterbank), the JAX
package's stand-in for the reference's unpublished recipe. Same floors
(1e-7 under the STFT logs and norms, 1e-5 under the mel logs) and the same
framing: frames of ``n_fft`` every ``hop`` samples, as many as fit and at
least one, a clip shorter than a frame repeating its last sample (JAX's
gather clamps the frame indices past the end) with no gradient through the
repeats (its transpose drops them).

The forward goes through the port's kernels on the card (their backward is
the plain versions' gradient, ``ops/kernels/autograd.py``) and through the
plain versions on the CPU; on the CPU the gradients equal JAX's
``jax.value_and_grad(loss_fn)`` of the jnp path.

``make_train_step`` is JAX's single-device step (plain SGD, or an
optimizer: the trainer's ``torch.optim.Adam``, optax.adam's defaults);
``spectral`` is taken here as the sharded step and the trainer take it. The
sharded step (``make_sharded_train_step``) comes with parallelism (ROADMAP
A11).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable

import numpy as np
import torch

from .models.codec import Codec

# (n_fft, hop) pairs of the multi-resolution STFT loss (l3ac_tpu/train.py:68)
STFT_RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))


def _hann(n: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n, device=device, dtype=dtype) / n)


def _frame(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame), n_frames = max(1, 1 + (T - frame) //
    hop); a clip shorter than a frame repeats its last sample, which carries
    no gradient there (JAX's gather clamps the indices, and its transpose
    drops the out-of-bounds positions)."""
    T = x.shape[-1]
    if T < frame:
        x = torch.cat([x, x[:, -1:].detach().expand(-1, frame - T)], dim=-1)
    return x.unfold(-1, frame, hop)


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Magnitude STFT (B, frames, n_fft // 2 + 1), Hann window, fp32 (float64
    for float64 x: the CPU reference of the training checks)."""
    x = x if x.dtype == torch.float64 else x.float()
    frames = _frame(x, n_fft, hop) * _hann(n_fft, x.device, x.dtype)
    return torch.fft.rfft(frames, dim=-1).abs()


def _mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                    fmax: float | None = None) -> np.ndarray:
    """Triangular mel filterbank (HTK mel scale), (n_mels, n_fft // 2 + 1)
    float32, in numpy as JAX builds it."""
    fmax = fmax or sr / 2
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    pts = imel(np.linspace(mel(fmin), mel(fmax), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c > l:
            fb[i, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


@functools.lru_cache(maxsize=None)
def _mel_matrix(sr: int, n_fft: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """The filterbank's transpose (n_fft // 2 + 1, n_mels) on ``device``, made
    once per device (outside inference mode, so a training graph may save
    it)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_mel_filterbank(sr, n_fft, n_mels).T.copy()).to(device)


def stft_loss(y: torch.Tensor, x: torch.Tensor, resolutions=STFT_RESOLUTIONS) -> torch.Tensor:
    """Multi-resolution STFT loss: spectral convergence + log-magnitude L1,
    averaged over the resolutions."""
    total = 0.0
    for n_fft, hop in resolutions:
        my = _stft_mag(y, n_fft, hop)
        mx = _stft_mag(x, n_fft, hop)
        sc = torch.linalg.vector_norm(my - mx) / (torch.linalg.vector_norm(mx) + 1e-7)
        mag = torch.mean(torch.abs(torch.log(my + 1e-7) - torch.log(mx + 1e-7)))
        total = total + sc + mag
    return total / len(resolutions)


def mel_loss(y: torch.Tensor, x: torch.Tensor, sr: int = 16000, n_fft: int = 1024,
             hop: int = 256, n_mels: int = 80) -> torch.Tensor:
    """Log-mel-spectrogram L1."""
    my, mx = _stft_mag(y, n_fft, hop), _stft_mag(x, n_fft, hop)
    fb = _mel_matrix(sr, n_fft, n_mels, y.device).to(my.dtype)
    my, mx = my @ fb, mx @ fb
    return torch.mean(torch.abs(torch.log(my + 1e-5) - torch.log(mx + 1e-5)))


def loss_fn(codec: Codec, audio: torch.Tensor, generator: torch.Generator | None = None,
            spectral: bool = False, drop_path_rate: float = 0.0
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, metrics) of ``codec``'s training forward on (B, T) ``audio``:
    ``wav_l2``, ``wav_l1``, with ``spectral`` also ``stft`` and ``mel``, and
    ``loss``. ``generator``: FSQ's noise and, with ``drop_path_rate > 0``,
    stochastic depth (``Codec.forward``)."""
    out = codec(audio, training=True, generator=generator, drop_path_rate=drop_path_rate)
    y = out["generated_audio"]
    wav_l2 = torch.mean((y - audio) ** 2)
    wav_l1 = torch.mean(torch.abs(y - audio))
    loss = wav_l2 + 0.1 * wav_l1 + out["commit_loss"]
    metrics = {"wav_l2": wav_l2, "wav_l1": wav_l1}
    if spectral:
        sl = stft_loss(y, audio)
        ml = mel_loss(y, audio)
        loss = loss + sl + ml
        metrics["stft"] = sl
        metrics["mel"] = ml
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def sgd_update(codec: Codec, lr: float) -> None:
    """``p -= lr * grad`` for every parameter with a gradient, in place."""
    for p in codec.parameters():
        if p.grad is not None:
            p.sub_(lr * p.grad)


def make_train_step(codec: Codec, lr: float = 1e-4,
                    optimizer: torch.optim.Optimizer | None = None,
                    drop_path_rate: float = 0.0, spectral: bool = False) -> Callable:
    """A single-device train step over ``codec``'s parameters, updated in
    place: ``step(audio, generator=None) -> metrics`` (detached tensors).
    With ``optimizer`` (over ``codec.parameters()``) its ``step()``, else
    plain SGD at ``lr``. ``generator`` as in :func:`loss_fn`."""

    def step(audio: torch.Tensor, generator: torch.Generator | None = None) -> dict:
        for p in codec.parameters():
            p.grad = None
        loss, metrics = loss_fn(codec, audio, generator=generator, spectral=spectral,
                                drop_path_rate=drop_path_rate)
        loss.backward()
        if optimizer is None:
            sgd_update(codec, lr)
        else:
            optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
