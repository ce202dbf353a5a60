"""Linear upsampling by an integer factor, ``nn.Upsample(mode="linear",
align_corners=False)`` (``l3ac_tpu/ops/resample.py:upsample_linear`` and
``transposed.py:upsample_linear_t``).

Output ``j`` reads the source coordinate ``(j + 0.5) / s - 0.5`` clamped to
[0, T - 1], so the edge frame is repeated at both edges (never zero). With a
fixed factor the s phases have constant weights: phase p of ``out[t s + p]``
blends ``x[t - 1], x[t], x[t + 1]`` with :func:`phase_weights`, the same
formula as the JAX package, and an interleave.
"""

import torch


def phase_weights(scale: int) -> list[tuple[float, float, float]]:
    """Per-phase (w_prev, w_cur, w_next) of the blend, as Python floats."""
    taps = []
    for p in range(scale):
        d = (p + 0.5) / scale - 0.5
        if d >= 0:
            taps.append((0.0, 1.0 - d, d))
        else:
            w = 1.0 + d
            taps.append((1.0 - w, w, 0.0))
    return taps


def upsample_phases(x: torch.Tensor, scale: int, dim: int) -> list[torch.Tensor]:
    """The ``scale`` phases of the upsample along time axis ``dim``, each
    shaped like x: ``out[.., t * scale + p] = phases[p][.., t]``."""
    T = x.shape[dim]
    x_prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, T - 1)], dim=dim)
    x_next = torch.cat([x.narrow(dim, 1, T - 1), x.narrow(dim, T - 1, 1)], dim=dim)
    phases = []
    for wp, wc, wn in phase_weights(scale):
        if wp:
            phases.append(x_prev * wp + x * wc)
        else:
            phases.append(x * wc + x_next * wn)
    return phases


def interleave(phases: list[torch.Tensor], dim: int) -> torch.Tensor:
    """Inverse of the phase split: ``out[.., t * s + p] = phases[p][.., t]``."""
    x = torch.stack(phases, dim=dim + 1)
    shape = list(phases[0].shape)
    shape[dim] *= len(phases)
    return x.reshape(shape)


def upsample_linear(x: torch.Tensor, scale: int, dim: int = 1) -> torch.Tensor:
    """Upsample time axis ``dim`` by ``scale``: 1 for (B, T, C), 2 for
    (B, C, T)."""
    if scale == 1:
        return x
    return interleave(upsample_phases(x, scale, dim), dim)
