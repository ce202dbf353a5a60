"""Stochastic depth (drop-path) for residual branches
(``l3ac_tpu/ops/droppath.py``).

Per-sample Bernoulli keep mask over the residual *branch*, scaled by
1 / keep (the reference's ``scale_by_keep=True``). Train-only: with rate 0 or
no generator everything here is inert.

Randomness comes from an explicit ``torch.Generator`` on the tensor's device,
never from the global RNG. Where JAX splits a key into per-unit keys, the
port draws the units' masks one after another from one generator: the forward
order is fixed, so the masks are a function of the generator's seed alone.
:func:`split` derives child generators from a parent's seed, as
``jax.random.split`` derives keys from a key.
"""

from __future__ import annotations

import numpy as np
import torch


def drop_path(delta: torch.Tensor, drop_rate: float,
              generator: torch.Generator | None) -> torch.Tensor:
    """Randomly zero the residual branch ``delta`` per batch sample (batch on
    axis 0, any layout), the kept samples scaled by 1 / keep. Rate 0 or no
    generator: ``delta`` itself."""
    if drop_rate <= 0.0 or generator is None:
        return delta
    keep = 1.0 - drop_rate
    shape = (delta.shape[0],) + (1,) * (delta.dim() - 1)
    u = torch.rand(shape, generator=generator, device=delta.device)
    mask = (u < keep).to(delta.dtype) / keep
    return delta * mask


def schedule(rate: float, n: int, generator: torch.Generator | None, *,
             ascending: bool = True) -> list[tuple[float, torch.Generator | None]]:
    """Per-unit ``(drop_rate, generator)`` pairs on torch.linspace's ramp: the
    encoder 0 -> rate (reference ``l3ac/modules.py:89``), the decoder
    rate -> 0 (``:153``). With rate 0 or no generator: all inert."""
    if rate <= 0.0 or generator is None or n == 0:
        return [(0.0, None)] * n
    denom = max(n - 1, 1)
    fracs = [i / denom for i in range(n)]
    if not ascending:
        fracs = [1.0 - f for f in fracs]
    return [(rate * f, generator) for f in fracs]


def seeded(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def derive_seed(*words: int) -> int:
    """A 63-bit seed that is a pure function of ``words`` (numpy's
    SeedSequence), for generators keyed on, e.g., (seed, step)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def split(generator: torch.Generator | None, n: int) -> list[torch.Generator | None]:
    """``n`` generators on the parent's device, each seeded from the parent's
    seed and its index (the parent's state is not consumed); n Nones for
    None."""
    if generator is None:
        return [None] * n
    base = generator.initial_seed()
    return [seeded(derive_seed(base, i), generator.device) for i in range(n)]
