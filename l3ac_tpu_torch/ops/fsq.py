"""Finite Scalar Quantization: the eval path (``l3ac_tpu/ops/fsq.py:57-78``),
the training path's straight-through estimator with the uniform-noise
injection (``:81-111``, :func:`quantize_ste`) and the closed-form unpack
(``:114-131``).

No codebook and no search: a per-dimension squash ``(tanh(z) + 1) / 2`` to
[0, 1], a round to one of L levels, and a mixed-radix pack of the level
indices into one int32 index. The released configs use tanh with the
"special edge" rounding, which hits 0 and L-1 exactly. The squash and the
round run in float32 whatever the input dtype, so the indices do not depend
on the compute dtype. ``torch.round`` rounds half to even, as ``jnp.round``
does. The unpack is integer mixed-radix arithmetic, exact for every index.
"""

import functools
import math

import torch

from .droppath import rand_block


@functools.lru_cache(maxsize=None)
def _levels(levels: tuple[int, ...], device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The level counts and the mixed-radix basis on ``device``, made once
    per (levels, device): a table built from a Python list on a CUDA device
    is a synchronizing copy, which would stop the host at every call. Made
    outside inference mode, so that any caller may use them."""
    with torch.inference_mode(False):
        lv = torch.tensor(levels, dtype=torch.float32, device=device)
        basis = torch.tensor([math.prod(levels[:i]) for i in range(len(levels))],
                             dtype=torch.int32, device=device)
    return lv, basis


def pre_round(z: torch.Tensor, levels: tuple[int, ...]) -> torch.Tensor:
    """The value that ``quantize`` rounds: ``act(z) * (L - 1)`` per dim, fp32."""
    lv, _ = _levels(levels, z.device)
    return (torch.tanh(z.float()) + 1.0) / 2.0 * (lv - 1.0)


def quantize(z: torch.Tensor, levels: tuple[int, ...]):
    """z: (..., D) -> (q_z (..., D), indices (...) int32, level indices (..., D) int32)."""
    lv, basis = _levels(levels, z.device)
    li = torch.round(pre_round(z, levels))
    q_act = li / (lv - 1.0)
    li_i = li.to(torch.int32)
    indices = (li_i * basis).sum(dim=-1, dtype=torch.int32)
    q_z = q_act * 2.0 - 1.0
    return q_z.to(z.dtype), indices, li_i


def quantize_ste(z: torch.Tensor, levels: tuple[int, ...], *, noise_rate: float = 0.0,
                 generator: torch.Generator | None = None):
    """Training-path quantize with the reference's straight-through estimator
    (``l3ac/vq/fsq.py:56-65``), applied at the activation value: the gradient
    flows through ``act(z)``, the round and the linear inverse pass it
    through. With ``noise_rate > 0`` and a generator (on z's device), each
    element is, with that probability, ``act(z) + U(-0.5, 0.5) / L`` instead
    of its quantized value (``:40-43``). The indices come from the detached
    input, as :func:`quantize` gives them. Returns (q_z, indices, level
    indices) as :func:`quantize` does."""
    lv, _ = _levels(levels, z.device)
    act_z = (torch.tanh(z.float()) + 1.0) / 2.0
    q_act = act_z + (torch.round(act_z * (lv - 1.0)) / (lv - 1.0) - act_z).detach()
    if noise_rate > 0.0 and generator is not None:
        mask = rand_block(act_z.shape, generator, z.device, time_dim=1) <= noise_rate
        noise = (rand_block(act_z.shape, generator, z.device, time_dim=1) - 0.5) / lv
        q_act = torch.where(mask, act_z + noise, q_act)
    q_z = q_act * 2.0 - 1.0
    _, indices, li = quantize(z.detach(), levels)
    return q_z.to(z.dtype), indices, li


def indices_to_level_indices(indices: torch.Tensor, levels: tuple[int, ...]) -> torch.Tensor:
    """Mixed-radix unpack: (...) int -> (..., D) int32 level indices."""
    lv, basis = _levels(levels, indices.device)
    idx = indices.to(torch.int64)[..., None]
    return torch.remainder(torch.div(idx, basis.to(torch.int64), rounding_mode="floor"),
                           lv.to(torch.int64)).to(torch.int32)


def indices_to_codes(indices: torch.Tensor, levels: tuple[int, ...]) -> torch.Tensor:
    """Indices (...) -> fp32 codes (..., D) in [-1, 1] ("special edge" levels,
    as ``quantize`` emits them)."""
    lv, _ = _levels(levels, indices.device)
    li = indices_to_level_indices(indices, levels).to(torch.float32)
    return li / (lv - 1.0) * 2.0 - 1.0
