"""Finite Scalar Quantization, eval path (``l3ac_tpu/ops/fsq.py:57-78``).

No codebook and no search: a per-dimension squash ``(tanh(z) + 1) / 2`` to
[0, 1], a round to one of L levels, and a mixed-radix pack of the level
indices into one int32 index. The released configs use tanh with the
"special edge" rounding, which hits 0 and L-1 exactly. The squash and the
round run in float32 whatever the input dtype, so the indices do not depend
on the compute dtype. ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""

import math

import torch


def _levels(levels: tuple[int, ...], device) -> tuple[torch.Tensor, torch.Tensor]:
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
