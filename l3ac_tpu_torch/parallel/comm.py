"""The collectives of the port's parallelism, differentiable where training
needs them.

Every collective is an ``all_reduce`` (sum): NCCL across cards, gloo on the
CPU and for several ranks on one card, where gloo stages CUDA tensors
itself. A gather is an all-reduce of a zeroed buffer in which each rank
fills its own slot, viewed as int32 so that the sum is exact in any dtype
(``sp.exchange`` does the same for the halos).

- :func:`psum`: the sum over a group. Its backward is the sum of the
  cotangents over the group: rank r's input reaches every rank's output.
- :func:`reduce_sum` (Megatron's ``g``): the sum forward, the identity
  backward; for a sum whose result every rank then uses identically (the
  partial outputs of a tensor-parallel pair), so every rank already holds
  the whole cotangent.
- :func:`copy_sum` (Megatron's ``f``): the identity forward, the sum of the
  cotangents backward; for a replicated tensor that enters a rank's shard
  of a split computation.
- :func:`gather_cat`: the ranks' blocks concatenated along ``dim``, in group
  order. Its backward returns this rank's slice of the cotangent,
  unreduced: every rank computes the same function of the gathered tensor.

``STATS`` counts the all-reduces and the bytes each rank contributed, per
axis name, since the last :func:`reset_stats`.
"""

from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed as dist

STATS: dict[str, dict[str, int]] = defaultdict(lambda: {"calls": 0, "bytes": 0})


def reset_stats() -> None:
    STATS.clear()


def _count(axis: str, t: torch.Tensor) -> None:
    s = STATS[axis]
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, group, axis: str) -> torch.Tensor:
    """In-place sum over ``group`` (nothing for None), counted under ``axis``."""
    if group is not None:
        dist.all_reduce(t, group=group)
        _count(axis, t)
    return t


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, grad_sum):
        ctx.group, ctx.axis, ctx.grad_sum = group, axis, grad_sum
        return all_reduce_(x.clone(), group, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = all_reduce_(g.clone(), ctx.group, ctx.axis)
        return g, None, None, None


class _CopySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group, ctx.axis), None, None


def psum(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; x itself for None)."""
    if group is None:
        return x
    if _needs_grad(x):
        return _Psum.apply(x, group, axis, True)
    return all_reduce_(x.clone(), group, axis)


def reduce_sum(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """Megatron's ``g``: the sum over ``group``, identity backward."""
    if group is None:
        return x
    if _needs_grad(x):
        return _Psum.apply(x, group, axis, False)
    return all_reduce_(x.clone(), group, axis)


def copy_sum(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """Megatron's ``f``: x forward, the cotangents summed over ``group``
    backward; x itself when nothing records a gradient."""
    if group is None or not _needs_grad(x):
        return x
    return _CopySum.apply(x, group, axis)


def gather_raw(x: torch.Tensor, group, index: int, size: int, axis: str) -> list[torch.Tensor]:
    """Every rank's copy of ``x`` (same shape and dtype on every rank), bit
    for bit, through one all-reduce of an int32 buffer."""
    raw = x.detach().contiguous().view(-1).view(torch.uint8)
    nb = raw.numel()
    words = -(-nb // 8) * 2  # rows 8-byte aligned
    buf = torch.zeros((size, words), dtype=torch.int32, device=x.device)
    buf[index].view(torch.uint8)[:nb].copy_(raw)
    all_reduce_(buf, group, axis)
    return [buf[r].view(torch.uint8)[:nb].view(x.dtype).view(x.shape) for r in range(size)]


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size, dim, axis):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        return torch.cat(gather_raw(x, group, index, size, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None, None


def gather_cat(x: torch.Tensor, group, index: int, size: int, dim: int,
               axis: str) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order
    (every rank's block of the same shape); backward: this rank's slice."""
    if group is None or size == 1:
        return x
    if _needs_grad(x):
        return _GatherCat.apply(x, group, index, size, dim, axis)
    return torch.cat(gather_raw(x, group, index, size, axis), dim=dim)
