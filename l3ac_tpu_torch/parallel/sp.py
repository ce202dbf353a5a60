"""Sequence parallelism: per-op halo exchange (``l3ac_tpu/parallel/sp.py``).

Inside ``with sequence_parallel(mesh, "sp"):`` every rank of the mesh's sp
group holds one time block of the same stream, and the ops of the port
consult this module as they run: a time-axis pad becomes a neighbour halo
exchange, edge shards take the op's own pad value (zero for convs and the
average pool, -inf for the max pool), the linear upsample's clamped
neighbours come from the next shard, the windowed attention's first window
reads the left shard's last window, and the model's two reductions over time
(GRN's norm, the EnhanceBlock's instance norm) are summed over the group.
So the sharded result equals the single-device one to float tolerance, and
the FSQ indices equal it exactly.

The context is plain Python state that ``models.codec.encode_sp`` and its
siblings (and the sharded train step) enter around one call; it is not a
switch a user sets.

Training: the halo blocks are differentiable (:class:`_Halos`). The
backward of an exchange is the exchange of the halos' cotangents the other
way: each rank sends the cotangent of its left halo back to its left
neighbour and that of its right halo to its right one, and adds what comes
back to its own boundary frames' gradients. The reductions over the group
are differentiable sums (``parallel.comm.psum``).

The exchange (:func:`exchange`) is one collective for both directions: each
rank writes the blocks it sends into its own row of a zeroed
(size, bytes) buffer, viewed as int32, and one ``all_reduce`` (sum) gives
every rank every row; a sum with zeros is exact in integers, so the blocks
arrive bit for bit in any dtype. The first (last) shard reads no left
(right) row and takes the op's fill instead, as ``lax.ppermute``'s missing
edge gives it in JAX. It works on both backends: NCCL across cards, gloo on
the CPU and for several ranks on one card; both take the CUDA buffer as it
is (gloo's all-reduce accepts CUDA tensors and stages them itself).
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import comm

ALIGN = 16  # bytes: each block's offset in the exchange buffer

# exchanges since the last reset: calls and bytes each rank contributed
STATS = {"calls": 0, "bytes": 0, "psum_calls": 0}


@dataclasses.dataclass(frozen=True)
class Context:
    group: object | None  # the sp process group, None for one rank
    index: int
    size: int


_CTX: list[Context | None] = [None]


@contextmanager
def sequence_parallel(mesh, axis_name: str = "sp"):
    """Run the ops inside this block as rank ``mesh.coords[axis_name]`` of
    the mesh's ``axis_name`` group."""
    prev = _CTX[0]
    _CTX[0] = Context(mesh.group(axis_name), mesh.coords[axis_name], mesh.shape[axis_name])
    try:
        yield
    finally:
        _CTX[0] = prev


@contextmanager
def suspended():
    """SP off inside this block: a kernel wrapper that has staged its halos
    runs its plain version on the staged buffer as one local call."""
    prev = _CTX[0]
    _CTX[0] = None
    try:
        yield
    finally:
        _CTX[0] = prev


def active() -> bool:
    return _CTX[0] is not None


def index() -> int:
    return _CTX[0].index


def size() -> int:
    return _CTX[0].size


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _all_reduce(buf: torch.Tensor) -> None:
    """The sum over the active sp group, in place (a hook a timing harness
    may wrap)."""
    dist.all_reduce(buf, group=_CTX[0].group)


def exchange(to_right: list[torch.Tensor | None], to_left: list[torch.Tensor | None],
             ctx: Context | None = None
             ) -> tuple[list[torch.Tensor | None], list[torch.Tensor | None]]:
    """Every rank sends ``to_right`` to its right neighbour and ``to_left``
    to its left one, in one collective. Returns (the left neighbour's
    ``to_right`` blocks, the right neighbour's ``to_left`` blocks); None on
    the edge where there is no neighbour, and for a None block. ``ctx``:
    the group to exchange over (default: the active one). Not
    differentiable: :func:`halo_blocks_many` is."""
    ctx = _CTX[0] if ctx is None else ctx
    parts = [t for t in to_right + to_left if t is not None]
    offs, nbytes, total = [], [], 0
    for t in parts:
        offs.append(total)
        nb = t.numel() * t.element_size()
        nbytes.append(nb)
        total += -(-nb // ALIGN) * ALIGN
    if not parts:
        return [None] * len(to_right), [None] * len(to_left)
    device = parts[0].device
    buf = torch.zeros((ctx.size, total // 4), dtype=torch.int32, device=device)
    mine = buf[ctx.index].view(torch.uint8)
    for t, o, nb in zip(parts, offs, nbytes):
        mine[o:o + nb].copy_(t.contiguous().view(-1).view(torch.uint8))
    if ctx.size > 1:
        if ctx is _CTX[0]:
            _all_reduce(buf)
        else:
            dist.all_reduce(buf, group=ctx.group)
    STATS["calls"] += 1
    STATS["bytes"] += total

    def read(row: int, k: int) -> torch.Tensor:
        t = parts[k]
        o, nb = offs[k], nbytes[k]
        return buf[row].view(torch.uint8)[o:o + nb].view(t.dtype).view(t.shape)

    left_in, right_in, k = [], [], 0
    for t in to_right:
        if t is None:
            left_in.append(None)
            continue
        left_in.append(read(ctx.index - 1, k) if ctx.index > 0 else None)
        k += 1
    for t in to_left:
        if t is None:
            right_in.append(None)
            continue
        right_in.append(read(ctx.index + 1, k) if ctx.index < ctx.size - 1 else None)
        k += 1
    return left_in, right_in


def _check(x: torch.Tensor, left: int, right: int, axis: int) -> None:
    # the exchange reaches only the immediate neighbour
    if left > x.shape[axis] or right > x.shape[axis]:
        raise ValueError(
            f"SP halo ({left},{right}) exceeds per-shard length "
            f"{x.shape[axis]} on axis {axis}; use more samples per shard")


def halo_blocks_many(xs: list[torch.Tensor], left: int, right: int, *, axis: int = 1,
                     fill: float = 0.0) -> list[tuple[torch.Tensor | None, torch.Tensor | None]]:
    """:func:`halo_blocks` of several tensors in one exchange; differentiable
    (:class:`_Halos`) where autograd records on them."""
    for x in xs:
        _check(x, left, right, axis)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        flat = iter(_Halos.apply(_CTX[0], left, right, axis, fill, *xs))
        return [(next(flat) if left else None, next(flat) if right else None) for _ in xs]
    return _halo_blocks(xs, left, right, axis, fill)


def _halo_blocks(xs, left, right, axis, fill, ctx=None):
    tails = [x.narrow(axis, x.shape[axis] - left, left) if left else None for x in xs]
    heads = [x.narrow(axis, 0, right) if right else None for x in xs]
    got_l, got_r = exchange(tails, heads, ctx)
    out = []
    for tail, head, lh, rh in zip(tails, heads, got_l, got_r):
        if tail is not None and lh is None:
            lh = torch.full(tail.shape, fill, dtype=tail.dtype, device=tail.device)
        if head is not None and rh is None:
            rh = torch.full(head.shape, fill, dtype=head.dtype, device=head.device)
        out.append((lh, rh))
    return out


class _Halos(torch.autograd.Function):
    """The halo blocks of ``xs`` (edge shards: ``fill``), flattened as
    (lh, rh) per tensor where the width is not 0. Backward: the cotangents
    go back the other way in one exchange and are added to the boundary
    frames they came from; an edge's fill gets none."""

    @staticmethod
    def forward(ctx, sp_ctx, left, right, axis, fill, *xs):
        ctx.sp_ctx, ctx.left, ctx.right, ctx.axis = sp_ctx, left, right, axis
        ctx.shapes, ctx.like = [x.shape for x in xs], (xs[0].dtype, xs[0].device)
        pairs = _halo_blocks(list(xs), left, right, axis, fill, sp_ctx)
        return tuple(t for pair in pairs for t in pair if t is not None)

    @staticmethod
    def backward(ctx, *grads):
        # (autograd materializes an unused output's cotangent as zeros)
        left, right, axis = ctx.left, ctx.right, ctx.axis
        it = iter(grads)
        g_l, g_r = [], []
        for _ in ctx.shapes:  # forward's order: each tensor's (lh, rh)
            g_l.append(next(it) if left else None)
            g_r.append(next(it) if right else None)
        # my left halo's cotangent belongs to my left neighbour's tail: send
        # it left; my right halo's to my right neighbour's head: send it right
        head_g, tail_g = exchange(g_r, g_l, ctx.sp_ctx)
        out = []
        for shape, hg, tg in zip(ctx.shapes, head_g, tail_g):
            dx = torch.zeros(shape, dtype=ctx.like[0], device=ctx.like[1])
            if tg is not None:
                dx.narrow(axis, shape[axis] - left, left).add_(tg)
            if hg is not None:
                dx.narrow(axis, 0, right).add_(hg)
            out.append(dx)
        return (None, None, None, None, None, *out)


def halo_blocks(x: torch.Tensor, left: int, right: int, *, axis: int = 1,
                fill: float = 0.0) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """This shard's halo blocks (SP must be active): ``lh`` the left
    neighbour's last ``left`` frames (``fill`` on the globally first shard),
    ``rh`` the right neighbour's first ``right`` frames (``fill`` on the
    globally last); None where the width is 0. Raises when a halo exceeds the
    shard."""
    return halo_blocks_many([x], left, right, axis=axis, fill=fill)[0]


def edge_flags() -> tuple[int, int]:
    """(is the globally first shard, is the globally last shard), 0 / 1: where
    the kernels' own end padding applies."""
    ctx = _CTX[0]
    return int(ctx.index == 0), int(ctx.index == ctx.size - 1)


def _pad(x: torch.Tensor, left: int, right: int, axis: int, fill: float) -> torch.Tensor:
    axis = axis % x.dim()
    if axis == x.dim() - 1:
        return F.pad(x, (left, right), value=fill)
    shape = list(x.shape)
    parts = []
    if left:
        shape[axis] = left
        parts.append(x.new_full(shape, fill))
    parts.append(x)
    if right:
        shape[axis] = right
        parts.append(x.new_full(shape, fill))
    return torch.cat(parts, dim=axis)


def pad_time(x: torch.Tensor, left: int, right: int, *, axis: int = 1,
             fill: float = 0.0) -> torch.Tensor:
    """Time-axis padding that is SP-transparent: ``fill`` when SP is off;
    under SP the neighbours' boundary frames, and ``fill`` at the global
    edges only, so that a VALID op after it equals the monolithic padded op."""
    if left == 0 and right == 0:
        return x
    if not active():
        return _pad(x, left, right, axis, fill)
    lh, rh = halo_blocks(x, left, right, axis=axis, fill=fill)
    return torch.cat([p for p in (lh, x, rh) if p is not None], dim=axis)


def shift_right(x: torch.Tensor, *, axis: int = 1) -> torch.Tensor:
    """``x[t - 1]``, the first frame repeated at the global left edge."""
    T = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    if active():
        lh, _ = halo_blocks(x, 1, 0, axis=axis)
        if index() > 0:
            first = lh
        elif lh.requires_grad:
            # + the zero fill: exact, and it keeps the exchange in the graph,
            # so that every rank runs its backward (a collective)
            first = lh + first
    return torch.cat([first, x.narrow(axis, 0, T - 1)], dim=axis)


def shift_left(x: torch.Tensor, *, axis: int = 1) -> torch.Tensor:
    """``x[t + 1]``, the last frame repeated at the global right edge."""
    T = x.shape[axis]
    last = x.narrow(axis, T - 1, 1)
    if active():
        _, rh = halo_blocks(x, 0, 1, axis=axis)
        if index() < size() - 1:
            last = rh
        elif rh.requires_grad:
            last = rh + last  # as in shift_right
    return torch.cat([x.narrow(axis, 1, T - 1), last], dim=axis)


def psum_if_active(x: torch.Tensor) -> torch.Tensor:
    """The sum over the sp group when SP is active (a new tensor), else x;
    differentiable (``parallel.comm.psum``: the cotangents summed back)."""
    ctx = _CTX[0]
    if ctx is None or ctx.group is None:
        return x
    STATS["psum_calls"] += 1
    if torch.is_grad_enabled() and x.requires_grad:
        return comm.psum(x, ctx.group, "sp")
    out = x.clone()
    _all_reduce(out)
    return out
