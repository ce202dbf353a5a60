"""Tensor parallelism: Megatron pairs on ``torch.distributed``
(the ``tp`` axis of ``l3ac_tpu/parallel/sharding.py``).

JAX gets its tensor parallelism from GSPMD: it annotates the weights and XLA
inserts the collectives. The port spells the pairs out. A codec put onto its
shards (:func:`shard_codec`, the rules of ``parallel.sharding``) holds, in
each split module, this rank's slice of the pair; inside
``with tensor_parallel(mesh):`` such a module runs its slice and sums the
partial outputs over the ``tp`` group:

- ConvUnit: the depthwise conv and the norm in full, then the rank's hidden
  shard (pw1's rows, the activation, GRN, pw2's columns) as the kernels' TP
  operand mode (``ops/kernels/conv_unit.py``), whose partial output has no
  residual and no pw2 bias; the partials are summed (:func:`reduce_from_tp`)
  and the bias and the residual added once, in fp32 for a bf16 unit, whose
  sum is then rounded once.
- Attention: the rank's heads of qkv, the kernel on them with their columns
  of the position table, the out-projection's partial, summed.
- The GEGLU feed-forward, where ``ff_inner % tp == 0``: the rank's rows of
  both halves of ``w1``, its columns of ``w2``, summed.

The exact GRN of the plain path takes its norm over the whole hidden axis:
its sum of squares is summed over ``tp`` too (``ops.norms.grn``).

Training: :func:`copy_to_tp` (identity forward, the cotangents summed over
``tp`` backward) brings every replicated tensor into a split computation
(the unit's input and its depthwise and norm weights, the attention's
normalized input and its position table), :func:`reduce_from_tp` (the sum
forward, identity backward) takes the partials out, so every replicated
parameter's gradient is the same on every rank of the group, and each
split parameter's is whole on its rank.

The context is plain Python state, as ``sp.sequence_parallel`` is:
``models.codec.encode_sp`` and its siblings and the sharded train step enter
it around a call. A split module run outside it raises.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

from . import comm

AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class Context:
    group: object | None  # the tp process group, None for one rank
    index: int
    size: int


_CTX: list[Context | None] = [None]


@contextmanager
def tensor_parallel(mesh):
    """Run the split modules inside this block as rank ``mesh.coords["tp"]``
    of the mesh's tp group."""
    prev = _CTX[0]
    _CTX[0] = Context(mesh.group(AXIS), mesh.coords[AXIS], mesh.shape[AXIS])
    try:
        yield
    finally:
        _CTX[0] = prev


def context(module: str, shard: tuple[int, int]) -> Context:
    """The active context, checked against a split module's (rank, size)."""
    ctx = _CTX[0]
    if ctx is None or (ctx.index, ctx.size) != tuple(shard):
        raise RuntimeError(
            f"{module} holds tensor-parallel shard {shard[0]} of {shard[1]}; run it inside "
            f"parallel.tp.tensor_parallel(mesh) of a mesh with tp = {shard[1]}"
            + ("" if ctx is None else f" (active: shard {ctx.index} of {ctx.size})"))
    return ctx


def psum_if_active(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tp group (differentiable), else x."""
    ctx = _CTX[0]
    return x if ctx is None else comm.psum(x, ctx.group, AXIS)


def copy_to_tp(x: torch.Tensor | None) -> torch.Tensor | None:
    """Megatron's ``f`` over the active tp group (x itself outside it)."""
    ctx = _CTX[0]
    return x if ctx is None or x is None else comm.copy_sum(x, ctx.group, AXIS)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g`` over the active tp group."""
    ctx = _CTX[0]
    return x if ctx is None else comm.reduce_sum(x, ctx.group, AXIS)


def shard_codec(codec, mesh):
    """Put ``codec``'s split pairs onto this rank's shards of the mesh's
    tp axis (``parallel.sharding.param_specs``), in place: each
    split parameter becomes its slice, and each split module records its
    (rank, size). A codec that holds shards already, or a mesh with tp = 1,
    is left as it is. Returns the codec."""
    from . import sharding
    size, rank = mesh.shape[AXIS], mesh.coords[AXIS]
    if size == 1 or getattr(codec, "tp_shard", None) is not None:
        return codec
    specs = sharding.param_specs(codec.state_dict(), codec.mc, size)
    for owner in sharding.split_modules(codec, specs):
        owner.tp_shard = (rank, size)
    with torch.no_grad():
        for name, p in list(codec.named_parameters()):
            spec = specs.get(name)
            if spec is None:
                continue
            mod_name, leaf = name.rsplit(".", 1)
            mod = codec.get_submodule(mod_name)
            new = torch.nn.Parameter(sharding.take_shard(p.detach(), spec, rank, size).clone(),
                                     requires_grad=p.requires_grad)
            setattr(mod, leaf, new)
    codec.tp_shard = (rank, size)
    return codec
