"""Tensor-parallel sharding rules for the codec's state dict
(``l3ac_tpu/parallel/sharding.py``).

:func:`param_specs` maps each state-dict entry to its ``tp`` split (a
:class:`Split`) or to None (replicated); :func:`shard_state_dict` cuts this
rank's slices and :func:`gather_state_dict` puts them back together. The
pairs follow JAX's ``_spec_for`` (Megatron pairs):

- ConvUnit: ``pw1`` (C -> 4C) split by output rows and ``pw2`` (4C -> C) by
  input columns; the hidden vectors go with them: pw1's bias, the snake
  ``alpha`` and GRN's ``gamma`` / ``beta`` (all (4C,)).
- Attention: ``qkv`` split by output rows, ``out`` by input columns.
- Feed-forward: ``w1`` split by output rows, ``w2`` by input columns.
- Everything else is replicated: depthwise convs, norms, the stem, the up
  paths, the tail, FSQ, the position-bias MLP and the int8 units (JAX's rule
  matches ``.../w`` leaves only, and an int8 unit has ``w_q`` / ``w_scale``).

Where this departs from JAX's leaf-wise spec (the math is the same; JAX's
GSPMD reshards whatever its split leaves mismatched, the port's explicit
pairs cannot):

- a pair is split only where both of its halves can be, and as a whole;
- the attention pair is split by whole heads, and only where
  ``heads % tp == 0`` (H = 6: tp 2, 3 or 6). JAX splits the 3 * inner qkv
  columns leaf-wise at tp = 4 too, which is not head-aligned: the port
  replicates the pair there. Each third of qkv (q, k, v) gives the rank the
  same heads;
- GEGLU: ``w1``'s output is [value | gate]
  (``l3ac_tpu/models/local_transformer.py:133``); a rank takes the same rows
  of both halves, and only where ``ff_inner % tp == 0``. At 1kbps and
  ``debug`` ``ff_inner`` is 341 and 85, so the feed-forward is replicated
  there (JAX's ``w1`` split is legal there only because 2 * ff_inner is
  even);
- the hidden vectors of a ConvUnit are split with their pair, where JAX
  replicates every 1-D leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from . import comm
from .tp import AXIS


@dataclasses.dataclass(frozen=True)
class Split:
    """A tensor-parallel split along ``axis``: the tensor is ``groups``
    equal blocks along it (qkv's q | k | v, GEGLU's value | gate), and each
    rank takes its equal part of every block."""
    axis: int
    groups: int = 1


ROWS = Split(0)
COLS = Split(1)


def _prefixes(sd: dict, suffix: str) -> list[str]:
    return [k[:-len(suffix)] for k in sd if k.endswith(suffix)]


def param_specs(state_dict: dict, mc, tp: int) -> dict[str, Split | None]:
    """Every entry of a ``Codec`` state dict -> its :class:`Split` at
    tensor-parallel size ``tp``, or None where it is replicated."""
    from ..models.local_transformer import HEADS
    specs: dict[str, Split | None] = dict.fromkeys(state_dict)
    if tp == 1:
        return specs
    for p in _prefixes(state_dict, ".pw1.weight"):
        if p + ".pw2.weight" not in state_dict or state_dict[p + ".pw1.weight"].shape[0] % tp:
            continue
        for leaf in (".pw1.weight", ".pw1.bias", ".alpha", ".grn.gamma", ".grn.beta"):
            if p + leaf in state_dict:
                specs[p + leaf] = ROWS
        specs[p + ".pw2.weight"] = COLS
    if HEADS % tp == 0:
        for p in _prefixes(state_dict, ".attn.qkv.weight"):
            if p + ".attn.out.weight" in state_dict:
                specs[p + ".attn.qkv.weight"] = Split(0, 3)
                specs[p + ".attn.out.weight"] = COLS
    for p in _prefixes(state_dict, ".ff.w1.weight"):
        if p + ".ff.w2.weight" in state_dict and state_dict[p + ".ff.w2.weight"].shape[1] % tp == 0:
            specs[p + ".ff.w1.weight"] = Split(0, 2)
            specs[p + ".ff.w2.weight"] = COLS
    return specs


def split_modules(codec, specs: dict[str, Split | None]) -> list:
    """The modules of ``codec`` that hold a split pair (ConvUnit, Attention,
    FeedForward), from the specs' names."""
    names = set()
    for k, s in specs.items():
        for tail, keep in ((".pw2.weight", ""), (".attn.out.weight", ".attn"),
                           (".ff.w2.weight", ".ff")):
            if s is not None and k.endswith(tail):
                names.add(k[:-len(tail)] + keep)
    return [codec.get_submodule(n) for n in sorted(names)]


def take_shard(t: torch.Tensor, spec: Split | None, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` under ``spec`` (t itself where None)."""
    if spec is None or size == 1:
        return t
    blocks = t.chunk(spec.groups, dim=spec.axis)
    if any(b.shape[spec.axis] % size for b in blocks):
        raise ValueError(f"a {tuple(t.shape)} tensor does not split {spec} over {size} ranks")
    return torch.cat([b.chunk(size, dim=spec.axis)[rank] for b in blocks], dim=spec.axis)


def merge_shards(shards: list[torch.Tensor], spec: Split | None) -> torch.Tensor:
    """The inverse of :func:`take_shard` over every rank's slice, in order."""
    if spec is None or len(shards) == 1:
        return shards[0]
    parts = [s.chunk(spec.groups, dim=spec.axis) for s in shards]
    return torch.cat([torch.cat([p[g] for p in parts], dim=spec.axis)
                      for g in range(spec.groups)], dim=spec.axis)


def shard_state_dict(sd: dict, mc, mesh) -> dict:
    """This rank's slices of a full ``Codec`` state dict on ``mesh``'s tp axis."""
    size, rank = mesh.shape[AXIS], mesh.coords[AXIS]
    specs = param_specs(sd, mc, size)
    return {k: take_shard(v, specs[k], rank, size) for k, v in sd.items()}


def global_shape(shape: tuple, spec: Split | None, size: int) -> tuple:
    """The full tensor's shape from one shard's."""
    if spec is None:
        return tuple(shape)
    out = list(shape)
    out[spec.axis] *= size
    return tuple(out)


def full_specs(sd: dict, mc, size: int) -> dict[str, Split | None]:
    """:func:`param_specs` of the full state dict whose tp shards (or whole
    tensors) ``sd`` holds: the full shapes come from a ``Codec`` of ``mc``
    on the meta device; an entry the dense codec lacks (an int8 unit's
    ``w_q`` / ``w_scale``) keeps its own shape, and its pair stays replicated."""
    from ..models.codec import Codec
    with torch.device("meta"):
        meta = Codec(mc).state_dict()
    return param_specs({k: meta.get(k, v) for k, v in sd.items()}, mc, size)


def gather_state_dict(sd: dict, mc, mesh) -> dict:
    """The full state dict from this rank's slices (``sd``, as
    :func:`shard_state_dict` cut them), on every rank of the tp group: one
    exact all-gather per split entry."""
    size, index, group = mesh.shape[AXIS], mesh.coords[AXIS], mesh.group(AXIS)
    if size == 1:
        return dict(sd)
    specs = full_specs(sd, mc, size)
    return {k: v if specs[k] is None else
            merge_shards(comm.gather_raw(v, group, index, size, AXIS), specs[k])
            for k, v in sd.items()}
