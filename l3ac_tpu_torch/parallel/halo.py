"""Halo-exchange helpers for a local function (``l3ac_tpu/parallel/halo.py``).

Every attention of the model is local (window <= 750 tokens) and every conv
has a finite receptive field, so sharding time across ranks needs each shard
to receive a fixed halo of its neighbours' boundary frames, and no ring pass.
These run inside ``sp.sequence_parallel``; the exchange is ``sp.exchange``.
"""

from __future__ import annotations

import torch

from . import sp


def halo_exchange(x: torch.Tensor, *, left: int, right: int, axis: int = 1) -> torch.Tensor:
    """x extended by ``left`` frames of the left neighbour and ``right`` of
    the right one; the outermost shards get zeros there."""
    lh, rh = sp.halo_blocks(x, left, right, axis=axis)
    return torch.cat([p for p in (lh, x, rh) if p is not None], dim=axis)


def crop_halo(x: torch.Tensor, *, left: int, right: int, axis: int = 1) -> torch.Tensor:
    """Drop the halo frames after a local computation."""
    return x.narrow(axis, left, x.shape[axis] - left - right)


def sp_apply(fn, x: torch.Tensor, *, halo_in: int, shrink: int = 1) -> torch.Tensor:
    """Run a local ``fn`` mapping (B, t, C) -> (B, t // shrink, C') on
    [left halo | shard] and drop the halo's outputs: the monolithic result
    wherever ``fn``'s receptive field is at most ``halo_in``."""
    if halo_in % shrink:
        raise ValueError(f"halo_in {halo_in} is not a multiple of shrink {shrink}")
    y = fn(halo_exchange(x, left=halo_in, right=0))
    return crop_halo(y, left=halo_in // shrink, right=0)
