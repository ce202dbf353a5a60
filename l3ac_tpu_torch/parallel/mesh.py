"""The (dp, sp, tp) layout of ranks (``l3ac_tpu/parallel/mesh.py``).

Axes as in the JAX package:
- ``dp``: data parallel, independent audio streams;
- ``sp``: sequence parallel, the time axis sharded with halo exchange;
- ``tp``: tensor parallel, the Megatron pairs of ``parallel.tp`` (split by
  ``parallel.sharding``).

The world's ranks are laid out row-major over (dp, sp, tp): rank r sits at
the coordinates ``unravel(r, (dp, sp, tp))``, and the ranks that differ only
along one axis form that axis's process group (``dist.new_group``). Every
rank builds every group, in the same order, as ``new_group`` requires.
``make_mesh(1, 1, 1)`` needs no process group: a single process pays nothing.
"""

from __future__ import annotations

import itertools

import torch.distributed as dist

AXES = ("dp", "sp", "tp")


class Mesh:
    """This rank's place in a (dp, sp, tp) layout and one process group per
    axis (None where the axis has one rank)."""

    def __init__(self, dp: int, sp: int, tp: int, rank: int, groups: dict):
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.rank = rank
        r, self.coords = rank, {}
        for ax, n in reversed(list(self.shape.items())):
            self.coords[ax] = r % n
            r //= n
        self._groups = groups

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["sp"] * self.shape["tp"]

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank, or None when
        the axis has one rank."""
        if axis not in self.shape:
            raise KeyError(f"mesh axis {axis!r} is not one of {AXES}")
        return self._groups.get(axis)

    def backend(self, axis: str) -> str | None:
        g = self.group(axis)
        return None if g is None else dist.get_backend(g)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, sp, tp) mesh over the world of ``torch.distributed`` (which
    must hold exactly dp * sp * tp ranks), or, for (1, 1, 1), over this
    process alone with no process group."""
    n = dp * sp * tp
    if min(dp, sp, tp) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {(dp, sp, tp)}")
    if n == 1:
        return Mesh(1, 1, 1, 0, {})
    if not dist.is_initialized():
        raise RuntimeError(f"a ({dp}, {sp}, {tp}) mesh needs torch.distributed: call "
                           "parallel.distributed.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh {(dp, sp, tp)} needs {n} ranks, the world has {world}")
    shape = (dp, sp, tp)
    groups = {}
    for ai, ax in enumerate(AXES):
        if shape[ai] == 1:
            continue
        others = [range(s) for i, s in enumerate(shape) if i != ai]
        for rest in itertools.product(*others):
            ranks = []
            for k in range(shape[ai]):
                c = list(rest)
                c.insert(ai, k)
                ranks.append((c[0] * sp + c[1]) * tp + c[2])
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[ax] = g
    return Mesh(dp, sp, tp, rank, groups)
