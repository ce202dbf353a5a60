"""Process start-up and the multi-host mesh (``l3ac_tpu/parallel/distributed.py``).

``initialize`` starts ``torch.distributed`` with the backend the caller
names: ``nccl`` for CUDA tensors across cards, ``gloo`` for the CPU and for
several ranks on one card (NCCL refuses two ranks on one device). Nothing
here reads a cluster's environment: the caller gives the address
(``tcp://host:port``), the world size and the rank.
"""

from __future__ import annotations

import logging

import torch.distributed as dist

from .mesh import Mesh, make_mesh

log = logging.getLogger("l3ac_tpu_torch")

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "gloo") -> None:
    """Start ``torch.distributed`` (a no-op when it is up already, or when
    neither an address nor a process count is given: one process)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the address, the process count and this "
                         "process's id together")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    log.info("torch.distributed up (%s): process %d/%d", backend, process_id, num_processes)


def multihost_mesh(sp: int = 1, tp: int = 1) -> Mesh:
    """dp = world / (sp * tp), with each sp / tp group on consecutive ranks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % (sp * tp):
        raise ValueError(f"{n} ranks do not split into sp = {sp} x tp = {tp}")
    return make_mesh(n // (sp * tp), sp, tp)


def barrier(name: str = "l3ac_tpu_barrier") -> None:
    """A barrier over the world (nothing for one process); ``name`` is kept
    for the JAX signature."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dist.barrier()
