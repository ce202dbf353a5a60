"""Nearest-code search over large codebooks (``l3ac_tpu/ops/codebook.py``).

L3AC's FSQ needs no search (its encode rounds in closed form), but the
framework carries the general path: squared-L2 argmin over a codebook held
on the device (117k-250k entries), scanned in tiles of the codebook so the
(M, N) distance matrix never exists, and a sharded form over ranks.

``nearest_codes``: per tile the scores ``||c||^2 - 2 q.c`` (||q||^2 does not
move the argmin and is added at the end), padded rows at +inf, a tile's
minimum taken where it is strictly smaller than the best so far, so ties go
to the first index, as JAX's scan does. The products are ``torch.matmul`` in
fp32 with TF32 off: JAX computes them outside any Pallas kernel too.
``sharded_nearest_codes``: each rank searches its rows, then the (dist, idx)
pairs are exchanged (``parallel.sp.exchange``'s all-reduce of a zeroed
buffer) and the first rank with the least distance wins.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def nearest_codes(queries: torch.Tensor, codebook: torch.Tensor,
                  tile: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (M, d), codebook (N, d) -> (indices (M,) int32, squared
    distances (M,) fp32), on the tensors' device."""
    M, d = queries.shape
    N = codebook.shape[0]
    if codebook.shape[1] != d or queries.device != codebook.device:
        raise ValueError(f"nearest_codes: queries {tuple(queries.shape)} on {queries.device}, "
                         f"codebook {tuple(codebook.shape)} on {codebook.device}")
    q = queries.float()
    best_d = torch.full((M,), float("inf"), device=q.device)
    best_i = torch.zeros((M,), dtype=torch.int32, device=q.device)
    with _no_tf32():
        for start in range(0, N, tile):
            # JAX pads the last tile with +inf rows, which never win: not formed here
            c = codebook[start:start + tile].float()
            cn = (c * c).sum(dim=-1)
            scores = cn[None, :] - 2.0 * torch.matmul(q, c.t())
            tile_arg = torch.argmin(scores, dim=-1)  # the first of equal scores
            tile_min = scores.gather(1, tile_arg[:, None])[:, 0]
            better = tile_min < best_d
            best_d = torch.where(better, tile_min, best_d)
            best_i = torch.where(better, tile_arg.to(torch.int32) + start, best_i)
    return best_i, best_d + (q * q).sum(dim=-1)


@torch.no_grad()
def sharded_nearest_codes(queries: torch.Tensor, codebook_shard: torch.Tensor, mesh, *,
                          axis_name: str, tile: int = 4096
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Codebook rows sharded over ``mesh[axis_name]`` (this rank's shard
    given, all shards of one size), queries the same on every rank ->
    globally right (indices, dists) on every rank."""
    from ..parallel import sp

    n = mesh.shape[axis_name]
    me = mesh.coords[axis_name]
    idx, dist_ = nearest_codes(queries, codebook_shard, tile=tile)
    idx = idx + me * codebook_shard.shape[0]
    if n == 1:
        return idx, dist_
    M = queries.shape[0]
    # every rank's pair in its own row: one all-reduce of a zeroed buffer
    buf = torch.zeros((n, 2, M), dtype=torch.float64, device=queries.device)
    buf[me, 0] = dist_.double()
    buf[me, 1] = idx.double()
    with sp.sequence_parallel(mesh, axis_name):
        buf = sp.psum_if_active(buf)
    win = torch.argmin(buf[:, 0], dim=0)  # first rank on ties
    m = torch.arange(M, device=queries.device)
    return buf[win, 1, m].to(torch.int32), buf[win, 0, m].float()
