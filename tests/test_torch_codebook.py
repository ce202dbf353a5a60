"""Nearest-code search in the port (``ops.codebook``), on the CPU, against
``l3ac_tpu/ops/codebook.py``: ``nearest_codes`` at N = 5000 and 117,649
(7^6) rows of d = 6 for M = 256 queries (the default tile of 4096 divides
neither), ties resolved to the first index, and ``sharded_nearest_codes``
over 4 gloo ranks (one spawned group, ``tests/_torch_sp_worker.py``)
against the unsharded search and JAX's sharded search on 4 devices."""

import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from l3ac_tpu.ops import codebook as jcb
from l3ac_tpu.parallel.mesh import make_mesh as jax_mesh
from l3ac_tpu_torch.ops import codebook

WORLD = 4


@pytest.mark.parametrize("N", [5000, 117649])
def test_nearest_codes_match_jax(N):
    rng = np.random.default_rng(N)
    cb = rng.standard_normal((N, 6)).astype(np.float32)
    q = rng.standard_normal((256, 6)).astype(np.float32)
    ji, jd = jcb.nearest_codes(jnp.asarray(q), jnp.asarray(cb))
    ti, td = codebook.nearest_codes(torch.from_numpy(q), torch.from_numpy(cb))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_ties_go_to_the_first_index():
    """Equal rows in two tiles and in one: the first wins, as in JAX."""
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((9000, 6)).astype(np.float32)
    q = rng.standard_normal((32, 6)).astype(np.float32)
    ti, _ = codebook.nearest_codes(torch.from_numpy(q), torch.from_numpy(cb))
    first = ti.numpy()
    cb[8500] = cb[first[0]]          # a copy in a later tile
    cb[first[1] + 1] = cb[first[1]]  # a copy in the same tile (or the next row)
    ti, _ = codebook.nearest_codes(torch.from_numpy(q), torch.from_numpy(cb), tile=4096)
    ji, _ = jcb.nearest_codes(jnp.asarray(q), jnp.asarray(cb))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0] == first[0] and ti[1] == first[1]


def test_sharded_nearest_codes_over_four_ranks():
    out = Path(tempfile.mkdtemp(prefix="torch_nearest_"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(worker.__file__)), str(r), str(WORLD),
                               str(port), str(out), "nearest"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-2000:] for x in logs)
    res = [torch.load(out / f"rank{r}.pt")["nearest"] for r in range(WORLD)]
    cb, q = worker.nearest_inputs()
    want_i, want_d = codebook.nearest_codes(torch.from_numpy(q), torch.from_numpy(cb))
    mesh = jax_mesh(dp=1, sp=WORLD, tp=1)
    ji, jd = jax.shard_map(
        lambda c: jcb.sharded_nearest_codes(jnp.asarray(q), c, axis_name="sp"), mesh=mesh,
        in_specs=P("sp", None), out_specs=(P(), P()), check_vma=False)(jnp.asarray(cb))
    for idx, dist in res:
        np.testing.assert_array_equal(idx.numpy(), want_i.numpy())
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_allclose(dist.numpy(), want_d.numpy(), rtol=1e-6)
        np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
