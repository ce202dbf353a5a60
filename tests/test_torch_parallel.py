"""Sequence parallelism in the port, on the CPU, against the JAX package.

One group of 4 gloo ranks per file (``tests/_torch_sp_worker.py``, spawned
once for the module) runs every rank-side case: the halo primitives of
``parallel.sp`` / ``parallel.halo``, ``encode_sp`` / ``decode_sp`` /
``decode_indices_sp`` of ``debug`` at sp = 4, sp = 2 (the (1, 2, 2) mesh) and
(dp, sp) = (2, 2), and the rate-1 transformer geometry of
``tests/test_parallel.py:190-214``. Here they are held against JAX: the
primitives against ``l3ac_tpu.parallel`` under ``shard_map`` on the
8-device CPU mesh; the codec against the port's monolithic run and JAX's
monolithic ``encode`` / ``decode`` on the same weights (indices equal,
features within rtol 1e-5 / atol 1e-6, audio within rtol 1e-4 / atol 1e-5:
``tests/test_parallel.py:133-156``'s tolerances). The kernel wrappers' halo
operands (``lh`` / ``rh`` / ``edges``, staged ``[lh | x | rh]``) and the
attention's previous-window operands run here in one process against JAX's
Pallas kernels in interpret mode with the same halos, at init-scale weights.
"""

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
from jax import shard_map
from jax.sharding import PartitionSpec as P

from _torch_threads import one_thread  # noqa: F401
import _torch_sp_worker as worker
from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu.ops.pallas import conv_unit as pk_cu
from l3ac_tpu.ops.pallas import first_block as pk_fb
from l3ac_tpu.ops.pallas import legacy_tail as pk_lt
from l3ac_tpu.ops.pallas import local_attention as pk_la
from l3ac_tpu.ops.pallas import upsample as pk_up
from l3ac_tpu.parallel import halo as jhalo
from l3ac_tpu.parallel import sp as jsp
from l3ac_tpu.parallel.mesh import make_mesh as jax_mesh
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.attention import local_attention as attention_plain
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import up_fused as uf

pytestmark = pytest.mark.usefixtures("one_thread")

WORLD = 4
FEAT_TOL = {"rtol": 1e-5, "atol": 1e-6}
AUDIO_TOL = {"rtol": 1e-4, "atol": 1e-5}
KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module")
def ranks():
    """The 4 ranks' results, one list entry per rank."""
    out = Path(tempfile.mkdtemp(prefix="torch_sp_"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(worker.__file__)), str(r), str(WORLD),
                               str(port), str(out), "primitives,codec,plain"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def debug():
    """(port model, JAX params, JAX config) of debug at seed 0."""
    m = get_model("debug", device="cpu", seed=0)
    p = jax.tree.map(jnp.asarray, weights.to_jax_params(m.codec.state_dict(), m.codec.mc))
    return m, p, jax_config("debug").network_config


def _cat(blocks, dim=1):
    return torch.cat(list(blocks), dim=dim).numpy()


def _jax_shards(fn, x, n_out=1):
    """fn under JAX's sequence_parallel on sp = 4 of the 8-device mesh, each
    shard's outputs concatenated along time."""
    mesh = jax_mesh(dp=1, sp=WORLD, tp=1)

    def body(xs):
        with jsp.sequence_parallel("sp"):
            return fn(xs)

    spec = P(None, "sp", None)
    outs = shard_map(body, mesh=mesh, in_specs=spec,
                     out_specs=spec if n_out == 1 else (spec,) * n_out, check_vma=False)(x)
    return outs


def test_halo_primitives_match_jax(ranks):
    x = worker.prim_input()
    prim = [r["primitives"] for r in ranks]
    lh, rh = _jax_shards(lambda xs: jsp.halo_blocks(xs, 3, 2, axis=1, fill=-1.5), x, 2)
    np.testing.assert_array_equal(_cat(p["halo_blocks"][0] for p in prim), np.asarray(lh))
    np.testing.assert_array_equal(_cat(p["halo_blocks"][1] for p in prim), np.asarray(rh))
    for name, fn in (("pad_time", lambda xs: jsp.pad_time(xs, 3, 3, axis=1, fill=0.5)),
                     ("shift_right", lambda xs: jsp.shift_right(xs, axis=1)),
                     ("shift_left", lambda xs: jsp.shift_left(xs, axis=1)),
                     ("halo_exchange", lambda xs: jhalo.halo_exchange(xs, left=2, right=1,
                                                                      axis_name="sp"))):
        np.testing.assert_array_equal(_cat(p[name] for p in prim), np.asarray(_jax_shards(fn, x)),
                                      err_msg=name)
    psum = np.asarray(_jax_shards(lambda xs: jsp.psum_if_active(
        jnp.sum(xs * xs, axis=1, keepdims=True)), x))
    for r, p in enumerate(prim):
        np.testing.assert_allclose(p["psum"].numpy(), psum[:, r], rtol=1e-6)
        assert p["edge_flags"] == (int(r == 0), int(r == WORLD - 1))
    w = worker.conv_weight()

    def causal(h):
        from l3ac_tpu.ops import conv1d
        return conv1d(jnp.pad(h, ((0, 0), (8, 0), (0, 0))), jnp.asarray(w.transpose(2, 1, 0)))

    mesh = jax_mesh(dp=1, sp=WORLD, tp=1)
    want = shard_map(lambda xs: jhalo.sp_apply(causal, xs, halo_in=8), mesh=mesh,
                     in_specs=P(None, "sp", None), out_specs=P(None, "sp", None))(x)
    np.testing.assert_allclose(_cat(p["sp_apply"] for p in prim), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(want), np.asarray(causal(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)


def test_halo_wider_than_the_shard_raises_jax_error(ranks):
    mesh = jax_mesh(dp=1, sp=WORLD, tp=1)
    x = worker.prim_input()
    with pytest.raises(ValueError) as e:
        shard_map(lambda xs: _in_sp(lambda: jsp.halo_blocks(xs, 9, 0, axis=1)), mesh=mesh,
                  in_specs=P(None, "sp", None), out_specs=P(None, "sp", None))(x)
    assert ranks[0]["primitives"]["too_wide"] == str(e.value)


def _in_sp(fn):
    with jsp.sequence_parallel("sp"):
        return fn()[0]


@pytest.fixture(scope="module")
def debug_reference(debug):
    """The port's and JAX's monolithic encode / decode of the workers' audio."""
    m, p, jmc = debug
    audio = worker.codec_audio(m.codec.mc)
    with torch.inference_mode():
        q, idx = m.codec.encode(torch.from_numpy(audio))
        port = (q.numpy(), idx.numpy(), m.codec.decode(q).numpy(),
                m.codec.decode(q, tail_high_precision=True).numpy())
    jq, jidx = jax.jit(lambda p, a: jcodec.encode(p, a, jmc))(p, audio)
    jy = jax.jit(lambda p, q: jcodec.decode(p, q, jmc))(p, jq)
    return port, (np.asarray(jq), np.asarray(jidx), np.asarray(jy))


def _gather(ranks, key, shape):
    """The blocks of the ranks of one sp group (tp 0), in sp then dp order,
    assembled into the whole (B, T, ...) arrays."""
    dp, sp_n, tp = shape
    res = {}
    for name in ("q", "idx", "y", "y_idx", "y64"):
        rows = []
        for d in range(dp):
            blocks = [None] * sp_n
            for r in ranks:
                got = r[key][shape] if isinstance(r[key], dict) and shape in r[key] else r[key]
                c = got["coords"]
                if c["dp"] == d and c["tp"] == 0:
                    blocks[c["sp"]] = got[name]
            rows.append(torch.cat(blocks, dim=1))
        res[name] = torch.cat(rows, dim=0).numpy()
    return res


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2), (2, 2, 1)])
def test_codec_sp_matches_monolithic_and_jax(ranks, debug_reference, shape):
    (q, idx, y, y64), (jq, jidx, jy) = debug_reference
    got = _gather(ranks, "codec", shape)
    np.testing.assert_allclose(got["y64"], y64, **AUDIO_TOL)   # the fp64 tail under SP
    np.testing.assert_array_equal(got["idx"], idx)
    np.testing.assert_array_equal(got["idx"], jidx)
    for want in (q, jq):
        np.testing.assert_allclose(got["q"], want, **FEAT_TOL)
    for want in (y, jy):
        np.testing.assert_allclose(got["y"], want, **AUDIO_TOL)
        np.testing.assert_allclose(got["y_idx"], want, **AUDIO_TOL)
    # tp ranks of one sp group compute the same blocks
    if shape[2] > 1:
        for r in ranks:
            twin = [o for o in ranks if o["codec"][shape]["coords"]["sp"] ==
                    r["codec"][shape]["coords"]["sp"]]
            assert all(torch.equal(t["codec"][shape]["idx"], r["codec"][shape]["idx"])
                       for t in twin)


def test_codec_sp_raises_jax_length_error(ranks, debug):
    m, p, jmc = debug
    T = jcodec.sp_time_quantum(jmc) * WORLD - m.codec.mc.hop_length * WORLD
    with pytest.raises(ValueError) as e:
        jcodec._check_sp_len(T, jmc, WORLD, "audio", jcodec.sp_time_quantum(jmc))
    assert ranks[0]["codec"][(1, 4, 1)]["errors"]["length"] == str(e.value)


def test_plain_transformer_geometry_sp(ranks):
    from l3ac_tpu.config import ModelConfig as JMC, VQConfig as JVQ
    c = worker.plain_codec()
    jmc = JMC(**{f: getattr(worker.PLAIN_MC, f) for f in (
        "feature_dim", "compress_rates", "encoder_dims", "encoder_depths", "decode_rates",
        "decoder_dims", "decoder_depths", "decoder_last_layer", "en_coder_depth",
        "en_coder_window_size", "en_coder_dynamic_pos", "en_coder_compress_rate")},
        vq=JVQ(levels=worker.PLAIN_MC.vq.levels))
    p = jax.tree.map(jnp.asarray, weights.to_jax_params(c.state_dict(), worker.PLAIN_MC))
    audio = worker.codec_audio(worker.PLAIN_MC)
    jq, jidx = jax.jit(lambda p, a: jcodec.encode(p, a, jmc))(p, audio)
    jy = jax.jit(lambda p, q: jcodec.decode(p, q, jmc))(p, jq)
    with torch.inference_mode():
        q, idx = c.encode(torch.from_numpy(audio))
        y = c.decode(q)
    got = _gather(ranks, "plain", (1, 4, 1))
    np.testing.assert_array_equal(got["idx"], idx.numpy())
    np.testing.assert_array_equal(got["idx"], np.asarray(jidx))
    np.testing.assert_allclose(got["q"], q.numpy(), **FEAT_TOL)
    for want in (y.numpy(), np.asarray(jy)):
        np.testing.assert_allclose(got["y"], want, **AUDIO_TOL)


# ---- the kernel wrappers' halo operands against JAX's Pallas kernels ----

def _halos(rng, B, C, w, layout):
    """Seeded neighbour blocks of width w in (B, C, w) or (B, w, C)."""
    shape = (B, C, w) if layout == "ct" else (B, w, C)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("layout,dilation,sides", [
    ("ct", 1, "both"), ("ct", 3, "left"), ("cl", 1, "both"), ("cl", 3, "right")])
def test_conv_unit_halos_match_jax_pallas(debug, layout, dilation, sides):
    m, p, _ = debug
    rng = np.random.default_rng(dilation)
    if layout == "ct":
        unit, jp = m.codec.encoder.stages[0].units[0], p["encoder"]["stages"][0]["units"][0]
    else:
        unit, jp = m.codec.encoder.last_units[0], p["encoder"]["last_units"][0]
    C, T, B = unit.dw.in_channels, 40, 2
    x = rng.standard_normal((B, C, T) if layout == "ct" else (B, T, C)).astype(np.float32)
    lh, rh = _halos(rng, B, C, 3 * dilation, layout)
    lh, rh = (lh if sides != "right" else None), (rh if sides != "left" else None)
    jfn = pk_cu.conv_unit_ct if layout == "ct" else pk_cu.conv_unit
    want = jfn(jnp.asarray(x), jp, dilation=dilation, lh=None if lh is None else jnp.asarray(lh),
               rh=None if rh is None else jnp.asarray(rh), interpret=True)
    fn = cu.conv_unit_ct if layout == "ct" else cu.conv_unit
    with torch.inference_mode():
        got = fn(_t(x), unit.kernel_weights(), dilation=dilation, lh=_t(lh), rh=_t(rh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("edges", [(1, 0), (0, 0), (0, 1)])
def test_first_block_halos_match_jax(debug, edges):
    """The stem on one shard of a stream, its 47-sample halos and edge flags
    against the monolithic stem (JAX's jnp ``first_block_apply`` on the whole
    stream, cropped), and against JAX's Pallas stem with its own 25-sample
    halos at JAX's tolerance for its SP stem (``tests/test_parallel.py:187``;
    it stages 25 of the 47 samples the receptive field needs, ROADMAP C)."""
    from l3ac_tpu.models.tconv import first_block_apply
    m, p, _ = debug
    rng = np.random.default_rng(sum(edges))
    B, L = 2, 200
    whole = (rng.standard_normal((B, 3 * L)) * 0.3).astype(np.float32)
    s = 0 if edges[0] else 2 if edges[1] else 1
    x = whole[:, s * L:(s + 1) * L]
    mono = np.asarray(first_block_apply(p["encoder"]["first"], jnp.asarray(whole)[..., None]))
    mono = mono.transpose(0, 2, 1)[..., s * L:(s + 1) * L]

    def halos(w):
        lh = whole[:, s * L - w:s * L] if s > 0 else np.zeros((B, w), np.float32)
        rh = whole[:, (s + 1) * L:(s + 1) * L + w] if s < 2 else np.zeros((B, w), np.float32)
        return lh, rh

    lh, rh = halos(fb.HALO)
    with torch.inference_mode():
        got = m.codec.encoder.first(_t(x), lh=_t(lh), rh=_t(rh), edges=edges).numpy()
    np.testing.assert_allclose(got, mono, rtol=1e-5, atol=1e-5)
    jl, jr = halos(pk_fb.HALO)
    jax_sp = pk_fb.first_block_ct(jnp.asarray(x)[..., None], p["encoder"]["first"],
                                  lh=jnp.asarray(jl)[..., None], rh=jnp.asarray(jr)[..., None],
                                  edges=jnp.asarray(edges, jnp.int32), interpret=True)
    np.testing.assert_allclose(got, np.asarray(jax_sp), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("layout,split,edges", [
    ("ct", False, None), ("ct", True, None), ("ct", False, (1, 0)), ("cl", False, None),
    ("cl", False, (0, 1))])
def test_up_fused_halos_match_jax_pallas(debug, layout, split, edges):
    """One-frame halos; JAX passes the shard's own edge frame on an edge
    shard (the clamp), which the port stages, or leaves unstaged with
    ``edges``."""
    m, p, _ = debug
    st, jst = m.codec.decoder.stages[1], p["decoder"]["stages"][1]
    Ci, B, T, scale = st.up_conv.in_channels, 2, 24, 2
    rng = np.random.default_rng(3 + split)
    x = rng.standard_normal((B, Ci, T) if layout == "ct" else (B, T, Ci)).astype(np.float32)
    lh, rh = _halos(rng, B, Ci, 1, layout)
    ax = 2 if layout == "ct" else 1
    if edges is not None and edges[0]:
        lh = np.take(x, [0], axis=ax)
    if edges is not None and edges[1]:
        rh = np.take(x, [x.shape[ax] - 1], axis=ax)
    jw = (jst["up_conv"]["w"], jst["up_conv"]["b"], jst["up_norm"]["w"], jst["up_norm"]["b"])
    if layout == "ct":
        want = pk_up.up_fused_ct(jnp.asarray(x), *jw, scale=scale, lh=jnp.asarray(lh),
                                 rh=jnp.asarray(rh), interpret=True, phase_split=split)
        with torch.inference_mode():
            got = uf.up_fused_ct(_t(x), st.up_weights(), scale=scale, phase_split=split,
                                 lh=_t(lh), rh=_t(rh), edges=edges)
    else:
        want = pk_up.up_fused(jnp.asarray(x), *jw, scale=scale, lh=jnp.asarray(lh),
                              rh=jnp.asarray(rh), interpret=True)
        with torch.inference_mode():
            got = uf.up_fused(_t(x), st.up_weights(), scale=scale, lh=_t(lh), rh=_t(rh),
                              edges=edges)
    if split:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("poly,edges", [(False, (1, 0)), (False, (0, 0)), (True, (0, 1)),
                                        (True, (0, 0))])
def test_legacy_tail_halos_match_jax_pallas(debug, poly, edges):
    m, p, _ = debug
    jd = p["decoder"]
    dec = m.codec.decoder
    C, B, T = dec.tail_alpha.shape[0], 2, 60
    rng = np.random.default_rng(10 + poly)
    jargs = (jd["tail_units"], jd["tail_alpha"], jd["out_conv"])
    je = jnp.asarray(edges, jnp.int32)
    w = dec.tail_weights()
    if poly:
        x0, x1 = (rng.standard_normal((B, C, T)).astype(np.float32) for _ in range(2))
        (l0, r0), (l1, r1) = _halos(rng, B, C, lt.PHALO, "ct"), _halos(rng, B, C, lt.PHALO, "ct")
        want = pk_lt.legacy_tail_poly_ct(jnp.asarray(x0), jnp.asarray(x1), *jargs,
                                         lh=(jnp.asarray(l0), jnp.asarray(l1)),
                                         rh=(jnp.asarray(r0), jnp.asarray(r1)), edges=je,
                                         interpret=True)
        with torch.inference_mode():
            got = lt.legacy_tail_poly_ct(_t(x0), _t(x1), w, lh=(_t(l0), _t(l1)),
                                         rh=(_t(r0), _t(r1)), edges=edges)
    else:
        x = rng.standard_normal((B, C, 2 * T)).astype(np.float32)
        lh, rh = _halos(rng, B, C, lt.HALO, "ct")
        want = pk_lt.legacy_tail_ct(jnp.asarray(x), *jargs, lh=jnp.asarray(lh),
                                    rh=jnp.asarray(rh), edges=je, interpret=True)
        with torch.inference_mode():
            got = lt.legacy_tail_ct(_t(x), w, lh=_t(lh), rh=_t(rh), edges=edges)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0], **KERNEL_TOL)


@pytest.mark.parametrize("left_edge", [0, 1])
def test_attention_previous_window_operands_match_jax_pallas(left_edge):
    rng = np.random.default_rng(20 + left_edge)
    B, H, n, W, D = 2, 3, 16, 3, 8
    q, k, v = (rng.standard_normal((B, H, n * W, D)).astype(np.float32) for _ in range(3))
    pk, pv = (rng.standard_normal((B, H, n, D)).astype(np.float32) for _ in range(2))
    bias = rng.standard_normal((H, n, 2 * n)).astype(np.float32)
    want = pk_la.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window_size=n,
                                 bias=jnp.asarray(bias), prev_k=jnp.asarray(pk),
                                 prev_v=jnp.asarray(pv), left_edge=jnp.asarray(left_edge),
                                 interpret=True)
    got = attention_plain(*map(_t, (q, k, v)), window_size=n, bias=_t(bias), prev_k=_t(pk),
                          prev_v=_t(pv), left_edge=left_edge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
