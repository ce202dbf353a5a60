"""Tensor parallelism in the port, on the CPU, against the JAX package.

One group of 4 gloo ranks for the file (``tests/_torch_tp_worker.py``,
spawned once for the module) runs ``debug`` at seed 0 put onto its tp shards
on the meshes (1, 1, 4) (tp 4: the attention pair replicated, H = 6), (2, 1,
2) and (1, 2, 2) (tp 2 with sp 2 on one mesh), and the state-dict gathers.
Here the indices are held equal to the port's and JAX's monolithic
``encode``, and features and audio within ``tests/test_parallel.py:117-119``'s
rtol 1e-4 / atol 1e-5. In one process: the sharding rules and their round
trips, the TP operand modes of the plain ``conv_unit`` / ``conv_unit_ct`` /
``local_attention`` summed over the shards against the unsharded plain
versions and JAX's Pallas kernels in interpret mode, and the
``conv_unit_ct`` route above C = 96 (ROADMAP C3) against JAX.
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

from _torch_threads import one_thread  # noqa: F401
import _torch_tp_worker as worker
from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu.ops.pallas import conv_unit as pk_cu
from l3ac_tpu.ops.pallas import local_attention as pk_la
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.codec import Codec
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops import kernels as K
from l3ac_tpu_torch.ops.attention import expand_position_table
from l3ac_tpu_torch.ops.attention import local_attention as attention_plain
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.parallel import sharding, tp

pytestmark = pytest.mark.usefixtures("one_thread")

WORLD = 4
TOL = {"rtol": 1e-4, "atol": 1e-5}        # tests/test_parallel.py:117-119
KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-5}
C3_DIMS = {"decoder_dims": (256, 96, 128, 24)}


class _Mesh:
    """The (dp, sp, tp) coordinates of one rank, for the functions that
    read a mesh's shape and coordinates only."""

    def __init__(self, tp_size: int, rank: int):
        self.shape = {"dp": 1, "sp": 1, "tp": tp_size}
        self.coords = {"dp": 0, "sp": 0, "tp": rank}


@pytest.fixture(scope="module")
def ranks():
    """The 4 ranks' results, one list entry per rank."""
    out = Path(tempfile.mkdtemp(prefix="torch_tp_"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(worker.__file__)), str(r), str(WORLD),
                               str(port), str(out), "codec,gather"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def debug():
    """(port model, JAX params, JAX config) of debug at seed 0."""
    m = get_model("debug", device="cpu", seed=0)
    p = jax.tree.map(jnp.asarray, weights.to_jax_params(m.codec.state_dict(), m.codec.mc))
    return m, p, jax_config("debug").network_config


@pytest.fixture(scope="module")
def reference(debug):
    """The port's and JAX's monolithic encode / decode of the workers' audio."""
    m, p, jmc = debug
    audio = worker.codec_audio(m.mc)
    with torch.inference_mode():
        q, idx = m.codec.encode(torch.from_numpy(audio))
        port = (q.numpy(), idx.numpy(), m.codec.decode(q).numpy())
    jq, jidx = jax.jit(lambda p, a: jcodec.encode(p, a, jmc))(p, audio)
    jy = jax.jit(lambda p, q: jcodec.decode(p, q, jmc))(p, jq)
    return port, (np.asarray(jq), np.asarray(jidx), np.asarray(jy))


def _specs(name: str, tp_size: int) -> dict:
    mc = get_config(name).network_config
    return sharding.param_specs(Codec(mc, device="meta").state_dict(), mc, tp_size)


def test_param_specs_split_the_pairs_as_a_whole():
    debug2, debug4 = _specs("debug", 2), _specs("debug", 4)
    unit = "encoder.stages.0.units.0."
    for leaf in ("pw1.weight", "pw1.bias", "alpha", "grn.gamma", "grn.beta"):
        assert debug2[unit + leaf] == sharding.ROWS
    assert debug2[unit + "pw2.weight"] == sharding.COLS
    for leaf in ("dw.weight", "dw.bias", "norm.weight", "pw2.bias"):
        assert debug2[unit + leaf] is None
    attn = "en_encoder.down_trans.layers.0.attn."
    assert debug2[attn + "qkv.weight"] == sharding.Split(0, 3)
    assert debug2[attn + "out.weight"] == sharding.COLS
    # H = 6: tp 4 is not head-aligned, so the attention pair stays whole
    assert debug4[attn + "qkv.weight"] is None and debug4[attn + "out.weight"] is None
    # ff_inner 85 (debug) and 341 (1kbps) are odd: the feed-forward stays whole
    ff = "en_encoder.down_trans.layers.0.ff."
    assert debug2[ff + "w1.weight"] is None and debug2[ff + "w2.weight"] is None
    k1 = _specs("1kbps", 2)
    assert all(v is None for k, v in k1.items() if ".ff." in k or "dyn_bias" in k)
    assert all(v is None for k, v in k1.items() if k.startswith("encoder.first")
               or ".up." in k or ".tail" in k or "quantizer" in k)
    assert sum(v is not None for v in k1.values()) > 0
    # an even ff_inner splits both GEGLU halves alike
    mc = get_config("debug", network_config={"feature_dim": 48}).network_config
    sd = Codec(mc, device="meta").state_dict()
    ff48 = sharding.param_specs(sd, mc, 2)
    assert ff48[ff + "w1.weight"] == sharding.Split(0, 2)
    assert ff48[ff + "w2.weight"] == sharding.COLS


def test_int8_units_stay_replicated():
    from l3ac_tpu_torch.ops.quantized import quantize_params
    m = get_model("debug", device="cpu")
    quantize_params(m.codec)
    specs = sharding.param_specs(m.codec.state_dict(), m.mc, 2)
    for k, v in specs.items():
        if ".w_q" in k or ".w_scale" in k:
            assert v is None
        prefix = k.rsplit(".", 2)[0]
        if prefix + ".pw1.w_q" in specs:
            assert v is None, k


@pytest.mark.parametrize("tp_size", [2, 4])
def test_shard_state_dict_round_trips(tp_size):
    m = get_model("debug", device="cpu", seed=0)
    full = m.codec.state_dict()
    shards = [sharding.shard_state_dict(full, m.mc, _Mesh(tp_size, r)) for r in range(tp_size)]
    specs = sharding.param_specs(full, m.mc, tp_size)
    for k, v in full.items():
        got = sharding.merge_shards([s[k] for s in shards], specs[k])
        assert torch.equal(got, v), k
        if specs[k] is not None:
            assert shards[0][k].shape[specs[k].axis] * tp_size == v.shape[specs[k].axis]
    # a shard's own specs come back from its shapes
    assert sharding.full_specs(shards[1], m.mc, tp_size) == specs
    # qkv: each rank the same heads of q, k and v
    key = "en_encoder.down_trans.layers.0.attn.qkv.weight"
    if specs[key] is not None:
        inner = full[key].shape[0] // 3
        q, k_, v_ = shards[1][key].chunk(3)
        assert torch.equal(q, full[key][inner // 2:inner])
        assert torch.equal(v_, full[key][2 * inner + inner // 2:])


def test_gather_state_dict_over_ranks(ranks):
    for r in ranks:
        assert r["gather"][(1, 1, 4)] == {"equal": True, "split": 36}
        assert r["gather"][(2, 1, 2)] == {"equal": True, "split": 48}


def _assemble(ranks, shape):
    """The blocks of tp rank 0 in sp then dp order, as whole arrays; every
    tp rank's block equals tp rank 0's."""
    dp, n_sp, _ = shape
    out = {}
    for name in ("q", "idx", "y", "y_idx"):
        rows = []
        for d in range(dp):
            blocks = [None] * n_sp
            for r in ranks:
                got = r["codec"][shape]
                c = got["coords"]
                if c["dp"] == d and c["tp"] == 0:
                    blocks[c["sp"]] = got[name]
            rows.append(torch.cat(blocks, dim=1))
        out[name] = torch.cat(rows, dim=0).numpy()
    for r in ranks:
        got = r["codec"][shape]
        c = got["coords"]
        twin = next(o["codec"][shape] for o in ranks if o["codec"][shape]["coords"] ==
                    {**c, "tp": 0})
        assert torch.equal(got["idx"], twin["idx"])
        np.testing.assert_allclose(got["y"].numpy(), twin["y"].numpy(), rtol=1e-6, atol=1e-7)
    return out


@pytest.mark.parametrize("shape", worker.CODEC_MESHES)
def test_tp_codec_matches_monolithic_and_jax(ranks, reference, shape):
    (q, idx, y), (jq, jidx, jy) = reference
    got = _assemble(ranks, shape)
    np.testing.assert_array_equal(got["idx"], idx)
    np.testing.assert_array_equal(got["idx"], jidx)
    for want in (q, jq):
        np.testing.assert_allclose(got["q"], want, **TOL)
    for want in (y, jy):
        np.testing.assert_allclose(got["y"], want, **TOL)
        np.testing.assert_allclose(got["y_idx"], want, **TOL)
    assert {r["codec"][shape]["shard"] for r in ranks} == \
        {(t, shape[2]) for t in range(shape[2])}


def _unit_shards(w: cu.ConvUnitWeights, n: int) -> list[cu.ConvUnitWeights]:
    rows = ("pw1_w", "pw1_b", "alpha", "grn_gamma", "grn_beta")
    return [w._replace(**{f: sharding.take_shard(getattr(w, f), sharding.ROWS, r, n)
                          for f in rows},
                       pw2_w=sharding.take_shard(w.pw2_w, sharding.COLS, r, n))
            for r in range(n)]


@pytest.mark.parametrize("layout,tp_size", [("ct", 2), ("ct", 4), ("cl", 2)])
def test_plain_unit_shares_sum_to_the_unit_and_jax_pallas(debug, layout, tp_size):
    m, p, _ = debug
    rng = np.random.default_rng(tp_size)
    if layout == "ct":
        unit, jp = m.codec.encoder.stages[1].units[0], p["encoder"]["stages"][1]["units"][0]
    else:
        unit, jp = m.codec.encoder.last_units[0], p["encoder"]["last_units"][0]
    C, T, B = unit.dw.in_channels, 40, 2
    x = torch.from_numpy(rng.standard_normal((B, C, T) if layout == "ct" else (B, T, C))
                         .astype(np.float32))
    cd = 1 if layout == "ct" else 2
    fn = cu.conv_unit_ct if layout == "ct" else cu.conv_unit
    with torch.inference_mode():
        w = unit.kernel_weights()
        shares = [fn(x, wr, partial=True) for wr in _unit_shards(w, tp_size)]
        b2 = w.pw2_b if layout == "cl" else w.pw2_b[:, None]
        got = x + sum(shares) + b2
        want = cu.conv_unit_plain(x, w, channel_dim=cd)
    assert all(s.dtype == torch.float32 for s in shares)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **KERNEL_TOL)
    jfn = pk_cu.conv_unit_ct if layout == "ct" else pk_cu.conv_unit
    jwant = jfn(jnp.asarray(x.numpy()), jp, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **KERNEL_TOL)


def test_plain_bf16_unit_shares_round_once():
    m = get_model("debug", device="cpu", seed=0, dtype=torch.bfloat16)
    unit = m.codec.encoder.stages[1].units[0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 12, 40)).astype(np.float32)).bfloat16()
    with torch.inference_mode():
        w = unit.kernel_weights()
        shares = [cu.conv_unit_ct(x, wr, partial=True) for wr in _unit_shards(w, 2)]
        got = (x.float() + sum(shares) + w.pw2_b.float()[:, None]).bfloat16()
        want = cu.conv_unit_plain_bf16(x, w, channel_dim=1)
    assert shares[0].dtype == torch.float32
    # the same fp32 sums in another order, rounded once (a hidden unit's
    # bf16 rounding may flip at a tie): within the bf16 stages' tolerance
    bound = 2.0 ** -6 * max(1.0, want.float().abs().max().item())
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0, atol=bound)


def test_prepared_shard_pads_the_hidden_axis_exactly():
    rng = np.random.default_rng(9)
    C = 12
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    w = cu.ConvUnitWeights(g(C, 1, 7), g(C), 1 + g(C) * 0.1, g(C), g(4 * C, C), g(4 * C),
                           1 + g(4 * C).abs(), g(4 * C), g(4 * C), g(C, 4 * C), g(C))
    w3 = _unit_shards(w, 4)[3]                     # 12 hidden units: padded to 16
    p = cu.prepare_weights(w3, partial=True)
    assert isinstance(p, cu.PreparedWeights) and p.w1_hi.shape == (16, C)
    assert p.w2_hi.shape == (C, 16) and torch.equal(p.alpha[12:], torch.ones(4))
    assert torch.equal(p.b1[12:], torch.zeros(4)) and not p.w2_hi[:, 12:].any()
    w2f, _ = cu.fold_grn(w3)
    np.testing.assert_allclose(p.b2.numpy(), (w3.grn_beta @ w3.pw2_w.t()).numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose((p.w2_hi + p.w2_lo)[:, :12].numpy(), w2f.t().numpy(),
                               rtol=1e-6, atol=1e-7)
    pb = cu.prepare_bf16(cu.ConvUnitWeights(*(t.bfloat16() for t in w3)), partial=True)
    assert pb.w1.shape == (16, C) and pb.narrow.shape == (cu.narrow_packed_bytes(C, 7, 16),)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_weights_keep_the_whole_unit_and_the_shard_apart(dtype):
    """One cache for both modes: the same weights prepared whole and as a
    shard (``partial``, b2' without pw2's bias) are told apart by the mode."""
    rng = np.random.default_rng(12)
    C = 8
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
    w = cu.ConvUnitWeights(g(C, 1, 7), g(C), 1 + g(C) * 0.1, g(C), g(4 * C, C), g(4 * C),
                           1 + g(4 * C).abs(), g(4 * C), g(4 * C), g(C, 4 * C), 1 + g(C).abs())
    whole = cu.prepared_weights(w)
    part = cu.prepared_weights(w, partial=True)
    assert cu.prepared_weights(w, partial=True) is part
    assert not torch.equal(whole.b2, part.b2)
    np.testing.assert_allclose((whole.b2 - part.b2).numpy(), w.pw2_b.float().numpy(),
                               rtol=1e-5, atol=1e-5)
    again = cu.prepared_weights(w)
    assert again is not part and torch.equal(again.b2, whole.b2)
    if dtype == torch.float32:
        assert whole.b1 is None and torch.equal(part.b1, w.pw1_b)


@pytest.mark.parametrize("tp_size", [2, 3])
def test_plain_attention_head_shares_match_the_whole_and_jax_pallas(tp_size):
    rng = np.random.default_rng(30 + tp_size)
    B, H, n, W, D = 2, 6, 16, 3, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, n * W, D)).astype(np.float32))
               for _ in range(3))
    table = torch.from_numpy(rng.standard_normal((2 * n, H)).astype(np.float32))
    whole = attention_plain(q, k, v, window_size=n, bias_table=table)
    before = K.TP_LAUNCHES["local_attention"]
    Hr = H // tp_size
    for r in range(tp_size):
        s = slice(r * Hr, (r + 1) * Hr)
        got = la.local_attention(q[:, s], k[:, s], v[:, s], window_size=n, bias_table=table,
                                 head_offset=r * Hr)
        np.testing.assert_allclose(got.numpy(), whole[:, s].numpy(), rtol=1e-6, atol=1e-7)
    bias = expand_position_table(table)
    want = pk_la.local_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()), window_size=n,
                                 bias=jnp.asarray(bias.numpy()), interpret=True)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert K.TP_LAUNCHES["local_attention"] == before      # the CPU runs the plain version
    with pytest.raises(ValueError, match="heads"):
        la.local_attention(q[:, :Hr], k[:, :Hr], v[:, :Hr], window_size=n, bias_table=table,
                           head_offset=H - Hr + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_head_shard_copies_the_table_only_where_it_is_read(monkeypatch, dtype):
    """The TP mode on the kernel route: the fp32 kernel takes the shard's
    columns of the (2n, H) table (a copy); the bf16 kernel the whole table
    and the first head, whose prepared rows it reads in place."""
    rng = np.random.default_rng(41)
    B, H, n, W, D = 1, 6, 16, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, n * W, D))).to(dtype)
               for _ in range(3))
    table = torch.from_numpy(rng.standard_normal((2 * n, H))).to(dtype)
    seen = {}

    def launch(q, k, v, bias, bias_table, n, ptrs, strides, table_rows=None, **kw):
        seen.update(table=bias_table, rows=table_rows)
        return torch.zeros(q.shape[0], q.shape[2], q.shape[1], q.shape[3], dtype=q.dtype)

    monkeypatch.setattr(K, "route", lambda x, name: True)
    monkeypatch.setattr(la, "_launch", launch)
    la.local_attention(q[:, 3:], k[:, 3:], v[:, 3:], window_size=n, bias_table=table,
                       head_offset=3)
    if dtype == torch.bfloat16:
        assert seen["table"] is table and seen["rows"] == (table, 3)
    else:
        assert seen["rows"] is None and torch.equal(seen["table"], table[:, 3:])


def test_tp_bf16_agreement_tells_a_tie_from_a_fault():
    """tools/tp_bf16_agreement.compare: an index that flips because z moved
    one bf16 step across its rounding boundary lies within a step of it;
    one whose z moved far lies many steps away."""
    from l3ac_tpu_torch.ops import fsq
    from l3ac_tpu_torch.tools import tp_bf16_agreement as ag
    levels = (8, 5, 5, 5)
    z = torch.tensor([[[0.3, -0.4, 0.5, 0.1], [0.0, 0.6, -0.7, 0.2]]]).bfloat16()
    idx = fsq.quantize(z, levels)[1]
    # element (0, 1, 0) = 0: pre-round 3.5 under L = 8, on a boundary
    tie = z.clone()
    tie[0, 1, 0] = -ag.bf16_step(z)[0, 1, 0]
    c = ag.compare(fsq.quantize(tie, levels)[1], tie, idx, z, levels)
    assert c["flips"] == 1 and c["flip_margin_steps"] <= 1.0 and c["z_max_steps"] <= 1.0
    fault = z.clone()
    fault[0, 0, 0] = -0.3
    c = ag.compare(fsq.quantize(fault, levels)[1], fault, idx, z, levels)
    assert c["flips"] == 1 and c["flip_margin_steps"] > 20


def test_split_module_outside_its_context_raises():
    m = get_model("debug", device="cpu", seed=0)
    tp.shard_codec(m.codec, _Mesh(2, 0))
    with pytest.raises(RuntimeError, match="tensor_parallel"):
        with torch.inference_mode():
            m.codec.encode(torch.zeros(1, 384))
    with tp.tensor_parallel(_MeshGroup(2, 1)):
        with pytest.raises(RuntimeError, match="shard 0 of 2"):
            with torch.inference_mode():
                m.codec.encode(torch.zeros(1, 384))


class _MeshGroup(_Mesh):
    def group(self, axis):
        return None


@pytest.fixture(scope="module")
def c3():
    m = get_model("debug", device="cpu", seed=2, network_config=C3_DIMS)
    p = jax.tree.map(jnp.asarray, weights.to_jax_params(m.codec.state_dict(), m.codec.mc))
    return m, p, jax_config("debug", network_config=C3_DIMS).network_config


def test_c3_wide_channels_first_unit_matches_jax(c3):
    """debug at decoder_dims (256, 96, 128, 24): a (B, C, T) unit at C = 128,
    above the narrow kernel, the port's decode against JAX's."""
    m, p, jmc = c3
    audio = (np.random.default_rng(31).standard_normal((2, 40 * m.mc.hop_length)) * 0.3
             ).astype(np.float32)
    with torch.inference_mode():
        q, idx = m.codec.encode(torch.from_numpy(audio))
        y = m.codec.decode(q)
    jq, jidx = jax.jit(lambda p, a: jcodec.encode(p, a, jmc))(p, audio)
    jy = jax.jit(lambda p, q: jcodec.decode(p, q, jmc))(p, jq)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert any(u.dw.in_channels == 128 for st in m.codec.decoder.stages for u in st.units)


def test_c3_route_sends_a_wide_channels_first_unit_to_the_channels_last_kernel(monkeypatch):
    """The shape rule: C <= 96 the narrow kernel, above it conv_unit's rule
    on the transposed x (C % 64 in fp32, C % 8 in bf16: the tensor-core
    kernel; the other widths, which raised before ROADMAP C3 closed, the
    general route)."""
    rng = np.random.default_rng(3)
    calls = []

    def narrow(x, w, p, dilation, **kw):
        calls.append(("narrow", tuple(x.shape)))
        return cu.conv_unit_plain(x, w, channel_dim=1, dilation=dilation)

    def wide(x, w, dilation, **kw):
        calls.append(("tc", tuple(x.shape)))
        return cu.conv_unit_plain(x, w, channel_dim=2, dilation=dilation)

    monkeypatch.setattr(K, "route", lambda x, name: True)
    monkeypatch.setattr(cu, "_launch_narrow", narrow)
    monkeypatch.setattr(cu, "_launch_tc", wide)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    for C in (96, 128):
        w = cu.ConvUnitWeights(g(C, 1, 7), g(C), 1 + g(C) * 0.1, g(C), g(4 * C, C) * C ** -0.5,
                               g(4 * C), 1 + g(4 * C).abs(), g(4 * C), g(4 * C),
                               g(C, 4 * C) * (2 * C) ** -0.5, g(C))
        x = g(2, C, 50)
        before = dict(cu.ROUTES)
        got = cu.conv_unit_ct(x, w)
        np.testing.assert_allclose(got.numpy(), cu.conv_unit_plain(x, w, channel_dim=1).numpy(),
                                   rtol=1e-6, atol=1e-6)
        key = "narrow" if C <= cu.NARROW_MAX_C else "channels_last"
        assert cu.ROUTES[key] == before[key] + 1
    assert calls == [("narrow", (2, 96, 50)), ("tc", (2, 50, 128))]
    assert cu.admits("conv_unit_ct", 100) is None              # fp32: C % 64 above 96
    assert cu.route_for("conv_unit_ct", 100) == "general"
    assert cu.admits("conv_unit_ct", 104, torch.bfloat16) is None
    assert cu.route_for("conv_unit_ct", 104, torch.bfloat16) == "tc"
    assert cu.admits("conv_unit_ct", 2048) is None
    assert cu.route_for("conv_unit_ct", 2048) == "general"
