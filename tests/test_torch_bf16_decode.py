"""bf16 decode and bf16 int8 in the port, on the CPU: the bf16 plain versions
of the four decode kernels (``up_fused``, ``up_fused_ct``, the legacy tail,
``int8_matmul``) against the JAX package's Pallas kernels in interpret mode in
bf16 and against their own fp32 plain versions; ``EnhanceBlock`` and
``Int8Linear`` in bf16 against JAX's jnp functions; the whole bf16 decode of
``debug`` indices against JAX's bf16 and fp32 decodes; the bf16 int8 encode's
indices against JAX's bf16 int8; the bf16 quantized tree through
``weights.from_jax_params`` / ``to_jax_params``.

Same seeded numpy inputs on both sides, the JAX parameters cast to bf16 and
loaded into a port module cast to bf16, so both hold the same bf16 values.

Tolerances: relative L2 <= ``BF16_TOL`` = 2^-6 (two bf16 ulps) per kernel
and module; ``int8_matmul`` within one bf16 ulp elementwise of the Pallas
kernel, whose rounding it follows (``bf16(fp32(q) s)``, one rounding of the
fp32 sum). The decode acceptance (the port's seed-0 weights in both, the JAX fp32
indices of ``tests/test_bf16.py``'s four draws): relative L2 of the port's
bf16 audio to JAX's fp32 audio <= 0.25 (JAX's own bound,
``tests/test_bf16.py:129,143``) and to JAX's bf16 audio <= 1.5x JAX's own
bf16-vs-fp32 error; the bf16 int8 indices agree with JAX's bf16 int8 ones
at a mean of at least 0.93.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu.models import layers as jl
from l3ac_tpu.models import tconv as jt
from l3ac_tpu.ops import quantized as jq
from l3ac_tpu.ops.pallas import int8_matmul as pk_q
from l3ac_tpu.ops.pallas import legacy_tail as pk_tail
from l3ac_tpu.ops.pallas import upsample as pk_up
from l3ac_tpu.utils import init as jinit
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.tconv import EnhanceBlock
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.kernels import int8_matmul as im
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import up_fused as uf
from l3ac_tpu_torch.ops.quantized import Int8Linear, quantize_params, quantize_weight

BF16_TOL = 2.0 ** -6
DRAW_SEEDS = (1000, 1001, 1002, 1003)   # tests/test_bf16.py
DECODE_TOL = 0.25                       # tests/test_bf16.py:129,143
AUDIO_RATIO = 1.5                       # test_torch_bf16.py's LATENT_RATIO rule
AGREEMENT_FLOOR = 0.93                  # tests/test_bf16.py: AGREEMENT_FLOOR["debug"]


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _np(rng, shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


# -- up paths ----------------------------------------------------------------

def _up_case(rng, Ci, Co):
    """bf16 weights as the Pallas kernel takes them ((1, Ci, Co)) and as the
    port does (UpWeights, (Co, Ci))."""
    w, b = _np(rng, (Ci, Co), Ci ** -0.5), _np(rng, (Co,), 0.3)
    nw, nb = _np(rng, (Co,), 0.2, 1.0), _np(rng, (Co,), 0.2)
    jw = (_jbf(w[None]), _jbf(b), _jbf(nw), _jbf(nb))
    return jw, uf.UpWeights(_tbf(w.T), _tbf(b), _tbf(nw), _tbf(nb))


@pytest.mark.parametrize("layout,phase_split", [("tc", False), ("ct", False), ("ct", True)])
def test_up_fused_plain_bf16_matches_pallas(layout, phase_split):
    rng = np.random.default_rng(31)
    B, Ci, Co, T, s = 2, 48, 40, 300, 3 if not phase_split else 2
    jw, w = _up_case(rng, Ci, Co)
    if layout == "tc":
        x = _np(rng, (B, T, Ci))
        want = pk_up.up_fused(_jbf(x), *jw, scale=s, interpret=True)
        got = uf.up_fused(_tbf(x), w, scale=s)
    else:
        x = _np(rng, (B, Ci, T))
        want = pk_up.up_fused_ct(_jbf(x), *jw, scale=s, interpret=True, phase_split=phase_split)
        got = uf.up_fused_ct(_tbf(x), w, scale=s, phase_split=phase_split)
    if phase_split:
        assert len(got) == len(want) == s
        want, got = jnp.stack(want), torch.stack(got)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


@pytest.mark.parametrize("layout", ["tc", "ct"])
def test_up_fused_plain_bf16_matches_fp32_plain(layout):
    rng = np.random.default_rng(32)
    _, w = _up_case(rng, 96, 48)
    cd = 2 if layout == "tc" else 1
    x = _tbf(_np(rng, (2, 200, 96) if layout == "tc" else (2, 96, 200)))
    got = uf.up_fused_plain_bf16(x, w, scale=3, channel_dim=cd)
    want = uf.up_fused_plain(x.float(), uf.UpWeights(*(t.float() for t in w)), scale=3,
                             channel_dim=cd)
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


# -- the legacy tail ---------------------------------------------------------

def _tail_case(C, scale):
    """JAX legacy-tail params at ``scale`` x init (the model's own 0.02 std),
    alphas and biases off their init values, in bf16; and the port's
    TailWeights of the same values."""
    rng = np.random.default_rng(C)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    units = []
    for k in keys[:3]:
        u = jax.tree.map(lambda a: a * scale, jl.init_legacy_unit(k, C))
        u["alpha1"] = jnp.asarray(1 + np.abs(_np(rng, (C,), 0.3)))
        u["alpha2"] = jnp.asarray(1 + np.abs(_np(rng, (C,), 0.3)))
        u["conv1"]["b"] = jnp.asarray(_np(rng, (C,), 0.1))
        u["conv2"]["b"] = jnp.asarray(_np(rng, (C,), 0.1))
        units.append(_jax_bf16(u))
    alpha = _jbf(1 + np.abs(_np(rng, (C,), 0.3)))
    out_conv = _jax_bf16(jax.tree.map(lambda a: a * scale, jinit.conv_params(keys[3], 7, C, 1)))
    t = lambda a: torch.tensor(_f(a)).bfloat16()
    w = lt.TailWeights(
        torch.stack([t(u["alpha1"]) for u in units]),
        torch.stack([t(_f(u["conv1"]["w"]).transpose(2, 1, 0)) for u in units]),
        torch.stack([t(u["conv1"]["b"]) for u in units]),
        torch.stack([t(u["alpha2"]) for u in units]),
        torch.stack([t(_f(u["conv2"]["w"])[0].T) for u in units]),
        torch.stack([t(u["conv2"]["b"]) for u in units]),
        t(alpha), t(_f(out_conv["w"]).transpose(2, 1, 0)), t(out_conv["b"]))
    return (units, alpha, out_conv), w


@pytest.mark.parametrize("poly", [True, False])
def test_legacy_tail_plain_bf16_matches_pallas(poly, monkeypatch):
    """The Pallas tail in interpret mode on bf16 input, its tile cut to 512 so
    that T = 1502 spans several tiles; weights at 2.5x init (pre-tanh values
    O(1))."""
    C, T = 24, 1502
    jp, w = _tail_case(C, 2.5)
    x = _np(np.random.default_rng(33), (1, C, T))
    monkeypatch.setattr(pk_tail, "TILE", 512)
    if poly:
        want = pk_tail.legacy_tail_poly_ct(_jbf(x[..., 0::2]), _jbf(x[..., 1::2]), *jp,
                                           interpret=True)[..., 0]
        got = lt.legacy_tail_poly_ct(_tbf(x[..., 0::2]), _tbf(x[..., 1::2]), w)
    else:
        want = pk_tail.legacy_tail_ct(_jbf(x), *jp, interpret=True)[..., 0]
        got = lt.legacy_tail_ct(_tbf(x), w)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == want.shape == (1, T)
    assert 0.1 < float(np.abs(_f(want)).mean())
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


def test_legacy_tail_plain_bf16_matches_fp32_plain():
    _, w = _tail_case(24, 2.5)
    x = _tbf(_np(np.random.default_rng(34), (2, 24, 900)))
    got = lt.legacy_tail_plain_bf16(x, w)
    want = lt.legacy_tail_plain(x.float(), lt.TailWeights(*(t.float() for t in w)))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


# -- int8_matmul and Int8Linear ------------------------------------------------

def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("K,N,bias", [(96, 80, True), (341, 128, False)])
def test_int8_matmul_plain_bf16_matches_pallas(K, N, bias):
    """Both round as ``bf16(fp32(q) s)`` and once at the output, so they
    differ only by the order of the fp32 sums: one bf16 ulp at most."""
    rng = np.random.default_rng(K + N)
    M = 300
    w_q, scale = quantize_weight(torch.from_numpy(_np(rng, (N, K), K ** -0.5)))
    x = _np(rng, (M, K))
    b = _np(rng, (N,), 0.1) if bias else None
    want = pk_q.int8_matmul(_jbf(x), jnp.asarray(w_q.numpy().T), jnp.asarray(scale.numpy()[None]),
                            None if b is None else _jbf(b), interpret=True)
    got = im.int8_matmul(_tbf(x), w_q, scale, None if b is None else _tbf(b))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    g, wv = _f(got), _f(want)
    assert (np.abs(g - wv) <= _bf16_ulp(wv)).all()


def test_int8_matmul_plain_bf16_matches_fp32_plain():
    rng = np.random.default_rng(35)
    w_q, scale = quantize_weight(torch.from_numpy(_np(rng, (128, 192), 192 ** -0.5)))
    x, b = _tbf(_np(rng, (70, 192))), _tbf(_np(rng, (128,), 0.1))
    got = im.int8_matmul_plain_bf16(x, w_q, scale, b)
    want = im.int8_matmul_plain(x.float(), w_q, scale, b.float())
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


def test_int8_linear_bf16_matches_jnp():
    """A bf16 layer quantized by the port, against JAX's jnp ``int8_linear``
    on the same q, scale and bf16 bias (which dequantizes as ``bf16(q)
    bf16(s)``, the port as ``bf16(fp32(q) s)``)."""
    rng = np.random.default_rng(36)
    lin = nn.Linear(64, 256).requires_grad_(False)
    lin.weight.copy_(torch.from_numpy(_np(rng, (256, 64), 0.125)))
    lin.bias.copy_(torch.from_numpy(_np(rng, (256,), 0.1)))
    q = Int8Linear.from_linear(lin.to(torch.bfloat16))
    assert q.bias.dtype == torch.bfloat16 and q.w_scale.dtype == torch.float32
    x = _np(rng, (3, 50, 64))
    want = jq.int8_linear(_jbf(x), jnp.asarray(q.w_q.numpy().T),
                          jnp.asarray(q.w_scale.numpy()[None]), _jbf(_f(q.bias)))
    got = q(_tbf(x))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


# -- EnhanceBlock --------------------------------------------------------------

@pytest.mark.parametrize("layout", ["tc", "ct"])
def test_enhance_block_bf16_matches_jnp(layout):
    rng = np.random.default_rng(37)
    C = 24
    jp = _jax_bf16(jt.init_enhance_block(jax.random.PRNGKey(5), C))
    m = EnhanceBlock(C)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in weights.convert_subtree(jp).items()})
    m = m.to(torch.bfloat16)
    if layout == "tc":
        x = _np(rng, (2, 400, C))
        want = jt.enhance_block_apply(jp, _jbf(x))
    else:
        x = _np(rng, (2, C, 400))
        want = jt.enhance_block_apply_t(jp, _jbf(x))
    with torch.no_grad():
        got = m(_tbf(x), channels_last=layout == "tc")
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


# -- the whole decode, and bf16 int8 ----------------------------------------------

@pytest.fixture(scope="module")
def debug_bf16():
    """The debug params in fp32 and bf16 (the port's seed-0 weights carried to
    JAX by ``weights.to_jax_params``, which costs no JAX init), the port's
    bf16 model holding the bf16 ones, and the four draws' audio."""
    mc = jax_config("debug").network_config
    tree = weights.to_jax_params(get_model("debug", device="cpu").codec.state_dict(), mc)
    p32 = jax.tree.map(jnp.asarray, tree)
    pbf = _jax_bf16(p32)
    model = get_model("debug", device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(weights.from_jax_params(pbf, mc))
    audio = [_np(np.random.default_rng(s), (2, mc.hop_length * 60), 0.3) for s in DRAW_SEEDS]
    return mc, p32, pbf, model, audio


def test_decode_bf16_against_jax_bf16_and_fp32(debug_bf16):
    mc, p32, pbf, model, audio = debug_bf16
    enc = jax.jit(lambda p, a: jcodec.encode(p, a, mc))
    dec = jax.jit(lambda p, i: jcodec.decode_indices(p, i, mc))
    vs32, vsbf, jax_own = [], [], []
    for a in audio:
        _, idx = enc(p32, jnp.asarray(a))
        y32, ybf = _f(dec(p32, idx)), _f(dec(pbf, idx))
        got = model.decode_audio(indices=np.array(idx))
        assert got.dtype == torch.bfloat16 and got.shape == y32.shape
        vs32.append(_rel_l2(_f(got), y32))
        vsbf.append(_rel_l2(_f(got), ybf))
        jax_own.append(_rel_l2(ybf, y32))
    assert np.mean(vs32) <= DECODE_TOL, vs32
    assert np.mean(vsbf) <= AUDIO_RATIO * np.mean(jax_own), (vsbf, jax_own)


def test_int8_encode_bf16_indices_agree_with_jax(debug_bf16):
    """JAX's bf16 params quantized by JAX (w_q int8, w_scale fp32, b bf16),
    loaded into the port's bf16 model after ``quantize_params``; the bf16
    int8 encodes' indices agree."""
    mc, _, pbf, _, audio = debug_bf16
    pq = jq.quantize_params(pbf)
    model = get_model("debug", device="cpu", dtype=torch.bfloat16)
    quantize_params(model.codec)
    model.load_state_dict(weights.from_jax_params(pq, mc))
    enc = jax.jit(lambda p, a: jcodec.encode(p, a, mc))
    agree = []
    for a in audio:
        _, want = enc(pq, _jbf(a))
        _, got = model.encode_audio(a)
        agree.append(float(np.mean(got.numpy() == np.asarray(want))))
    assert np.mean(agree) >= AGREEMENT_FLOOR, agree
    # and the quantized bf16 tree comes back: int8 q, fp32 scale, bf16 values
    back = weights.to_jax_params(model.codec.state_dict(), mc)
    for path, leaf in jax.tree_util.tree_leaves_with_path(pq):
        node = back
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(np.asarray(node).astype(leaf.dtype), np.asarray(leaf))


def test_bf16_tree_round_trips_through_the_port(debug_bf16):
    """``to_jax_params`` gives back the bf16 tree ``from_jax_params`` loaded:
    fp32 arrays of the same bf16 values (numpy has no bf16)."""
    mc, _, pbf, model, _ = debug_bf16
    back = weights.to_jax_params(model.codec.state_dict(), mc)
    for path, leaf in jax.tree_util.tree_leaves_with_path(pbf):
        node = back
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(np.asarray(node).astype(leaf.dtype), np.asarray(leaf))


def test_up_and_tail_buffers_rebuilt_after_a_move_to_bf16():
    """The decoder's prepared buffers are keyed on dtype: after ``.to(bf16)``
    the up path and the tail build new ones, the tensor-core up buffer in
    bf16, the streaming one fp32 holding bf16 values, the tail's the bf16
    kernel's own buffer (``pack_bf16``: bf16 fragments, then fp32 vectors)."""
    m = get_model("debug", device="cpu", seed=3)
    dec = m.codec.decoder
    st = dec.stages[-1]
    u32, t32 = st.up_prepared(), dec.tail_prepared()
    assert st.up_prepared() is u32 and dec.tail_prepared() is t32
    m.codec.to(torch.bfloat16)
    ubf, tbf = st.up_prepared(), dec.tail_prepared()
    assert ubf is not u32 and tbf is not t32 and dec.tail_prepared() is tbf
    w = st.up_weights()
    assert ubf.buffer("stream", w).dtype == torch.float32
    assert uf.prepare_up(w, "tc").dtype == torch.bfloat16
    assert tbf.weights.w1.dtype == torch.bfloat16 and tbf.packed.dtype == torch.uint8
    C = dec.mc.decoder_dims[-1]
    assert tbf.packed.shape == (lt.packed_bytes_bf16(C),)
    assert torch.equal(tbf.packed, lt.pack_bf16(tbf.weights))
    # the first lane's first fragment: W1 (n = 0, k = 0, 1) of unit 0, tap 0
    first = tbf.packed[:4].view(torch.bfloat16)
    assert torch.equal(first, tbf.weights.w1[0, 0, :2, 0])
