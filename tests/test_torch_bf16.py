"""bf16 encode in the port, on the CPU: each module's plain bf16 path against
the JAX package's jnp path in bf16, the bf16 plain versions of the four
encode kernels against their fp32 plain versions, and the whole encode
against JAX in bf16 and in fp32.

Same seeded numpy inputs on both sides; the JAX parameters are cast to bf16
(``tests/test_bf16.py``'s ``_bf16``) and the port loads them through
``weights.convert_subtree`` / ``from_jax_params`` into a module cast to bf16,
so both hold the same bf16 values.

Tolerance: relative L2 <= ``BF16_TOL`` = 2^-6 (two bf16 ulps) per module.
The two sides round at different points (the port rounds where the JAX
Pallas kernels do; XLA's CPU path rounds after its own fusions), so they
agree statistically, never bit for bit, except FSQ: its squash and round run
in fp32, so the indices of the same latents are bit-exact across dtypes.

The encode acceptance (``debug``, JAX's ``PRNGKey(0)`` weights, averaged over
``tests/test_bf16.py``'s four draws, seeds 1000-1003): the port's bf16
indices agree with JAX's fp32 ones and with JAX's bf16 ones at a mean of at
least 0.93 (JAX's own floor, ``tests/test_bf16.py:AGREEMENT_FLOOR``), and the
relative L2 of the pre-FSQ latents, port bf16 against JAX bf16, is at most
1.5x that of JAX bf16 against JAX fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu.models import layers as jl
from l3ac_tpu.models import tconv as jt
from l3ac_tpu.ops.conv import linear_p
from l3ac_tpu.ops import activations as jact
from l3ac_tpu.ops import attention as jatt
from l3ac_tpu.ops import fsq as jfsq
from l3ac_tpu.ops import norms as jn
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.models.tconv import FirstBlock
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops import activations as act
from l3ac_tpu_torch.ops import attention as att
from l3ac_tpu_torch.ops import fsq, norms
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import local_attention as la

BF16_TOL = 2.0 ** -6      # relative L2: two bf16 ulps
DRAW_SEEDS = (1000, 1001, 1002, 1003)   # tests/test_bf16.py
AGREEMENT_FLOOR = 0.93                  # tests/test_bf16.py: AGREEMENT_FLOOR["debug"]
LATENT_RATIO = 1.5


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _np(rng, shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _f(x) -> np.ndarray:
    """fp32 numpy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


def _load_bf16(module, jp_bf16):
    """The module in bf16 holding the bf16 JAX params' values."""
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in weights.convert_subtree(jp_bf16).items()})
    return module.to(torch.bfloat16)


@pytest.mark.parametrize("name", ["channel_norm", "layer_norm", "grn", "instance_norm"])
def test_norms_bf16_match_jnp(name):
    rng = np.random.default_rng(1)
    x = _np(rng, (2, 60, 24), 2.0, 0.5)
    w, b = _np(rng, (24,), 0.2, 1.0), _np(rng, (24,), 0.2)
    jf = {"channel_norm": jn.channel_norm, "layer_norm": jn.layer_norm, "grn": jn.grn,
          "instance_norm": jn.instance_norm}[name]
    tf = {"channel_norm": norms.channel_norm, "layer_norm": norms.layer_norm, "grn": norms.grn,
          "instance_norm": norms.instance_norm}[name]
    want = jf(_jbf(x), _jbf(w), _jbf(b))
    got = tf(_tbf(x), _tbf(w), _tbf(b))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


def test_norms_fp32_unchanged_by_the_bf16_rule():
    """fp32 input takes exactly the fp32 steps: the bf16 rule adds no cast."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_np(rng, (2, 30, 8), 2.0))
    w, b = torch.from_numpy(_np(rng, (8,), 0.2, 1.0)), torch.from_numpy(_np(rng, (8,)))
    u = x.mean(-1, keepdim=True)
    s = ((x - u) ** 2).mean(-1, keepdim=True)
    assert torch.equal(norms.channel_norm(x, w, b), w * ((x - u) / torch.sqrt(s + norms.EPS)) + b)


@pytest.mark.parametrize("name", ["snake", "gelu"])
def test_activations_bf16_match_jnp(name):
    rng = np.random.default_rng(3)
    x = _np(rng, (4, 50, 16), 3.0)
    if name == "snake":
        alpha = np.abs(_np(rng, (16,), 0.3)) + 0.5
        want = jact.snake(_jbf(x), _jbf(alpha))
        got = act.snake(_tbf(x), _tbf(alpha))
    else:
        want, got = jact.gelu(_jbf(x)), act.gelu(_tbf(x))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


def test_fsq_indices_bitexact_across_dtypes():
    """The squash and the round are fp32: bf16 latents give the indices of
    their fp32 values, in the port and in JAX alike."""
    rng = np.random.default_rng(11)
    zbf = _tbf(_np(rng, (4, 100, 6)))
    levels = (7, 7, 7, 7, 7, 7)
    q_bf, idx_bf, _ = fsq.quantize(zbf, levels)
    _, idx_32, _ = fsq.quantize(zbf.float(), levels)
    assert q_bf.dtype == torch.bfloat16
    assert torch.equal(idx_bf, idx_32)
    _, idx_j, _ = jfsq.quantize(_jbf(zbf.float().numpy()), levels)
    np.testing.assert_array_equal(idx_bf.numpy(), np.asarray(idx_j))


def _attention_case(rng, D=8, n=16, H=6, B=2, W=3):
    T = n * W
    q, k, v = (_np(rng, (B, H, T, D)) for _ in range(3))
    table = _np(rng, (2 * n, H))
    return q, k, v, table


def test_local_attention_bf16_matches_jnp():
    rng = np.random.default_rng(4)
    q, k, v, table = _attention_case(rng)
    n = table.shape[0] // 2
    tb = _tbf(table)
    bias = att.expand_position_table(tb)                             # (H, n, 2n) bf16
    want = jatt.local_attention(_jbf(q), _jbf(k), _jbf(v), window_size=n,
                                bias=_jbf(bias.float().numpy()))
    got = la.local_attention(_tbf(q), _tbf(k), _tbf(v), window_size=n, bias_table=tb)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


def test_stem_bf16_matches_jnp():
    rng = np.random.default_rng(5)
    jp = _jax_bf16(jt.init_first_block(jax.random.PRNGKey(2), 24))
    x = _np(rng, (2, 700), 0.3)
    want = jt.first_block_apply(jp, _jbf(x)[..., None])               # (B, T, C)
    m = _load_bf16(FirstBlock(24), jp)
    with torch.no_grad():
        got = m(_tbf(x))                                              # plain on the CPU
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got.transpose(1, 2)), _f(want)) <= BF16_TOL


def _unit_params(C):
    """JAX ConvUnit params with non-zero GRN gamma / beta and alpha != 1."""
    rng = np.random.default_rng(C)
    jp = jl.init_conv_unit(jax.random.PRNGKey(C), C, snake_act=True, use_norm=True)
    jp["grn"]["gamma"] = jnp.asarray(_np(rng, (4 * C,), 0.3))
    jp["grn"]["beta"] = jnp.asarray(_np(rng, (4 * C,), 0.1))
    jp["alpha"] = jnp.asarray(np.abs(_np(rng, (4 * C,), 0.3)) + 0.7)
    return _jax_bf16(jp)


@pytest.mark.parametrize("layout,C", [("ct", 24), ("tc", 192)])
def test_conv_unit_bf16_matches_jnp(layout, C):
    rng = np.random.default_rng(6)
    jp = _unit_params(C)
    unit = _load_bf16(ConvUnit(C, use_norm=True), jp)
    if layout == "ct":
        x = _np(rng, (2, C, 300))
        want = _jbf(x) + jl.conv_unit_apply_t(jp, _jbf(x))
    else:
        x = _np(rng, (2, 150, C))
        want = _jbf(x) + jl.conv_unit_apply(jp, _jbf(x))
    with torch.no_grad():
        got = unit(_tbf(x), channels_last=layout == "tc")
    assert got.dtype == torch.bfloat16
    assert _rel_l2(_f(got), _f(want)) <= BF16_TOL


# -- each bf16 plain kernel version against its fp32 plain version ---------

def _fp32_vs_bf16(bf16_out, fp32_out):
    assert bf16_out.dtype == torch.bfloat16 and fp32_out.dtype == torch.float32
    return _rel_l2(_f(bf16_out), _f(fp32_out))


def test_attention_plain_bf16_matches_fp32_plain():
    rng = np.random.default_rng(7)
    q, k, v, table = (_tbf(a) for a in _attention_case(rng, D=32, n=20))
    n = table.shape[0] // 2
    got = att.local_attention(q, k, v, window_size=n, bias_table=table)
    want = att.local_attention(q.float(), k.float(), v.float(), window_size=n,
                               bias_table=table.float())
    assert _fp32_vs_bf16(got, want) <= BF16_TOL


def test_stem_plain_bf16_matches_fp32_plain():
    rng = np.random.default_rng(8)
    m = FirstBlock(24)
    m.init_weights(torch.Generator().manual_seed(3))
    m = m.to(torch.bfloat16)
    x = _tbf(_np(rng, (2, 900), 0.3))
    w = m.kernel_weights()
    got = fb.first_block_plain(x, w)
    want = fb.first_block_plain(x.float(), fb.FirstBlockWeights(*(t.float() for t in w)))
    assert _fp32_vs_bf16(got, want) <= BF16_TOL


@pytest.mark.parametrize("layout,C", [("ct", 48), ("tc", 128)])
def test_conv_unit_plain_bf16_matches_fp32_plain(layout, C):
    rng = np.random.default_rng(9)
    unit = _load_bf16(ConvUnit(C, use_norm=True), _unit_params(C))
    w = unit.kernel_weights()
    w32 = cu.ConvUnitWeights(*(None if t is None else t.float() for t in w))
    dim = 1 if layout == "ct" else 2
    x = _tbf(_np(rng, (2, C, 200) if dim == 1 else (2, 200, C)))
    got = cu.conv_unit_plain_bf16(x, w, channel_dim=dim)
    want = cu.conv_unit_plain(x.float(), w32, channel_dim=dim)
    assert _fp32_vs_bf16(got, want) <= BF16_TOL


# -- the encode --------------------------------------------------------------

@pytest.fixture(scope="module")
def debug_encode():
    """JAX fp32 and bf16 encodes of the four draws, the port's bf16 encodes,
    and each side's pre-FSQ latents."""
    mc = jax_config("debug").network_config
    p32 = jcodec.init_codec(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    pbf = _jax_bf16(p32)

    @jax.jit
    def enc(p, audio):
        feature = jcodec.encoder_apply(p["encoder"], audio[..., None], mc)
        trans = jcodec.en_encoder_apply(p["en_encoder"], feature, mc)
        z = linear_p(trans, p["quantizer"]["proj_in"])
        _, idx = jcodec.encode(p, audio, mc)
        return z, idx

    model = get_model("debug", device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(weights.from_jax_params(pbf, mc))
    out = []
    for seed in DRAW_SEEDS:
        audio = _np(np.random.default_rng(seed), (2, mc.hop_length * 200), 0.3)
        z32, i32 = enc(p32, jnp.asarray(audio))
        zbf, ibf = enc(pbf, _jbf(audio))
        with torch.inference_mode():
            padded, _ = model.preprocess(audio)
            c = model.codec
            zp = c.quantizer.project_in(c.en_encoder_apply(c.encoder(padded)))
            _, ip = model.encode_audio(audio)
        out.append({"i32": np.asarray(i32), "ibf": np.asarray(ibf), "ip": ip.numpy(),
                    "z32": _f(z32), "zbf": _f(zbf), "zp": _f(zp)})
    return out


def test_encode_bf16_indices_agree_with_jax_fp32_and_bf16(debug_encode):
    vs32 = np.mean([np.mean(d["ip"] == d["i32"]) for d in debug_encode])
    vsbf = np.mean([np.mean(d["ip"] == d["ibf"]) for d in debug_encode])
    assert vs32 >= AGREEMENT_FLOOR, vs32
    assert vsbf >= AGREEMENT_FLOOR, vsbf


def test_encode_bf16_latents_within_jax_own_bf16_error(debug_encode):
    port = np.mean([_rel_l2(d["zp"], d["zbf"]) for d in debug_encode])
    jax_own = np.mean([_rel_l2(d["zbf"], d["z32"]) for d in debug_encode])
    assert port <= LATENT_RATIO * jax_own, (port, jax_own)


def test_bf16_model_holds_bf16_weights_and_encodes_in_bf16():
    m = get_model("debug", device="cpu", dtype=torch.bfloat16)
    m32 = get_model("debug", device="cpu")
    assert m.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in m.codec.parameters())
    # drawn in fp32 from the seed, then cast
    for (k, a), b in zip(m.codec.state_dict().items(), m32.codec.state_dict().values()):
        assert torch.equal(a, b.to(torch.bfloat16)), k
    q, idx = m.encode_audio(np.zeros(m.mc.hop_length * 8, np.float32))
    assert q.dtype == torch.bfloat16 and idx.dtype == torch.int32


def test_decode_on_a_bf16_model_raises_naming_the_next_slice():
    """What this test held (a bf16 model's decode refused, naming the next
    slice of ROADMAP A6) is done: the decode entry points run a bf16 model
    (``tests/test_torch_bf16_decode.py``, and the test below). fp16 is still
    refused, by ``get_model`` and by the kernels of a model moved to it."""
    m = get_model("debug", device="cpu", dtype=torch.bfloat16)
    a = np.zeros((1, m.mc.hop_length * 8), np.float32)
    q, idx = m.encode_audio(a)
    assert m.decode_audio(indices=idx).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        get_model("debug", device="cpu", dtype=torch.float16)
    m.codec.to(torch.float16)
    m.dtype = torch.float16
    with pytest.raises(TypeError, match="float32, torch.bfloat16 only"):
        m.decode_audio(indices=idx)


def test_a_bf16_model_decodes_through_every_entry_point():
    """decode_audio by indices and by features, roundtrip, decode_unit (both
    ways) and StreamCodec's decodes on a bf16 model: bf16 audio (numpy fp32
    where the entry point returns numpy), finite, of the right lengths."""
    from l3ac_tpu_torch.runtime.streaming import StreamCodec
    m = get_model("debug", device="cpu", dtype=torch.bfloat16)
    hop = m.mc.hop_length
    rng = np.random.default_rng(21)
    a = (rng.standard_normal((2, hop * 30 + 7)) * 0.3).astype(np.float32)
    q, idx = m.encode_audio(a)
    outs = {"indices": m.decode_audio(indices=idx, audio_length=a.shape[1]),
            "features": m.decode_audio(audio_feature=q.float().numpy(), audio_length=a.shape[1]),
            "roundtrip": m.roundtrip(a)}
    for name, y in outs.items():
        assert y.dtype == torch.bfloat16 and y.shape == a.shape, name
        assert torch.isfinite(y.float()).all(), name
    assert torch.equal(outs["indices"], outs["features"])
    chunk_idx, chunk_q = m.extract_unit(a[:1], process_window=hop * 12)
    for kw in ({"chunk_indices": chunk_idx}, {"chunk_q_feature": chunk_q}):
        y = m.decode_unit(**kw)
        assert y.dtype == np.float32 and y.shape == (1, idx.shape[1] * hop)
        assert np.isfinite(y).all()
    sc = StreamCodec(m, chunk_seconds=hop * 10 / m.config.sample_rate, batch_size=2)
    lengths = [a.shape[1], hop * 11 + 3]
    tokens = sc.encode_streams([a[0], a[1][:lengths[1]]])
    feats = [m.codec.quantizer.indices_to_features(torch.from_numpy(t)[None], torch.bfloat16)[0]
             .detach().float().numpy() for t in tokens]    # numpy fp32, cast back by the codec
    for y in (sc.decode_indices_streams(tokens, lengths), sc.decode_streams(feats, lengths)):
        assert [o.shape for o in y] == [(n,) for n in lengths]
        assert all(o.dtype == np.float32 and np.isfinite(o).all() for o in y)


def test_prepared_weights_rebuilt_after_a_move_to_bf16():
    """A model moved with ``.to(torch.bfloat16)`` rebuilds its prepared
    operands (the caches key on dtype too): a bf16 unit gets the bf16
    kernels' operands, the stem a bf16 pack, never the cached fp32 ones."""
    m = get_model("debug", device="cpu", seed=3)
    unit, stem = m.codec.encoder.stages[0].units[0], m.codec.encoder.first
    p32, s32 = unit.prepared(), stem.prepared()
    assert isinstance(p32, cu.PreparedWeights) and unit.prepared() is p32
    m.codec.to(torch.bfloat16)
    pbf, sbf = unit.prepared(), stem.prepared()
    assert isinstance(pbf, cu.PreparedBf16) and pbf.w1.dtype == torch.bfloat16
    assert unit.prepared() is pbf
    assert sbf is not s32 and sbf.packed.shape == (fb.packed_floats(8, bf16=True),)
    m.codec.to(torch.float32)
    assert isinstance(unit.prepared(), cu.PreparedWeights)


def test_load_pretrained_casts_to_the_model_dtype(tmp_path):
    """A bf16 model loads a reference-layout checkpoint and casts it after
    conversion (JAX ``get_model(dtype=)``): its weights equal the fp32 model's
    loaded from the same files, cast to bf16."""
    from l3ac_tpu_torch.runtime import convert
    convert.write_state_dicts(convert.seeded_state_dicts(convert.load_key_manifest("debug"),
                                                         seed=4), tmp_path)
    m32 = get_model("debug", device="cpu").load_pretrained(tmp_path)
    mbf = get_model("debug", device="cpu", dtype=torch.bfloat16).load_pretrained(tmp_path)
    assert mbf.dtype == torch.bfloat16
    for (k, a), b in zip(mbf.codec.state_dict().items(), m32.codec.state_dict().values()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16)), k
