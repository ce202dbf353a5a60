"""int8 weight-only inference of the port (CPU, plain versions) against the
JAX package's int8 path (``l3ac_tpu/ops/quantized.py``; on the CPU its
products dequantize inline, and the Pallas kernel runs in interpret mode).

Held int8 against int8: the int8 model's indices differ from the dense
model's on a few percent of tokens, in JAX too.

Tolerances: quantized weights bit for bit; products within 1e-5 x max(1,
max |want|) (fp32 sums in another order); one ConvUnit within 1e-5 x max(1,
max |want|); the whole path as ``tests/test_torch_encode.py`` and
``tests/test_torch_decode.py`` hold the dense one (indices equal except at a
borderline token; audio within 1e-4 x max(1, max |audio|)), and the port's
int8-vs-dense index agreement within 0.5 points of JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3ac_tpu.config import get_config
from l3ac_tpu.models import codec as jc
from l3ac_tpu.models import layers as jl
from l3ac_tpu.ops import quantized as jq
from l3ac_tpu.ops.pallas import int8_matmul as pk_q
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.codec import Codec
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops import fsq
from l3ac_tpu_torch.ops import kernels as K
from l3ac_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_plain
from l3ac_tpu_torch.ops.quantized import (Int8Linear, dequantize_weight, quantize_params,
                                          quantize_weight)

RNG = np.random.default_rng(23)
LENGTHS = (16000, 12345)


def _np(shape, std=1.0):
    return (RNG.standard_normal(shape) * std).astype(np.float32)


def _close(got, want, rel):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * max(1.0, np.abs(np.asarray(want)).max()), err


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """One JAX model per config for the whole file."""
    mc = get_config(name).network_config
    return jax.jit(lambda k: jc.init_codec(k, mc))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("K_in,N", [(341, 128), (128, 682), (512, 2048)])
def test_quantize_weight_is_bit_equal_to_jax(K_in, N):
    """(Cin, Cout) in JAX, (Cout, Cin) here; with an all-zero output channel
    and one whose values sit exactly on half steps (scale 1: 127 is the amax)."""
    w = _np((K_in, N), 0.05)
    w[:, 3] = 0.0
    w[:, 5] = 0.0
    w[:6, 5] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
    wq, s = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert wq.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (N,)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j).reshape(-1))
    assert wq[5, :6].tolist() == [127, 2, -4, 0, 0, 2]   # half to even
    assert s[3].item() == 1.0 and not wq[3].any()
    np.testing.assert_array_equal(dequantize_weight(wq, s).numpy(),
                                  np.asarray(jq.dequantize_weight(wq_j, s_j, jnp.float32)).T)


@pytest.mark.parametrize("M,K_in,N,bias", [
    (5, 64, 32, True),        # tests/test_pallas.py: ragged M
    (512, 128, 576, False),   # tests/test_pallas.py: qkv at 1kbps
    (37, 341, 128, True),     # GEGLU w2 width
    (37, 128, 682, False),    # GEGLU w1 width
])
def test_int8_matmul_plain_matches_jax(M, K_in, N, bias):
    x = _np((2, M, K_in))
    w = _np((K_in, N), 0.05)
    b = _np((N,)) if bias else None
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
    bj = None if b is None else jnp.asarray(b)
    want_k = np.asarray(pk_q.int8_matmul(jnp.asarray(x), wq_j, s_j, bj, interpret=True))
    want_l = np.asarray(jq.int8_linear(jnp.asarray(x), wq_j, s_j, bj))
    wq, s = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    before = dict(K.LAUNCHES)
    got = int8_matmul(torch.from_numpy(x), wq, s, None if b is None else torch.from_numpy(b))
    assert K.LAUNCHES == before      # the CPU runs the plain version
    assert got.shape == (2, M, N)
    np.testing.assert_array_equal(
        got.numpy(), int8_matmul_plain(torch.from_numpy(x), wq, s,
                                       None if b is None else torch.from_numpy(b)).numpy())
    _close(got.numpy(), want_k, 1e-5)
    _close(got.numpy(), want_l, 1e-5)


def test_int8_matmul_raises_on_bf16_naming_the_roadmap_item():
    wq, s = quantize_weight(torch.ones(4, 8))
    with pytest.raises(TypeError, match="A6"):
        int8_matmul(torch.ones(2, 8, dtype=torch.bfloat16), wq, s)


def _jax_int8_names(tree) -> set:
    out = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if leaf.dtype == jnp.int8:
            out.add(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path))
    return out


@pytest.mark.parametrize("name,count", [("debug", None), ("1kbps", 60), ("3kbps", 44)])
def test_quantize_params_selects_the_weights_jax_selects(name, count):
    """The same layers, by name: 60 at 1kbps, 44 at 3kbps, JAX's own count on
    debug. The DynamicPositionBias's w1 / w2 stay fp32."""
    mc = get_config(name).network_config
    shapes = jax.eval_shape(lambda: jq.quantize_params(jc.init_codec(jax.random.PRNGKey(0), mc)))
    want = _jax_int8_names(shapes)
    codec = quantize_params(Codec(mc, device="meta"))
    got = {k for k, v in codec.state_dict().items() if v.dtype == torch.int8}
    assert got == want
    assert len(got) == (count if count is not None else len(want)) > 0
    assert sum(isinstance(m, Int8Linear) for m in codec.modules()) == len(got)
    assert all(p.dtype == torch.float32 for n, p in codec.named_parameters() if "dyn_bias" in n)


@pytest.fixture(scope="module")
def debug_int8():
    mc = get_config("debug").network_config
    return mc, jq.quantize_params(_jax_params("debug"))


def test_from_jax_params_loads_a_quantized_tree_strictly(debug_int8):
    mc, qp = debug_int8
    sd = weights.from_jax_params(qp, mc)
    model = get_model("debug", device="cpu")
    quantize_params(model.codec)
    model.load_state_dict(sd)
    name = "en_encoder.down_trans.layers.0.attn.qkv"
    leaf = qp["en_encoder"]["down_trans"]["layers"][0]["attn"]["qkv"]
    assert sd[f"{name}.w_q"].dtype == torch.int8
    np.testing.assert_array_equal(sd[f"{name}.w_q"].numpy(), np.asarray(leaf["w_q"]).T)
    np.testing.assert_array_equal(sd[f"{name}.w_scale"].numpy(),
                                  np.asarray(leaf["w_scale"]).reshape(-1))
    got = dict(model.codec.state_dict())[f"{name}.w_q"]
    assert got.dtype == torch.int8 and torch.equal(got, sd[f"{name}.w_q"])


def test_from_jax_params_raises_on_stray_missing_or_float_int8_leaves(debug_int8):
    mc, qp = debug_int8
    unit = qp["encoder"]["last_units"][0]      # C = 16: pw1 is 1024 elements

    def with_unit(**pw1):
        units = [dict(unit, pw1=pw1)] + list(qp["encoder"]["last_units"][1:])
        return dict(qp, encoder=dict(qp["encoder"], last_units=units))

    pw1 = unit["pw1"]
    with pytest.raises(KeyError, match="last_units.0.pw1.w_scale"):
        weights.from_jax_params(with_unit(w_q=pw1["w_q"], b=pw1["b"]), mc)
    with pytest.raises(KeyError, match="last_units.0.pw1.w_q"):
        weights.from_jax_params(with_unit(w_scale=pw1["w_scale"], b=pw1["b"]), mc)
    with pytest.raises(KeyError, match="last_units.0.pw1.stray"):
        weights.from_jax_params(with_unit(**pw1, stray=pw1["w_q"]), mc)
    with pytest.raises(TypeError, match="last_units.0.pw1.w_q"):
        weights.from_jax_params(with_unit(**dict(pw1, w_q=np.asarray(pw1["w_q"], np.float32))), mc)
    q = dict(qp["quantizer"])
    wq, s = jq.quantize_weight(jnp.asarray(q["proj_in"]["w"]))
    q["proj_in"] = {"w_q": wq, "w_scale": s, "b": q["proj_in"]["b"]}   # below min_size
    with pytest.raises(KeyError, match="quantizer.proj_in"):
        weights.from_jax_params(dict(qp, quantizer=q), mc)


@pytest.mark.parametrize("C,channels_last,snake_act,use_norm", [
    (192, True, True, True), (192, True, False, False), (16, False, True, True),
    (24, False, False, True)])
def test_conv_unit_int8_matches_jax(C, channels_last, snake_act, use_norm):
    """(B, T, C): the unfused body with both products through int8_matmul;
    (B, C, T): the dequantized weights through conv_unit_ct's plain version."""
    p = jl.init_conv_unit(jax.random.PRNGKey(C), C, snake_act=snake_act, use_norm=use_norm)
    # non-trivial norm, GRN and alpha (their init values are 1 / 0)
    p = dict(p, grn={"gamma": jnp.asarray(_np((4 * C,), 0.3)),
                     "beta": jnp.asarray(_np((4 * C,), 0.1))})
    if use_norm:
        p["norm"] = {"w": jnp.asarray(1.0 + _np((C,), 0.1)), "b": jnp.asarray(_np((C,), 0.1))}
    if snake_act:
        p["alpha"] = jnp.asarray(1.0 + np.abs(_np((4 * C,), 0.3)))
    qp = jq.quantize_params({"unit": p})["unit"]
    assert qp["pw1"]["w_q"].dtype == jnp.int8 and qp["pw2"]["w_q"].dtype == jnp.int8
    x = _np((2, 150, C) if channels_last else (2, C, 150))
    if channels_last:
        want = jl.residual_conv_unit_apply(qp, jnp.asarray(x))
    else:
        want = jl.residual_conv_unit_apply_t(qp, jnp.asarray(x))
    unit = quantize_params(ConvUnit(C, snake_act=snake_act, use_norm=use_norm))
    unit.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in weights.convert_subtree(qp).items()})
    assert isinstance(unit.pw1, Int8Linear) and isinstance(unit.pw2, Int8Linear)
    with torch.inference_mode():
        got = unit(torch.from_numpy(x), channels_last=channels_last)
    _close(got.numpy(), np.asarray(want), 1e-5)


@pytest.fixture(scope="module", params=["debug", "1kbps"])
def path_case(request):
    """JAX dense and int8 encode of one ragged 2 x 1 s batch, and the int8
    decode of the int8 indices; the port's dense and int8 models on the same
    weights."""
    name = request.param
    mc = get_config(name).network_config
    params = _jax_params(name)
    qparams = jq.quantize_params(params)
    audio = np.zeros((2, max(LENGTHS)), np.float32)
    rng = np.random.default_rng(7)
    for i, n in enumerate(LENGTHS):
        audio[i, :n] = rng.standard_normal(n) * 0.1
    padded, _ = jc.preprocess(jnp.asarray(audio), mc)
    encode = jax.jit(lambda p, a: jc.encode(p, a, mc)[1])
    idx_dense = np.array(encode(params, padded))
    idx_q = np.array(encode(qparams, padded))
    audio_q = np.asarray(jax.jit(lambda p, i: jc.decode_indices(p, i, mc))(
        qparams, jnp.asarray(idx_q)))
    dense = get_model(name, device="cpu").load_state_dict(weights.from_jax_params(params, mc))
    model = get_model(name, device="cpu")
    quantize_params(model.codec)
    model.load_state_dict(weights.from_jax_params(qparams, mc))
    return name, mc, dense, model, audio, idx_dense, idx_q, audio_q


def test_int8_path_matches_jax(path_case):
    name, mc, dense, model, audio, idx_dense, idx_want, audio_want = path_case
    before = dict(K.LAUNCHES)
    _, idx = model.encode_audio(audio)
    assert K.LAUNCHES == before
    with torch.inference_mode():
        padded, _ = model.preprocess(audio)
        trans = model.codec.en_encoder_apply(model.codec.encoder(padded))
        pre = fsq.pre_round(model.codec.quantizer.project_in(trans), mc.vq.levels)
    frac = pre.numpy() - np.floor(pre.numpy())
    borderline = (np.abs(frac - 0.5) < 1e-4).any(axis=-1)
    differ = idx.numpy() != idx_want
    assert not (differ & ~borderline).any(), f"{name}: indices differ off the borderline"
    assert differ.mean() <= 1e-3

    got = model.decode_audio(indices=idx_want)
    assert got.shape == audio_want.shape and torch.isfinite(got).all()
    _close(got.numpy(), audio_want, 1e-4)

    _, idx_d = dense.encode_audio(audio)
    agree_port = (idx_d.numpy() == idx.numpy()).mean()
    agree_jax = (idx_dense == idx_want).mean()
    assert abs(agree_port - agree_jax) <= 0.005, (agree_port, agree_jax)
