"""The port's whole decode path (CPU, plain versions) against
``l3ac_tpu.models.codec`` (jnp path), with JAX's weights carried across, on
``debug`` (and its other tail modes and a last rate of 3) and on ``1kbps``
at B = 2 x ~1 s of random FSQ indices.

Tolerances: the en_decoder features within rtol / atol 1e-4 (fp32, a few
transformer layers of sums in another order); audio within
1e-4 x max(1, max |want|), fp32 through some 20 conv layers.

A zero-padded ragged row is not compared with the row alone: the
EnhanceBlock's InstanceNorm is taken over the whole time axis, so padding
changes it, in JAX too.
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
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops import kernels as K

SECONDS = 1.0


def _close_audio(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


def _indices(mc, seed):
    n_tok = int(SECONDS * 16000) // mc.hop_length
    rng = np.random.default_rng(seed)
    return rng.integers(0, mc.vq.codebook_size, (2, n_tok)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """One JAX model per config for the whole file (its init dominates the
    file's time). No bias caches: JAX then builds the same bias in-forward."""
    mc = get_config(name).network_config
    return jax.jit(lambda k: jc.init_codec(k, mc))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["debug", "1kbps"])
def case(request):
    name = request.param
    mc = get_config(name).network_config
    params = _jax_params(name)
    idx = _indices(mc, 11)
    feat = (np.random.default_rng(5).standard_normal((2, idx.shape[1], mc.feature_dim))
            * 0.5).astype(np.float32)

    @jax.jit
    def reference(p, i, f):
        q = jc.indices_to_features(p["quantizer"], i, mc.vq)
        return (q, jc.en_decoder_apply(p["en_decoder"], q, mc), jc.decode_indices(p, i, mc),
                jc.decode(p, f, mc))

    want = tuple(map(np.asarray, reference(params, jnp.asarray(idx), jnp.asarray(feat))))
    model = get_model(name, device="cpu")
    model.load_state_dict(weights.from_jax_params(params, mc))
    return name, mc, model, idx, feat, want


def test_decode_indices_matches_jax(case):
    name, mc, model, idx, _, (q_want, trans_want, audio_want, _) = case
    before = dict(K.LAUNCHES)
    audio = model.decode_audio(indices=idx)
    assert K.LAUNCHES == before
    assert audio.shape == (2, idx.shape[1] * mc.hop_length) == audio_want.shape
    assert torch.isfinite(audio).all()
    with torch.inference_mode():
        q = model.codec.quantizer.indices_to_features(torch.from_numpy(idx))
        trans = model.codec.en_decoder_apply(q)
    np.testing.assert_allclose(q.numpy(), q_want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), trans_want, rtol=1e-4, atol=1e-4)
    _close_audio(audio.numpy(), audio_want)


def test_decode_features_matches_jax(case):
    """``decode_audio(audio_feature=...)`` with features that are not codes,
    and the length crop."""
    _, _, model, _, feat, (_, _, _, want) = case
    got = model.decode_audio(audio_feature=feat, audio_length=want.shape[1] - 7)
    assert got.shape == (2, want.shape[1] - 7)
    _close_audio(got.numpy(), want[:, :-7])


def test_roundtrip_shape_and_crop():
    """Encode then decode, cropped to the input length (debug: the 1kbps
    halves are held against JAX above and in test_torch_encode.py)."""
    model = get_model("debug", device="cpu", seed=2)
    audio = (np.random.default_rng(2).standard_normal((2, 7777)) * 0.1).astype(np.float32)
    out = model.roundtrip(audio)
    assert out.shape == (2, 7777) and torch.isfinite(out).all()
    q, _ = model.encode_audio(audio)
    np.testing.assert_array_equal(out.numpy(),
                                  model.decode_audio(audio_feature=q, audio_length=7777).numpy())
    assert model.roundtrip(audio[0]).shape == (1, 7777)


def _variant(**net):
    """The debug weights under another decoder option; the ConvUnit tails get
    their own params (at x5 init scale, so the tail matters)."""
    cfg = get_config("debug", network_config=net)
    mc = cfg.network_config
    params = dict(_jax_params("debug"))
    mode = mc.decoder_last_layer
    if mode != "legacy":
        dim = mc.decoder_dims[-1]
        dils = (1, 3, 9) if mode == "dilation" else (1, 1)
        keys = jax.random.split(jax.random.PRNGKey(9), len(dils))
        units = [jax.tree.map(lambda a: a * 5.0, jl.init_conv_unit(
            k, dim, snake_act=mc.use_snake_act, use_norm=mc.use_norm, dilation=d))
            for k, d in zip(keys, dils)]
        params["decoder"] = dict(params["decoder"], tail_units=units)
    model = get_model("debug", device="cpu", network_config=net)
    model.load_state_dict(weights.from_jax_params(params, mc))
    return mc, params, model


@pytest.mark.parametrize("net", [{"decoder_last_layer": "dilation"},
                                 {"decoder_last_layer": None},
                                 {"decode_rates": [2, 2, 3]}],
                         ids=["dilation", "none", "rates-2-2-3"])
def test_debug_decoder_options_match_jax(net):
    """The ConvUnit tails, and a last rate of 3: the tail then reads the
    interleaved activation (``legacy_tail_ct``) instead of the phase pair."""
    mc, params, model = _variant(**net)
    idx = _indices(mc, 3)
    want = np.asarray(jax.jit(lambda p, i: jc.decode_indices(p, i, mc))(params, jnp.asarray(idx)))
    got = model.decode_audio(indices=idx)
    assert got.shape == want.shape == (2, idx.shape[1] * mc.hop_length)
    _close_audio(got.numpy(), want)
