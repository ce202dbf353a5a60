"""The port's whole encode path (CPU, plain versions) against
``l3ac_tpu.models.codec.encode`` (jnp path), with JAX's weights carried
across, on ``debug`` and on ``1kbps`` at B = 2 x 1 s with ragged lengths
(the shorter row zero-padded by the caller).

Tolerances: the transformer output (pre-quantization features) within
rtol 1e-4 / atol 1e-4 (fp32, ~20 layers of sums in another order). FSQ
indices are equal, except at a token where some dimension's pre-round value
lies within 1e-4 of a half step; the test asserts that no other token
differs and that quantized features agree wherever the indices do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3ac_tpu.config import get_config
from l3ac_tpu.models import codec as jc
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops import fsq

LENGTHS = (16000, 12345)


@pytest.fixture(scope="module", params=["debug", "1kbps"])
def case(request):
    name = request.param
    mc = get_config(name).network_config
    params = jc.attach_bias_caches(jc.init_codec(jax.random.PRNGKey(0), mc), mc)
    rng = np.random.default_rng(7)
    audio = np.zeros((2, max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        audio[i, :n] = rng.standard_normal(n) * 0.1
    padded, _ = jc.preprocess(jnp.asarray(audio), mc)
    feature = jc.encoder_apply(params["encoder"], padded[..., None], mc)
    trans = np.asarray(jc.en_encoder_apply(params["en_encoder"], feature, mc))
    q, idx = jax.jit(lambda p, a: jc.encode(p, a, mc))(params, padded)
    model = get_model(name, device="cpu")
    model.load_state_dict(weights.from_jax_params(params, mc))
    return name, mc, model, audio, trans, np.asarray(q), np.asarray(idx)


def test_encode_matches_jax(case):
    name, mc, model, audio, trans_want, q_want, idx_want = case
    q, idx = model.encode_audio(audio)
    n_tok = -(-audio.shape[1] // mc.hop_length)
    assert q.shape == (2, n_tok, mc.feature_dim) and idx.shape == (2, n_tok)
    assert idx.dtype == torch.int32

    with torch.inference_mode():
        padded, _ = model.preprocess(audio)
        trans = model.codec.en_encoder_apply(model.codec.encoder(padded))
        pre = fsq.pre_round(model.codec.quantizer.project_in(trans), mc.vq.levels)
    np.testing.assert_allclose(trans.numpy(), trans_want, rtol=1e-4, atol=1e-4)

    frac = pre.numpy() - np.floor(pre.numpy())
    borderline = (np.abs(frac - 0.5) < 1e-4).any(axis=-1)
    differ = idx.numpy() != idx_want
    assert not (differ & ~borderline).any(), f"{name}: indices differ off the borderline"
    assert differ.mean() <= 1e-3
    same = ~differ
    np.testing.assert_allclose(q.numpy()[same], q_want[same], rtol=1e-4, atol=1e-4)


def test_ragged_row_matches_its_own_encode(case):
    """The zero-padded short row encodes as the same row alone, padded to
    the batch length."""
    _, _, model, audio, _, _, _ = case
    q_b, idx_b = model.encode_audio(audio)
    q_1, idx_1 = model.encode_audio(audio[1:])
    np.testing.assert_array_equal(idx_b[1:].numpy(), idx_1.numpy())
    np.testing.assert_allclose(q_b[1:].numpy(), q_1.numpy(), rtol=1e-5, atol=1e-5)
