"""The released configs that the other port tests do not cover, ``0k75bps``,
``1k5bps`` and ``3kbps`` (3kbps: the plain, uncompressed transformer), held
against ``l3ac_tpu.models.codec`` (jnp path) with JAX's weights carried
across, at B = 2 x 1 s with ragged lengths (CPU, plain versions).

Between them they run attention windows 200, 300, 400 and 600 and the
decoder's linear upsample at rate 4. Tolerances as in
``tests/test_torch_encode.py`` and ``tests/test_torch_decode.py``: indices
equal except at a token with a pre-round value within 1e-4 of a half step;
audio within 1e-4 x max(1, max |audio|).
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


@pytest.fixture(scope="module", params=["0k75bps", "1k5bps", "3kbps"])
def case(request):
    name = request.param
    mc = get_config(name).network_config
    params = jax.jit(lambda k: jc.init_codec(k, mc))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    audio = np.zeros((2, max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        audio[i, :n] = rng.standard_normal(n) * 0.1
    padded, _ = jc.preprocess(jnp.asarray(audio), mc)

    @jax.jit
    def reference(p, a):
        _, idx = jc.encode(p, a, mc)
        return idx, jc.decode_indices(p, idx, mc)

    idx, out = map(np.array, reference(params, padded))
    model = get_model(name, device="cpu")
    model.load_state_dict(weights.from_jax_params(params, mc))
    return name, mc, model, audio, idx, out


def test_encode_matches_jax(case):
    name, mc, model, audio, idx_want, _ = case
    _, idx = model.encode_audio(audio)
    assert idx.shape == idx_want.shape == (2, -(-audio.shape[1] // mc.hop_length))
    with torch.inference_mode():
        padded, _ = model.preprocess(audio)
        trans = model.codec.en_encoder_apply(model.codec.encoder(padded))
        pre = fsq.pre_round(model.codec.quantizer.project_in(trans), mc.vq.levels)
    frac = pre.numpy() - np.floor(pre.numpy())
    borderline = (np.abs(frac - 0.5) < 1e-4).any(axis=-1)
    differ = idx.numpy() != idx_want
    assert not (differ & ~borderline).any(), f"{name}: indices differ off the borderline"
    assert differ.mean() <= 1e-3


def test_decode_indices_matches_jax(case):
    _, mc, model, _, idx, want = case
    got = model.decode_audio(indices=idx)
    assert got.shape == want.shape == (2, idx.shape[1] * mc.hop_length)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))
