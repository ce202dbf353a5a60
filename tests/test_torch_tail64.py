"""The decoder's fp64 tail flag (``tail_high_precision``) in the port, on the
CPU, against ``l3ac_tpu/models/decoder.py:decoder_apply(tail_high_precision=
True)``, which needs ``jax_enable_x64``: every JAX call here runs inside
``jax.enable_x64()``, a context, so the flag cannot leak to the other tests
of the worker.

A float64 decoder (``Decoder.double()``) against JAX's decoder on float64
params and input (the whole tail in float64 on both sides, within 1e-9), and
the float32 ``debug`` decoder with the flag against JAX's float32 one with it
(the tail in float64, the audio cast back; within 1e-6 x max(1, max |want|)),
both legacy and dilation tails; the route is counted in
``models.decoder.ROUTES["tail_fp64"]`` and the polyphase tail is off.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import decoder as jdec
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models import decoder as dmod
from l3ac_tpu_torch.models.zoo import get_model


def _pair(network_config=None):
    m = get_model("debug", device="cpu", seed=0, network_config=network_config or {})
    tree = weights.to_jax_params(m.codec.state_dict(), m.codec.mc)
    return m, tree["decoder"], jax_config("debug", network_config=network_config or {})


@pytest.mark.parametrize("last_layer", ["legacy", "dilation"])
def test_fp64_tail_matches_jax_under_x64(last_layer):
    m, jp, cfg = _pair({"decoder_last_layer": last_layer})
    mc = cfg.network_config
    x = np.random.default_rng(0).standard_normal((2, 24, mc.feature_dim))
    with jax.enable_x64():
        fn = jax.jit(lambda p, x: jdec.decoder_apply(p, x, mc, tail_high_precision=True))
        want64 = np.asarray(fn(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp),
                               jnp.asarray(x, jnp.float64)))[..., 0]
        want32 = np.asarray(fn(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x, jnp.float32)))[..., 0]
    assert want64.dtype == np.float64 and want32.dtype == np.float32
    assert jnp.zeros(1).dtype == jnp.float32   # the flag did not leak
    dec64 = copy.deepcopy(m.codec.decoder).double()
    before = dmod.ROUTES["tail_fp64"]
    with torch.inference_mode():
        got64 = dec64(torch.from_numpy(x), tail_high_precision=True).numpy()
        got32 = m.codec.decoder(torch.from_numpy(x).float(), tail_high_precision=True)
        plain32 = m.codec.decoder(torch.from_numpy(x).float())
    assert dmod.ROUTES["tail_fp64"] == before + 2
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got64, want64, rtol=1e-9, atol=1e-11)
    assert np.abs(got32.numpy() - want32).max() <= 1e-6 * max(1.0, np.abs(want32).max())
    # the flag moves the fp32 audio by roundoff only
    assert np.abs(got32.numpy() - plain32.numpy()).max() <= 1e-5


def test_fp64_tail_takes_the_interleaved_input():
    m, _, _ = _pair()
    dec = m.codec.decoder
    x = torch.randn(1, 8, m.codec.mc.feature_dim, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        h, phases = dec.pre_tail(x)
        assert h is None and len(phases) == 2      # debug ends in stride 2: polyphase
        with pytest.raises(ValueError, match="interleaved"):
            dec.tail_apply(h, phases, high_precision=True)
        h, phases = dec.pre_tail(x, poly=False)
        assert phases is None and h.dtype == torch.float32
        y = dec.tail_apply(h, high_precision=True)
    assert y.shape == (1, 8 * int(np.prod(m.codec.mc.decode_rates)))
