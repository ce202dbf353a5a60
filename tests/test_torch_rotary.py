"""Rotary position embeddings in the port (``en_coder_dynamic_pos = false``),
on the CPU, against JAX's jnp rotary path.

The port's ``debug`` model with the flag off at seed 0, its weights carried
into JAX's param tree (``weights.to_jax_params``) and back
(``weights.from_jax_params``): no position MLP on either side. Encode and
decode against JAX's ``encode`` / ``decode`` (indices equal, audio within
1e-4 x max(1, max |want|)); the rotary operands against JAX's
``apply_rotary`` and the attention with ``kp`` against JAX's jnp attention
with ``rotary=True``; rotary under sequence parallelism raises, as JAX
asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu.ops import attention as jattn
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models import codec as fc
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.attention import local_attention, rotary_freqs, rotary_operands
from l3ac_tpu_torch.parallel.mesh import make_mesh

OVERRIDE = {"en_coder_dynamic_pos": False}


@pytest.fixture(scope="module")
def rotary():
    m = get_model("debug", device="cpu", seed=0, network_config=OVERRIDE)
    tree = weights.to_jax_params(m.codec.state_dict(), m.codec.mc)
    m.load_state_dict(weights.from_jax_params(tree, m.codec.mc))
    return m, jax.tree.map(jnp.asarray, tree), jax_config("debug", network_config=OVERRIDE)


def test_rotary_stacks_have_no_position_mlp(rotary):
    m, p, _ = rotary
    assert not any("dyn_bias" in k for k in m.codec.state_dict())
    for stack in (p["en_encoder"]["down_trans"], p["en_decoder"]["up_trans"]):
        assert "dyn_bias" not in stack
    assert m.codec.en_encoder.down_trans.bias_cache is None


def test_encode_decode_match_jax_rotary(rotary):
    m, p, cfg = rotary
    mc = cfg.network_config
    audio = (np.random.default_rng(0).standard_normal((2, mc.hop_length * 40)) * 0.3
             ).astype(np.float32)
    jq, jidx = jax.jit(lambda p, a: jcodec.encode(p, a, mc))(p, audio)
    jy = np.asarray(jax.jit(lambda p, q: jcodec.decode(p, q, mc))(p, jq))
    with torch.inference_mode():
        q, idx = m.codec.encode(torch.from_numpy(audio))
        y = m.codec.decode(q).numpy()
        y_idx = m.codec.decode_indices(idx).numpy()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    tol = 1e-4 * max(1.0, np.abs(jy).max())
    assert np.abs(y - jy).max() <= tol
    assert np.abs(y_idx - jy).max() <= tol


@pytest.mark.parametrize("n,D", [(16, 8), (6, 12)])
def test_rotary_operands_match_jax_apply_rotary(n, D):
    rng = np.random.default_rng(n)
    B, H, W = 2, 3, 3
    q, k = (rng.standard_normal((B, H, W * n, D)).astype(np.float32) for _ in range(2))
    qr, kc, kp = rotary_operands(torch.from_numpy(q), torch.from_numpy(k), n)
    np.testing.assert_allclose(rotary_freqs(n, D).numpy(), np.asarray(jattn.rotary_freqs(n, D)),
                               rtol=1e-7)
    # JAX rotates the windowed q by n..2n-1 and the looked-around keys by 0..2n-1
    kw = k.reshape(B, H, W, n, D)
    jq, jk = jattn.apply_rotary(jnp.asarray(q.reshape(B, H, W, n, D)),
                                jnp.asarray(np.concatenate([kw, kw], axis=3)),
                                jattn.rotary_freqs(n, D))
    jk = np.asarray(jk)
    np.testing.assert_allclose(qr.numpy(), np.asarray(jq).reshape(q.shape), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kp.numpy(), jk[..., :n, :].reshape(k.shape), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kc.numpy(), jk[..., n:, :].reshape(k.shape), rtol=1e-6, atol=1e-6)


def test_attention_with_kp_matches_jax_rotary_attention():
    rng = np.random.default_rng(1)
    B, H, n, W, D = 2, 3, 16, 3, 8
    q, k, v = (rng.standard_normal((B, H, n * W, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(jattn.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            window_size=n, rotary=True))
    qr, kc, kp = rotary_operands(*map(torch.from_numpy, (q, k)), n)
    got = local_attention(qr, kc, torch.from_numpy(v), window_size=n, kp=kp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_rotary_raises_under_sequence_parallelism(rotary):
    m, _, cfg = rotary
    T = fc.sp_time_quantum(m.codec.mc)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        fc.encode_sp(m, torch.zeros(1, T), make_mesh(1, 1, 1))
    # JAX asserts the same (l3ac_tpu/ops/attention.py:154)
    from jax.sharding import PartitionSpec as P
    from l3ac_tpu.parallel.mesh import make_mesh as jax_mesh
    with pytest.raises(AssertionError, match="rotary"):
        jax.shard_map(_jax_sp_rotary, mesh=jax_mesh(dp=1, sp=1, tp=1), in_specs=P(),
                      out_specs=P(), check_vma=False)(jnp.zeros((1, 1, 32, 8)))


def _jax_sp_rotary(x):
    from l3ac_tpu.parallel import sp as jsp
    with jsp.sequence_parallel("sp"):
        return jattn.local_attention(x, x, x, window_size=16, rotary=True)
