"""The widths the JAX kernels take, on the port's kernels (ROADMAP C3), shown
on the CPU.

- For each override of ``debug`` that reaches a width the kernels did not
  take before (head dim 64 and 128, tail C 32 and 20, stem Cout 128, a
  conv unit at C = 768 with up paths 768 -> 320 -> 80 -> 24, a (B, C, T) up
  path 12 -> 80, the streaming kernel's Co above 64), the model's
  encode and decode run on the CPU with every kernel wrapper watched, and
  each shape a wrapper was handed is held to that wrapper's admission rule,
  the function its launch calls before it launches (``conv_unit.admits``,
  ``first_block.admits``, ``local_attention.admits``,
  ``up_fused.route_for``, ``legacy_tail.admits``). So the card takes every
  shape the model hands it at these widths.
- The port's plain encode and decode against the JAX package's jnp path at
  ``{"feature_dim": 256}`` (head dim 64) and ``{"decoder_dims": (16, 12, 80,
  24)}``: indices equal, audio within 1e-4.

The kernels themselves run these widths on the card in ``chip_smoke.py``'s
C3 phase and ``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models import decoder as mdec
from l3ac_tpu_torch.models import layers as mlayers
from l3ac_tpu_torch.models import local_transformer as mlt
from l3ac_tpu_torch.models import tconv as mtconv
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.ops.kernels import up_fused as uf

OVERRIDES = (
    {"feature_dim": 256},                      # head dim 64
    {"feature_dim": 512},                      # head dim 128
    {"decoder_dims": (16, 12, 8, 32)},         # tail C = 32
    {"decoder_dims": (16, 12, 8, 20)},         # tail C = 20
    {"encoder_dims": (128, 12, 16)},           # stem Cout = 128
    {"decoder_dims": (768, 320, 80, 24)},      # conv_unit C = 768; up 768 -> 320 -> 80 -> 24
    {"decoder_dims": (16, 12, 80, 24)},        # a (B, C, T) up path 12 -> 80
)


def _watch(monkeypatch, seen):
    """Record the shape every kernel wrapper is handed, as the model calls it."""
    def spy(module, name, key, shape_of):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            seen.append((key, shape_of(*args, **kwargs)))
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    spy(mlayers, "conv_unit", "conv_unit", lambda x, *a, **k: x.shape[2])
    spy(mlayers, "conv_unit_ct", "conv_unit_ct", lambda x, *a, **k: x.shape[1])
    spy(mtconv, "first_block", "first_block", lambda x, w: w.weights.w2.shape[0])
    spy(mtconv, "first_block_plain", "first_block", lambda x, w: w.w2.shape[0])
    spy(mlt, "local_attention", "local_attention", lambda q, *a, **k: q.shape[-1])
    spy(mdec, "up_fused", "up_fused", lambda x, w, **k: (x.shape[2], w.w.shape[0], True))
    spy(mdec, "up_fused_ct", "up_fused_ct", lambda x, w, **k: (x.shape[1], w.w.shape[0], False))
    spy(mdec, "legacy_tail_ct", "legacy_tail", lambda x, w: x.shape[1])
    spy(mdec, "legacy_tail_poly_ct", "legacy_tail", lambda x0, x1, w: x0.shape[1])


def _why(key, shape):
    if key in ("conv_unit", "conv_unit_ct"):
        return cu.admits(key, shape)
    if key == "first_block":
        return fb.admits(shape)
    if key == "local_attention":
        return la.admits(shape)
    if key in ("up_fused", "up_fused_ct"):
        return None if uf.route_for(*shape) is not None else f"no route for {shape}"
    return lt.admits(shape)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: str(o).replace(" ", ""))
def test_every_wrapper_admits_the_shapes_the_model_hands_it(monkeypatch, overrides):
    seen = []
    _watch(monkeypatch, seen)
    m = get_model("debug", device="cpu", network_config=overrides)
    a = np.zeros((1, m.mc.hop_length * 40), np.float32)
    a[0, ::7] = 0.3
    q, idx = m.encode_audio(a)
    m.decode_audio(indices=idx)
    keys = {k for k, _ in seen}
    assert {"conv_unit_ct", "conv_unit", "first_block", "local_attention",
            "legacy_tail"} <= keys, keys
    assert keys & {"up_fused", "up_fused_ct"}
    refused = {(k, s): _why(k, s) for k, s in seen if _why(k, s) is not None}
    assert not refused, refused


def test_the_widths_before_c3_stay_admitted():
    """Every released config's widths keep their fast routes; the widths past
    the former limits (refused before the general routes of
    ``csrc/general.cu``, ROADMAP C3) are admitted now, on the general
    route."""
    for C in (24, 48, 96):
        assert cu.admits("conv_unit_ct", C) is None
        assert cu.route_for("conv_unit_ct", C) == "narrow"
    assert cu.admits("conv_unit_ct", 97) is None
    for C in (16, 192, 256, 512, 768, 1024):
        assert cu.admits("conv_unit", C) is None, C
    for C in (192, 256, 512, 768, 1024):
        assert cu.route_for("conv_unit", C) == "tc", C
    assert cu.route_for("conv_unit", 16) == "general"
    assert cu.admits("conv_unit", 1088) is None and cu.admits("conv_unit", 520) is None
    assert cu.route_for("conv_unit", 1088) == cu.route_for("conv_unit", 520) == "general"
    assert cu.admits("conv_unit", 16, torch.bfloat16) is None           # bf16: C % 8 == 0
    assert cu.route_for("conv_unit", 16, torch.bfloat16) == "tc"
    assert cu.admits("conv_unit", 12, torch.bfloat16) is None
    assert cu.route_for("conv_unit", 12, torch.bfloat16) == "general"
    assert fb.admits(24) is None and fb.admits(256) is None and fb.admits(257) is None
    assert la.admits(32) is None and la.admits(128) is None
    assert la.admits(132) is None and la.admits(30) is None
    assert la.fast_takes(32, [0, 32, 3 * 6 * 32], [0], 4)
    assert not la.fast_takes(132, [0, 132, 3 * 6 * 132], [0], 4)
    assert not la.fast_takes(30, [0, 30, 3 * 6 * 30], [0], 4)
    assert lt.admits(24) is None and lt.admits(64) is None
    assert lt.route_for(24) == lt.route_for(64) == "tc"
    assert lt.admits(68) is None and lt.admits(22) is None
    assert lt.route_for(68) == lt.route_for(22) == "general"


def test_plain_path_at_head_dim_64_matches_jnp():
    """``{"feature_dim": 256}`` (D = 64): the port's plain encode and decode
    against the JAX package's jnp path on the same weights."""
    mc = jax_config("debug", network_config={"feature_dim": 256}).network_config
    p = jcodec.init_codec(jax.random.PRNGKey(0), mc)
    m = get_model("debug", device="cpu", network_config={"feature_dim": 256})
    m.load_state_dict(weights.from_jax_params(p, mc))
    rng = np.random.default_rng(1000)
    audio = (rng.standard_normal((2, mc.hop_length * 60)) * 0.3).astype(np.float32)
    _, j_idx = jax.jit(lambda p, a: jcodec.encode(p, a, mc))(p, audio)
    j_audio = jax.jit(lambda p, i: jcodec.decode_indices(p, i, mc))(p, j_idx)
    _, idx = m.encode_audio(audio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    y = m.decode_audio(indices=idx)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_audio), rtol=0, atol=1e-4)


def test_plain_path_at_up_width_80_matches_jnp():
    """``{"decoder_dims": (16, 12, 80, 24)}`` (a (B, C, T) up path 12 -> 80):
    the port's plain encode and decode against the JAX package's jnp path on
    the port's seeded weights (carried to JAX by ``weights.to_jax_params``)."""
    net = {"decoder_dims": (16, 12, 80, 24)}
    mc = jax_config("debug", network_config=net).network_config
    m = get_model("debug", device="cpu", seed=3, network_config=net)
    p = jax.tree.map(jax.numpy.asarray, weights.to_jax_params(m.codec.state_dict(), mc))
    rng = np.random.default_rng(1001)
    audio = (rng.standard_normal((2, mc.hop_length * 60)) * 0.3).astype(np.float32)
    _, j_idx = jax.jit(lambda p, a: jcodec.encode(p, a, mc))(p, audio)
    j_audio = jax.jit(lambda p, i: jcodec.decode_indices(p, i, mc))(p, j_idx)
    _, idx = m.encode_audio(audio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    y = m.decode_audio(indices=idx)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_audio), rtol=0, atol=1e-4)
