"""Every width the JAX kernels take, on the port's kernels (ROADMAP C3, the
general routes of ``csrc/general.cu``), shown on the CPU.

- Overrides of ``debug`` that reach every former ceiling: A head dim 10
  (D % 4 != 0), B head dims 192 and 256 (D > 128), C a conv unit at C = 1280
  and 600 with a (B, T, C) up path 1280 -> 600 and tail C = 22, D a (B, C, T)
  unit at C = 200, (B, C, T) up paths 12 -> 200 -> 96 and tail C = 96, E stem
  Cout = 320 and a bf16 unit at C = 100. Their encode and decode run on the
  CPU in fp32 and bf16 with every kernel wrapper watched
  (``test_torch_shapes._watch``); each shape a wrapper is handed is admitted
  by its rule, and the override's targeted shape takes the general route.
- Every admission function admits every width 1..2048 (head dims 1..512).
- The port's plain encode and decode against the JAX package's jnp path at
  A, C, D and E: indices equal, audio within 1e-4.
- The general routes' weight buffers unpack to the plain weights.

The kernels run these widths on the card in ``chip_smoke.py``'s C3 phase.
"""

import jax
import numpy as np
import pytest
import torch

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import codec as jcodec
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.ops.kernels import up_fused as uf
from test_torch_shapes import _watch, _why

# override of debug -> (wrapper key, shape) that must take the general route
OVERRIDES = {
    "A": ({"feature_dim": 40}, ("local_attention", 10)),
    "B768": ({"feature_dim": 768}, ("local_attention", 192)),
    "B1024": ({"feature_dim": 1024}, ("local_attention", 256)),
    "C": ({"decoder_dims": (1280, 600, 160, 22)}, ("conv_unit", 1280)),
    "D": ({"decoder_dims": (16, 12, 200, 96)}, ("up_fused_ct", (12, 200, False))),
    "E": ({"encoder_dims": (320, 100, 104)}, ("first_block", 320)),
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _general(key, shape, dtype) -> bool:
    """Whether the wrapper ``key`` runs ``shape`` on the general route."""
    if key in ("conv_unit", "conv_unit_ct"):
        return cu.route_for(key, shape, dtype) == "general"
    if key == "local_attention":
        return not la.fast_takes(shape, [0, 0, 3 * 6 * shape], [0], torch.finfo(dtype).bits // 8)
    if key in ("up_fused", "up_fused_ct"):
        return uf.route_for(*shape, dtype == torch.bfloat16) == "general"
    if key == "legacy_tail":
        return lt.route_for(shape) == "general"
    return shape > fb.BF16_CHUNK  # first_block: the wide stem


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", OVERRIDES, ids=str)
def test_every_wrapper_admits_the_c3_overrides(monkeypatch, name, dtype):
    overrides, target = OVERRIDES[name]
    seen = []
    _watch(monkeypatch, seen)
    m = get_model("debug", device="cpu", network_config=overrides, dtype=DTYPES[dtype])
    a = np.zeros((1, m.mc.hop_length * 24), np.float32)
    a[0, ::7] = 0.3
    _, idx = m.encode_audio(a)
    m.decode_audio(indices=idx)
    refused = {(k, s): _why(k, s) for k, s in seen if _why(k, s) is not None}
    assert not refused, refused
    assert target in seen, (target, sorted(set(seen), key=str))
    assert _general(*target, DTYPES[dtype]), target


def test_the_c3_overrides_reach_every_former_ceiling():
    """Between them the overrides hand a wrapper each width the port's fast
    kernels did not take (C3's list plus D % 4 != 0)."""
    fp32, bf16 = torch.float32, torch.bfloat16
    assert _general("local_attention", 10, fp32) and _general("local_attention", 10, bf16)
    assert _general("local_attention", 192, fp32) and _general("local_attention", 256, bf16)
    assert _general("conv_unit", 1280, fp32) and _general("conv_unit", 1280, bf16)
    assert _general("conv_unit", 600, fp32) and not _general("conv_unit", 600, bf16)
    # (B, C, T) above 96 takes conv_unit's rule on the transposed x: fp32 C = 200
    # (refused there before) and bf16 C = 100 the general route
    assert cu.route_for("conv_unit_ct", 200, fp32) == "general" and _general("conv_unit", 100, bf16)
    assert _general("up_fused", (1280, 600, True), fp32)
    assert _general("up_fused_ct", (12, 200, False), fp32)
    assert _general("up_fused_ct", (200, 96, False), bf16)
    assert _general("legacy_tail", 22, fp32) and _general("legacy_tail", 96, fp32)
    assert _general("first_block", 320, fp32)


WIDTHS = range(1, 2049)


@pytest.mark.parametrize("fn", ["conv_unit", "local_attention", "first_block", "legacy_tail",
                                "up_fused"])
def test_every_width_is_admitted(fn):
    if fn == "conv_unit":
        for name in ("conv_unit", "conv_unit_ct"):
            for dtype in DTYPES.values():
                for partial in (False, True):
                    for C in WIDTHS:
                        assert cu.admits(name, C, dtype, partial) is None, (name, C, dtype)
                        assert cu.route_for(name, C, dtype, partial) in (
                            "narrow", "tc", "general")
        assert cu.admits("conv_unit", 0) is not None
    elif fn == "local_attention":
        assert all(la.admits(D) is None for D in range(1, 513))
        assert la.admits(0) is not None
    elif fn == "first_block":
        assert all(fb.admits(C) is None for C in WIDTHS) and fb.admits(0) is not None
    elif fn == "legacy_tail":
        assert all(lt.admits(C) is None for C in WIDTHS) and lt.admits(0) is not None
        assert {lt.route_for(C) for C in WIDTHS} == {"tc", "general"}
    else:
        pairs = [(c, c) for c in WIDTHS] + [(ci, co) for ci in range(1, 2049, 7)
                                            for co in range(1, 2049, 11)]
        for cl in (False, True):
            for bf16 in (False, True):
                for ci, co in pairs:
                    assert uf.route_for(ci, co, cl, bf16) is not None, (ci, co, cl, bf16)
        assert uf.route_for(0, 8, True) is None


def _jnp_parity(net: dict, seed: int):
    mc = jax_config("debug", network_config=net).network_config
    m = get_model("debug", device="cpu", seed=seed, network_config=net)
    p = jax.tree.map(jax.numpy.asarray, weights.to_jax_params(m.codec.state_dict(), mc))
    rng = np.random.default_rng(1100 + seed)
    audio = (rng.standard_normal((2, mc.hop_length * 40)) * 0.3).astype(np.float32)
    _, j_idx = jax.jit(lambda p, a: jcodec.encode(p, a, mc))(p, audio)
    j_audio = jax.jit(lambda p, i: jcodec.decode_indices(p, i, mc))(p, j_idx)
    _, idx = m.encode_audio(audio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    y = m.decode_audio(indices=idx)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_audio), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["A", "C", "D", "E"])
def test_plain_path_at_c3_override_matches_jnp(name):
    """The port's plain encode and decode against the JAX package's jnp path
    on the port's seeded weights (carried to JAX by ``weights.to_jax_params``)."""
    _jnp_parity(OVERRIDES[name][0], seed=4)


def _t(rng, shape, std=1.0):
    return torch.tensor(rng.standard_normal(shape) * std, dtype=torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_general_buffers_unpack_to_the_weights(dtype):
    """The general routes' buffers: the tail's fp32 vectors and weights (the
    convs tap-major), the up path's W and fp32 vectors; each part equals its
    plain weight."""
    rng = np.random.default_rng(7)
    dt = DTYPES[dtype]
    C = 22
    w = lt.TailWeights(*(x.to(dt) for x in (
        _t(rng, (3, C)), _t(rng, (3, C, C, 7)), _t(rng, (3, C)), _t(rng, (3, C)),
        _t(rng, (3, C, C)), _t(rng, (3, C)), _t(rng, (C,)), _t(rng, (1, C, 7)), _t(rng, (1,)))))
    w1, w2, wo, vec = lt.prepared_general(w)
    # the general product reads the convs tap-major, rows zero-filled past C
    assert torch.equal(w1[..., :C], w.w1.permute(0, 3, 1, 2)) and \
        torch.equal(w2[..., :C], w.w2) and torch.equal(wo[..., :C], w.wo.permute(2, 0, 1))
    assert not (w1[..., C:].any() or w2[..., C:].any() or wo[..., C:].any())
    assert vec.dtype == torch.float32 and vec.shape == (13 * C + 1,)
    parts = torch.split(vec, [3 * C] * 4 + [C, 1])
    for got, want in zip(parts, (w.a1, w.b1, w.a2, w.b2, w.ao, w.bo)):
        assert torch.equal(got, want.float().reshape(-1))
    Co, Ci = 200, 12
    uw = uf.UpWeights(_t(rng, (Co, Ci)).to(dt), _t(rng, (Co,)).to(dt), _t(rng, (Co,)).to(dt),
                      _t(rng, (Co,)).to(dt))
    prep = uf.prepared_up(uw)
    assert torch.equal(prep.buffer("general", uw), uw.w)
    vec = prep.buffer("general_vec", uw)
    assert vec.dtype == torch.float32
    for got, want in zip(torch.split(vec, Co), (uw.b, uw.norm_w, uw.norm_b)):
        assert torch.equal(got, want.float())
    assert torch.equal(uf.phase_taps(3, torch.device("cpu")),
                       torch.tensor(uf.phase_weights(3), dtype=torch.float32))
