"""The kernel modules' plain versions (what each wrapper runs on a CPU
tensor) against the JAX package on the CPU: its jnp path and, where noted,
its Pallas kernel in interpret mode.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3ac_tpu.models import decoder as jdec
from l3ac_tpu.models import layers as jl
from l3ac_tpu.models import tconv as jt
from l3ac_tpu.ops import attention as jattn
from l3ac_tpu.ops import transposed as jtx
from l3ac_tpu.ops.pallas import conv_unit as pk_cu
from l3ac_tpu.ops.pallas import first_block as pk_fb
from l3ac_tpu.ops.pallas import legacy_tail as pk_tail
from l3ac_tpu.ops.pallas import local_attention as pk_attn
from l3ac_tpu.ops.pallas import upsample as pk_up
from l3ac_tpu.utils import init as jinit
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.models.tconv import FirstBlock
from l3ac_tpu_torch.ops import channel_norm, snake
from l3ac_tpu_torch.ops import kernels as K
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.ops.kernels import up_fused as uf

RNG = np.random.default_rng(5)


def _np(shape, std=1.0):
    return (RNG.standard_normal(shape) * std).astype(np.float32)


def _load(module, jp):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in weights.convert_subtree(jp).items()})
    return module


@pytest.fixture(scope="module")
def first_block_case():
    """init_first_block weights scaled x50 so the output is O(100) and the
    edge columns matter (at init scale every error hides under atol)."""
    jp = jax.tree.map(lambda a: a * 50.0, jt.init_first_block(jax.random.PRNGKey(0), 24))
    x = _np((2, 300, 1))
    want = np.asarray(jt.first_block_apply(jp, jnp.asarray(x)))         # (B, T, C)
    return jp, x, want


def test_first_block_plain_matches_jnp_all_columns(first_block_case):
    jp, x, want = first_block_case
    m = _load(FirstBlock(24), jp)
    with torch.no_grad():
        got = fb.first_block(torch.from_numpy(x[..., 0]), m.kernel_weights())
    got = got.transpose(1, 2).numpy()
    scale = np.abs(want).max()
    assert scale > 50
    # fp32 sums in another order (XLA's conv vs torch's); 1e-6 of the scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    for edge in (slice(0, 3), slice(-3, None)):
        np.testing.assert_allclose(got[:, edge], want[:, edge], rtol=0, atol=1e-6 * scale)


def test_pallas_first_block_edge_fault_is_not_copied(first_block_case):
    """The Pallas kernel does not re-zero the pooled branch signals outside
    [0, T) before the k7 branch conv, so its first and last three columns
    leave the jnp semantics, which the port follows."""
    jp, x, want = first_block_case
    pallas = np.asarray(pk_fb.first_block(jnp.asarray(x), jp, interpret=True))
    scale = np.abs(want).max()
    inner = slice(3, -3)
    np.testing.assert_allclose(pallas[:, inner], want[:, inner], rtol=0, atol=1e-5 * scale)
    edge_gap = max(np.abs(pallas[:, :3] - want[:, :3]).max(),
                   np.abs(pallas[:, -3:] - want[:, -3:]).max())
    assert edge_gap > 1e-2 * scale


def _conv_unit_params(C, use_norm=True):
    """JAX ConvUnit params with non-zero GRN gamma/beta and alpha != 1, so the
    GRN fold and the snake are exercised."""
    jp = jl.init_conv_unit(jax.random.PRNGKey(C), C, snake_act=True, use_norm=use_norm)
    jp["dw"]["w"] = jp["dw"]["w"] * 20.0
    jp["grn"]["gamma"] = jnp.asarray(_np((4 * C,), 0.3))
    jp["grn"]["beta"] = jnp.asarray(_np((4 * C,), 0.1))
    jp["alpha"] = jnp.asarray(np.abs(_np((4 * C,), 0.3)) + 0.7)
    return jp


def test_conv_unit_ct_plain_matches_jnp():
    C = 24
    jp = _conv_unit_params(C)
    x = _np((2, C, 300))
    want = np.asarray(x + jl.conv_unit_apply_t(jp, jnp.asarray(x)))
    unit = _load(ConvUnit(C, use_norm=True), jp)
    with torch.no_grad():
        got = cu.conv_unit_ct(torch.from_numpy(x), unit.kernel_weights()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_unit_plain_matches_jnp_and_pallas():
    """(B, T, C) at C = 192. Against the Pallas kernel (interpret mode), which
    folds GRN with n = 1, the tolerance also covers the fold: at most
    1e-8 / ||h|| relative, far below fp32 rounding here."""
    C = 192
    jp = _conv_unit_params(C)
    x = _np((2, 150, C))
    want = np.asarray(x + jl.conv_unit_apply(jp, jnp.asarray(x)))
    pallas = np.asarray(pk_cu.conv_unit(jnp.asarray(x), jp, interpret=True))
    unit = _load(ConvUnit(C, use_norm=True), jp)
    with torch.no_grad():
        got = cu.conv_unit(torch.from_numpy(x), unit.kernel_weights()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_norm", [True, False])
def test_grn_fold_matches_exact_grn(use_norm):
    """The folded pw2 the CUDA kernel takes (fold_grn, n = 1) reproduces the
    plain version's exact GRN within fp32 rounding."""
    C = 16
    unit = _load(ConvUnit(C, use_norm=use_norm), _conv_unit_params(C, use_norm))
    w = unit.kernel_weights()
    x = torch.from_numpy(_np((2, C, 64)))
    with torch.no_grad():
        want = cu.conv_unit_plain(x, w, channel_dim=1)
        y = torch.nn.functional.conv1d(x, w.dw_w, w.dw_b, padding=3, groups=C)
        if use_norm:
            y = channel_norm(y, w.norm_w, w.norm_b, dim=1)
        h = snake(torch.einsum("oc,bct->bot", w.pw1_w, y) + w.pw1_b[:, None],
                     w.alpha[:, None])
        w2f, b2f = cu.fold_grn(w)
        got = x + torch.einsum("mc,bmt->bct", w2f, h) + b2f[:, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,T", [(16, 48), (250, 500)])
def test_local_attention_plain_matches_jnp_and_pallas(n, T):
    B, H, D = 1, 2, 32
    q, k, v = _np((B, H, T, D)), _np((B, H, T, D)), _np((B, H, T, D))
    bias = _np((H, n, 2 * n))
    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    want = np.asarray(jattn.local_attention(jq, jk, jv, window_size=n, bias=jb))
    pallas = np.asarray(pk_attn.local_attention(jq, jk, jv, window_size=n, bias=jb,
                                                interpret=True))
    got = la.local_attention(*map(torch.from_numpy, (q, k, v)), window_size=n,
                             bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)


def _up_stage(Ci, Co, norm=True):
    """A JAX decoder stage's up-path params, above init scale: the conv at
    ~1 / sqrt(Ci), a norm with non-trivial affine."""
    stage = {"up_conv": {"w": jnp.asarray(_np((1, Ci, Co), Ci ** -0.5)),
                         "b": jnp.asarray(_np((Co,), 0.3))}}
    if norm:
        stage["up_norm"] = {"w": jnp.asarray(1.0 + _np((Co,), 0.2)),
                            "b": jnp.asarray(_np((Co,), 0.2))}
    return stage


def _up_weights(stage):
    n = stage.get("up_norm")
    t = lambda a: torch.from_numpy(np.array(a))
    return uf.UpWeights(t(stage["up_conv"]["w"][0].T), t(stage["up_conv"]["b"]),
                        None if n is None else t(n["w"]), None if n is None else t(n["b"]))


@pytest.mark.parametrize("Ci,Co,T,scale,in_t,split", [
    (48, 24, 6000, 2, True, True),     # decoder stage 3: 3 Pallas tiles of 2560
    (96, 48, 3000, 3, True, False),    # stage 2: 3 tiles of 1280
    (256, 96, 1200, 3, False, False),  # stage 1: 3 tiles of 512
    (512, 256, 600, 5, False, False),  # stage 0: 3 tiles of 256
])
def test_up_fused_plain_matches_jnp_and_pallas(Ci, Co, T, scale, in_t, split):
    """Against the jnp chain (``decoder._up_path`` on the CPU) and the Pallas
    kernel in interpret mode, with T spanning several of its tiles. fp32
    sums in another order: 1e-5 of the output scale."""
    stage = _up_stage(Ci, Co)
    x = _np((1, Ci, T) if in_t else (1, T, Ci))
    want = np.asarray(jdec._up_path(stage, jnp.asarray(x), scale, in_t=in_t))
    args = (jnp.asarray(x), stage["up_conv"]["w"], stage["up_conv"]["b"],
            stage["up_norm"]["w"], stage["up_norm"]["b"])
    if in_t:
        pallas = pk_up.up_fused_ct(*args, scale=scale, interpret=True, phase_split=split)
    else:
        pallas = pk_up.up_fused(*args, scale=scale, interpret=True)
    w = _up_weights(stage)
    with torch.no_grad():
        if in_t:
            got = uf.up_fused_ct(torch.from_numpy(x), w, scale=scale, phase_split=split)
        else:
            got = uf.up_fused(torch.from_numpy(x), w, scale=scale)
    if split:
        assert isinstance(got, tuple) and len(got) == scale
        got = np.stack([g.numpy() for g in got], axis=-1).reshape(want.shape)
        pallas = np.stack([np.asarray(p) for p in pallas], axis=-1).reshape(want.shape)
    else:
        got = got.numpy()
    atol = 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=atol)


def test_up_fused_plain_without_norm_and_at_scale_one():
    stage = _up_stage(16, 12, norm=False)
    x = _np((2, 16, 50))
    for scale in (1, 4):
        want = np.asarray(jdec._up_path(stage, jnp.asarray(x), scale, in_t=True))
        got = uf.up_fused_ct(torch.from_numpy(x), _up_weights(stage), scale=scale)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _tail_params(C):
    """JAX legacy-tail params: init_legacy_unit x5, out conv x5, alphas and
    biases off their init values. Pre-tanh values stay O(1-10) (std ~2), so
    tanh does not hide errors and fp32 ordering stays far below tolerance."""
    rng = np.random.default_rng(C)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    units = []
    for k in keys[:3]:
        u = jax.tree.map(lambda a: a * 5.0, jl.init_legacy_unit(k, C))
        u["alpha1"] = jnp.asarray(1 + np.abs(rng.standard_normal(C) * 0.3), jnp.float32)
        u["alpha2"] = jnp.asarray(1 + np.abs(rng.standard_normal(C) * 0.3), jnp.float32)
        u["conv1"]["b"] = jnp.asarray(rng.standard_normal(C) * 0.1, jnp.float32)
        u["conv2"]["b"] = jnp.asarray(rng.standard_normal(C) * 0.1, jnp.float32)
        units.append(u)
    alpha = jnp.asarray(1 + np.abs(rng.standard_normal(C) * 0.3), jnp.float32)
    out_conv = jax.tree.map(lambda a: a * 5.0, jinit.conv_params(keys[3], 7, C, 1))
    out_conv["b"] = jnp.asarray([0.05], jnp.float32)
    return units, alpha, out_conv


def _tail_weights(units, alpha, out_conv):
    t = lambda a: torch.from_numpy(np.array(a))
    return lt.TailWeights(
        torch.stack([t(u["alpha1"]) for u in units]),
        torch.stack([t(np.asarray(u["conv1"]["w"]).transpose(2, 1, 0)) for u in units]),
        torch.stack([t(u["conv1"]["b"]) for u in units]),
        torch.stack([t(u["alpha2"]) for u in units]),
        torch.stack([t(np.asarray(u["conv2"]["w"])[0].T) for u in units]),
        torch.stack([t(u["conv2"]["b"]) for u in units]),
        t(alpha), t(np.asarray(out_conv["w"]).transpose(2, 1, 0)), t(out_conv["b"]))


@pytest.mark.parametrize("poly", [True, False])
def test_legacy_tail_plain_matches_jnp_and_pallas(poly, monkeypatch):
    """Against the jnp tail (``legacy_unit_apply_t`` x3 -> snake -> conv ->
    tanh) and the Pallas kernel in interpret mode, with its tile cut to 512
    so that T = 1502 spans several tiles (and the phase pair two)."""
    C, T = 24, 1502
    units, alpha, out_conv = _tail_params(C)
    x = _np((1, C, T))
    h = jnp.asarray(x)
    for u, d in zip(units, jdec.TAIL_DILATIONS):
        h = h + jl.legacy_unit_apply_t(u, h, dilation=d)
    y = jtx.conv1d_t(jtx.snake_t(h, alpha), out_conv["w"], out_conv["b"], padding=3)
    assert 1.0 < float(jnp.std(y)) and float(jnp.abs(y).max()) < 30.0
    want = np.asarray(jnp.tanh(y))[:, 0]
    monkeypatch.setattr(pk_tail, "TILE", 512)
    w = _tail_weights(units, alpha, out_conv)
    if poly:
        x0, x1 = np.ascontiguousarray(x[..., 0::2]), np.ascontiguousarray(x[..., 1::2])
        pallas = pk_tail.legacy_tail_poly_ct(jnp.asarray(x0), jnp.asarray(x1), units, alpha,
                                             out_conv, interpret=True)
        got = lt.legacy_tail_poly_ct(torch.from_numpy(x0), torch.from_numpy(x1), w)
    else:
        pallas = pk_tail.legacy_tail_ct(jnp.asarray(x), units, alpha, out_conv, interpret=True)
        got = lt.legacy_tail_ct(torch.from_numpy(x), w)
    assert got.shape == (1, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas)[..., 0], rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    C, n = 8, 16
    unit = ConvUnit(C, use_norm=True)
    unit.init_weights(torch.Generator().manual_seed(0))
    stem = FirstBlock(C)
    stem.init_weights(torch.Generator().manual_seed(1))
    before = dict(K.LAUNCHES)
    x_ct = torch.from_numpy(_np((1, C, 40)))
    audio = torch.from_numpy(_np((1, 100)))
    q, k, v = (torch.from_numpy(_np((1, 2, 2 * n, 32))) for _ in range(3))
    with torch.no_grad():
        w = unit.kernel_weights()
        assert torch.equal(cu.conv_unit_ct(x_ct, w), cu.conv_unit_plain(x_ct, w, channel_dim=1))
        x_tc = x_ct.transpose(1, 2).contiguous()
        assert torch.equal(cu.conv_unit(x_tc, w), cu.conv_unit_plain(x_tc, w, channel_dim=2))
        assert torch.equal(fb.first_block(audio, stem.kernel_weights()),
                           fb.first_block_plain(audio, stem.kernel_weights()))
        assert torch.equal(la.local_attention(q, k, v, window_size=n),
                           la.local_attention_plain(q, k, v, window_size=n))
        uw = _up_weights(_up_stage(C, 4))
        assert torch.equal(uf.up_fused_ct(x_ct, uw, scale=3),
                           uf.up_fused_plain(x_ct, uw, scale=3, channel_dim=1))
        assert torch.equal(uf.up_fused(x_tc, uw, scale=2),
                           uf.up_fused_plain(x_tc, uw, scale=2, channel_dim=2))
        tw = _tail_weights(*_tail_params(8))
        x8 = torch.from_numpy(_np((1, 8, 40)))
        assert torch.equal(lt.legacy_tail_ct(x8, tw), lt.legacy_tail_plain(x8, tw))
        assert torch.equal(lt.legacy_tail_poly_ct(x8[..., 0::2], x8[..., 1::2], tw),
                           lt.legacy_tail_plain(x8, tw))
    assert K.LAUNCHES == before


def test_wrappers_take_fp32_only():
    """fp32 and bf16 only (the bf16 variants' own tests are in
    test_torch_bf16.py and test_torch_bf16_decode.py), never another dtype
    for a kernel: fp16 raises on every wrapper, the decode-only ones
    included; bf16 reaches their bf16 plain versions on the CPU (float64 on
    the CPU reaches the plain versions too: test_torch_autograd.py)."""
    unit = ConvUnit(8)
    with pytest.raises(TypeError, match="float32"):
        cu.conv_unit_ct(torch.zeros(1, 8, 16, dtype=torch.float16), unit.kernel_weights())
    with pytest.raises(TypeError, match="float32"):
        fb.first_block(torch.zeros(1, 16, dtype=torch.float16),
                       FirstBlock(8).kernel_weights())
    q = torch.zeros(1, 1, 16, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        la.local_attention(q, q, q, window_size=16)
    uw, tw = _up_weights(_up_stage(8, 4)), _tail_weights(*_tail_params(8))
    x = torch.zeros(1, 8, 40, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        uf.up_fused_ct(x, uw, scale=2)
    with pytest.raises(TypeError, match="float32"):
        lt.legacy_tail_ct(x, tw)
    x = torch.zeros(1, 8, 40, dtype=torch.bfloat16)
    assert uf.up_fused_ct(x, uf.UpWeights(*(t.bfloat16() for t in uw)), scale=2).dtype == x.dtype
    assert lt.legacy_tail_ct(x, lt.TailWeights(*(t.bfloat16() for t in tw))).dtype == x.dtype
