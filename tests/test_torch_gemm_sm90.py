"""The bf16 wgmma GEMM core (``l3ac_tpu_torch/csrc/gemm_sm90.cuh``) on the
CPU: its accumulation scheme, its route rule, and host twins of its layout
arithmetic.

``tc_gemm.gemm_bf16_emulated`` does the rounding the core does: bf16
operands (an int8 weight dequantized to ``bf16(fp32(q) s)`` first), one fp32
accumulator across the whole of K with each k16 step's products added in
fp32 toward zero, then the epilogue in fp32 and one rounding to bf16. It is
held at every K of the 1kbps bf16 model (small M) against the bf16 plain
versions (``int8_matmul_plain_bf16``, the products of
``conv_unit_plain_bf16``) within 2^-6 x max(1, max |plain|) with >= 99.9 % of
the outputs within one bf16 ulp (chip_smoke.py's bf16 tolerance), and
against the JAX package's Pallas int8 kernel in interpret mode on bf16 x.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda_sm90.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l3ac_tpu.ops import quantized as jq
from l3ac_tpu.ops.pallas import int8_matmul as pk_q
from l3ac_tpu_torch.ops import channel_norm, gelu, snake
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import gemm_sm90 as g
from l3ac_tpu_torch.ops.kernels.int8_matmul import int8_matmul_plain_bf16
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_bf16_emulated
from l3ac_tpu_torch.ops.quantized import quantize_weight

TOL = 2.0 ** -6   # chip_smoke.py, bf16 kernels: max abs error <= TOL * max(1, max |plain|)
ULP_SHARE = 0.999
M = 48            # rows: the codec's M (6000 - 71160) cut
# every K of the 1kbps bf16 model's core products: ConvUnit pw1 / pw2 at C =
# 192, 256, 512; transformer qkv / out / GEGLU w1 (128), out (192), w2 (341)
KS = (128, 192, 256, 341, 512, 768, 1024, 2048)
HEADER = Path(__file__).resolve().parents[1] / "l3ac_tpu_torch" / "csrc" / "gemm_sm90.cuh"


def _rng(*key):
    return np.random.default_rng(list(key))


def _t(rng, shape, std=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dtype)


@pytest.fixture
def one_thread():
    """Torch on one CPU thread for the test, as the other test workers run
    beside it (many threads per worker oversubscribe the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_bf16_close(got, want):
    """chip_smoke.py's rule for a bf16 kernel against its bf16 plain version."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g_, w_ = got.float(), want.float()
    err = (g_ - w_).abs().max().item()
    assert err <= TOL * max(1.0, w_.abs().max().item()), err
    ulp = torch.where(w_ == 0, torch.ones_like(w_), w_.abs() * 2.0 ** -7)
    assert ((g_ - w_).abs() <= ulp).float().mean().item() >= ULP_SHARE


@pytest.mark.parametrize("Kd", KS)
def test_one_accumulator_across_k_holds_the_bf16_product(Kd):
    """bf16 B: the scheme against the plain bf16 product, bias in fp32."""
    rng = _rng(Kd, 1)
    N = 96
    a, w = _t(rng, (M, Kd), 1.0, torch.bfloat16), _t(rng, (N, Kd), Kd ** -0.5, torch.bfloat16)
    bias = _t(rng, (N,), 0.1)
    got = gemm_bf16_emulated(a, w, bias=bias).bfloat16()
    _assert_bf16_close(got, g.gemm_plain_bf16(a, w, bias))


@pytest.mark.parametrize("Kd", KS)
def test_one_accumulator_across_k_holds_the_int8_product(Kd):
    """int8 B on bf16 x: the scheme against ``int8_matmul_plain_bf16``, the
    bias bf16 added in fp32."""
    rng = _rng(Kd, 2)
    N = 96
    x = _t(rng, (M, Kd), 1.0, torch.bfloat16)
    q, s = quantize_weight(_t(rng, (N, Kd), Kd ** -0.5))
    b = _t(rng, (N,), 0.1, torch.bfloat16)
    got = gemm_bf16_emulated(x, q, scale=s, bias=b.float()).bfloat16()
    _assert_bf16_close(got, int8_matmul_plain_bf16(x, q, s, b))


def _emulated_unit_bf16(x, p, dilation):
    """conv_unit_tc.cu's bf16 unit with its products emulated: the dw conv
    and norm in fp32 (a rounded to bf16), h = act(a W1^T + b1) rounded,
    out = bf16(x + h W2'^T + b2')."""
    B, T, C = x.shape
    k = p.dw.shape[-1]
    y = torch.nn.functional.conv1d(x.float().transpose(1, 2), p.dw[:, None, :], p.dw_b, groups=C,
                                   padding=(k - 1) * dilation // 2, dilation=dilation)
    if p.norm_w is not None:
        y = channel_norm(y, p.norm_w, p.norm_b, dim=1)
    a = y.transpose(1, 2).reshape(B * T, C).bfloat16()
    h = gemm_bf16_emulated(a, p.w1, bias=p.b1)
    h = (snake(h, p.alpha) if p.alpha is not None else gelu(h)).bfloat16()
    y2 = gemm_bf16_emulated(h, p.w2, bias=p.b2)
    return (x.float() + y2.reshape(B, T, C)).bfloat16()


@pytest.mark.parametrize("C,dilation,norm,act", [(192, 1, True, True), (256, 3, True, True),
                                                 (512, 9, False, False)])
def test_emulated_bf16_unit_matches_the_plain_unit(C, dilation, norm, act, one_thread):
    """The whole bf16 unit at the widths of the 1kbps model (pw1 K = C, pw2
    K = 4C), the core emulated, against ``conv_unit_plain_bf16``."""
    rng = _rng(C, 3)
    bf = torch.bfloat16
    x = _t(rng, (2, 24, C), 1.0, bf)
    w = cu.ConvUnitWeights(
        _t(rng, (C, 1, 7), 7 ** -0.5, bf), _t(rng, (C,), 0.1, bf),
        (1.0 + _t(rng, (C,), 0.1)).to(bf) if norm else None, _t(rng, (C,), 0.1, bf) if norm else None,
        _t(rng, (4 * C, C), C ** -0.5, bf), _t(rng, (4 * C,), 0.1, bf),
        (1.0 + _t(rng, (4 * C,), 0.2).abs()).to(bf) if act else None,
        _t(rng, (4 * C,), 0.1, bf), _t(rng, (4 * C,), 0.1, bf),
        _t(rng, (C, 4 * C), (4 * C) ** -0.5, bf), _t(rng, (C,), 0.1, bf))
    p = cu.prepare_bf16(w)
    _assert_bf16_close(_emulated_unit_bf16(x, p, dilation),
                       cu.conv_unit_plain_bf16(x, w, channel_dim=2, dilation=dilation))


def test_emulated_int8_matches_the_jax_pallas_kernel_on_bf16_x():
    """The JAX package's int8 kernel (interpret mode) on bf16 x at a ragged
    GEGLU shape: M = 70 (no multiple of 64), K = 341 (the cp.async route),
    N = 128; JAX layout (K, N)."""
    rng = _rng(5)
    x = _t(rng, (70, 341), 1.0, torch.bfloat16)
    b = _t(rng, (128,), 0.1, torch.bfloat16)
    w = _t(rng, (341, 128), 0.05)
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w.numpy()))
    want = np.array(pk_q.int8_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16), wq_j, s_j,
                                       jnp.asarray(b.float().numpy(), jnp.bfloat16),
                                       interpret=True).astype(jnp.float32))
    q, s = quantize_weight(w.T.contiguous())
    got = gemm_bf16_emulated(x, q, scale=s, bias=b.float()).bfloat16()
    _assert_bf16_close(got, torch.from_numpy(want).bfloat16())
    assert g.route_for(70, 128, 341, int8=True, a_ptr=0, b_ptr=0) == "cp_async"


def _traced_gemm_shapes(monkeypatch):
    """(K, N, int8) of every product the core runs on the 1kbps bf16 and
    bf16 int8 paths: a short encode and decode of the bf16 model, then of
    its int8 copy, on the CPU, recording each channels-last ``conv_unit``
    (pw1 (C, 4C), pw2 (4C, C)) and each ``int8_matmul`` call."""
    import l3ac_tpu_torch.models.layers as layers
    import l3ac_tpu_torch.ops.quantized as quantized
    from l3ac_tpu_torch.models.zoo import get_model
    seen = set()
    unit, int8 = layers.conv_unit, quantized.int8_matmul

    def traced_unit(x, w, dilation=1):
        C = x.shape[-1]
        seen.update({(C, 4 * C, False), (4 * C, C, False)})
        return unit(x, w, dilation=dilation)

    def traced_int8(x, w_q, scale, b=None):
        seen.add((x.shape[-1], w_q.shape[0], True))
        return int8(x, w_q, scale, b)

    monkeypatch.setattr(layers, "conv_unit", traced_unit)
    monkeypatch.setattr(quantized, "int8_matmul", traced_int8)
    m = get_model("1kbps", device="cpu", dtype=torch.bfloat16)
    audio = (np.random.default_rng(0).standard_normal((1, 1600)) * 0.1).astype(np.float32)
    with torch.no_grad():
        for _ in range(2):
            _, idx = m.encode_audio(audio)
            m.decode_audio(indices=idx)
            quantized.quantize_params(m.codec)
    return seen


def test_route_rule_on_every_product_of_the_1kbps_bf16_paths(monkeypatch, one_thread):
    """TMA for every product of the 1kbps bf16 and bf16 int8 paths but the
    GEGLU w2 (K = 341, int8), which takes the cp.async route."""
    shapes = _traced_gemm_shapes(monkeypatch)
    assert {(k, n) for k, n, q in shapes if not q} == {
        (192, 768), (768, 192), (512, 2048), (2048, 512), (256, 1024), (1024, 256)}
    assert len({s for s in shapes if s[2]}) == 10
    cp = set()
    for k, n, q in shapes:
        for m in (6000, 14232, 18000, 71160):
            r = g.route_for(m, n, k, int8=q, a_ptr=0, b_ptr=1 << 20)
            if r == "cp_async":
                cp.add((k, n, q))
            else:
                assert k % g.tma_multiple(q) == 0
    assert cp == {(341, 128, True)}


def test_route_rule_admits_every_shape_the_mma_sync_core_took():
    """Nothing the one-pass core launched is refused: bf16 B at K % 8 == 0
    with N even, int8 B at any K and N; TMA exactly where the strides and
    bases are 16-byte aligned."""
    for Kd in range(1, 80):
        for N in (1, 2, 7, 64, 682):
            for a_ptr, b_ptr in ((0, 0), (2, 0), (0, 8), (4096, 16)):
                for q in (False, True):
                    r = g.route_for(5, N, Kd, int8=q, a_ptr=a_ptr, b_ptr=b_ptr)
                    aligned = a_ptr % 16 == 0 and b_ptr % 16 == 0
                    assert r == ("tma" if Kd % (16 if q else 8) == 0 and aligned else "cp_async")
    with pytest.raises(ValueError):
        g.route_for(0, 8, 8, int8=False, a_ptr=0, b_ptr=0)


def test_cp_async_tiles_read_back_through_the_wgmma_descriptor():
    """Host twin of the layout: a tile stored as the cp.async route stores it
    (chunk j of row r at swizzle128(r, j), TMA's 128-byte swizzle) reads back
    unchanged through the descriptor's addressing at every k16 slice (start
    + 32 kk bytes, SBO 1024, address bits 4-6 XOR 7-9), for A's 128 rows and
    B's 256."""
    for rows in (128, 256):
        tile = np.arange(rows * 64, dtype=np.int64).reshape(rows, 64)   # (row, k) element ids
        smem = np.full(rows * g.ROW_BYTES // 2, -1, dtype=np.int64)       # 2-byte slots
        for r in range(rows):
            for j in range(8):
                o = g.swizzle128(r, j) // 2
                smem[o:o + 8] = tile[r, 8 * j:8 * j + 8]
        assert (smem >= 0).all()                                           # a permutation
        for kk in range(4):
            for r in range(rows):
                got = [smem[g.wgmma_read_offset(32 * kk, r, 2 * e) // 2] for e in range(16)]
                assert got == list(tile[r, 16 * kk:16 * kk + 16])
        # a consumer group's A half starts 64 rows (8 KB) in: the same reads
        for r in range(64, rows):
            assert smem[g.wgmma_read_offset(64 * g.ROW_BYTES, r - 64, 0) // 2] == tile[r, 0]


def test_int8_widening_by_byte_permute_is_exact():
    """Host twin of the int8 tile's widening: every int8 value, in every
    byte of a word, comes out as the exact fp32 integer."""
    for q in range(-128, 128):
        for i in range(4):
            word = (q & 0xFF) << (8 * i) | (0x5A << (8 * ((i + 1) % 4)))
            assert g.widen_int8(word, i) == q


def _ulps(got, x64):
    """|got - sin| in ulps of the correctly rounded fp32 sine."""
    want = torch.sin(x64)
    ulp = torch.from_numpy(np.spacing(want.abs().float().numpy()).astype(np.float64))
    return (got.double() - want).abs() / ulp


def test_branch_free_sine_keeps_sinf_accuracy():
    """Host twin of the snake epilogue's sine (sin_ilp): within 2 ulp of the
    correctly rounded sine for |x| <= 100 (the hidden activations' range),
    and within 1e-7 absolute up to 8192, past which the kernel calls sinf."""
    rng = _rng(17)
    x = _t(rng, (200_000,), 40.0).clamp(-100, 100)
    assert _ulps(g.sin_ilp(x), x.double()).max().item() <= 2.0
    x = torch.from_numpy(rng.uniform(-8192, 8192, 200_000).astype(np.float32))
    assert (g.sin_ilp(x).double() - torch.sin(x.double())).abs().max().item() <= 1e-7


def test_newton_quotient_is_ieee_division():
    """Host twin of the kernels' branch-free quotient: equal to fp32 IEEE
    division for the snake's sin^2 / (alpha + eps) and the norm's
    (y - u) / sd operands."""
    rng = _rng(19)
    s2 = torch.sin(_t(rng, (200_000,), 3.0)) ** 2
    d = (1.0 + _t(rng, (200_000,), 0.5).abs()) + 1e-8
    assert torch.equal(g.newton_quotient(s2, d), s2 / d)
    y = _t(rng, (200_000,), 3.0)
    sd = _t(rng, (200_000,), 2.0).abs() + 1e-4
    assert torch.equal(g.newton_quotient(y, sd), y / sd)


def _header_config(name):
    m = re.search(rf"using {name} = Config<(\d+), (\d+), (true|false), (true|false)(?:, (\d+))?>;",
                  HEADER.read_text())
    assert m, name
    return g.Config(int(m[1]), int(m[2]), m[3] == "true", m[4] == "true", int(m[5] or 1))


def test_configs_mirror_the_header_and_fit_the_sm():
    """BF16_CONFIG / INT8_CONFIG are the header's Bf16Config / Int8Config,
    and their shared memory (ring, barriers, alignment) fits a block; the
    tool's variants fit too."""
    from l3ac_tpu_torch.tools import tc_variants
    assert _header_config("Bf16Config") == g.BF16_CONFIG
    assert _header_config("Int8Config") == g.INT8_CONFIG
    assert g.BF16_CONFIG.smem == 1024 + 4 * (64 + 128) * 128 + 4 * 24
    assert g.INT8_CONFIG.smem == 1024 + 4 * ((128 + 128) * 128 + 128 * 64) + 4 * 24
    for cfg in (g.BF16_CONFIG, g.INT8_CONFIG, *(c for _, b, q, _ in tc_variants.SM90 for c in (b, q))):
        assert cfg.fits(), cfg
    assert not g.Config(256, 5, True, False).fits()


def test_sm90_variant_substitutions_still_apply():
    """tools/tc_variants.py builds tools/sm90_variants.cu once per
    configuration by text substitution; each must match exactly once."""
    from l3ac_tpu_torch.tools import tc_variants, variant_source
    assert tc_variants.SM90[0][1:] == (g.BF16_CONFIG, g.INT8_CONFIG, True)
    assert not tc_variants.sm90_subs(*tc_variants.SM90[0][1:])   # variant 0: the file as it is
    for label, bf16, int8, persistent in tc_variants.SM90[1:]:
        subs = tc_variants.sm90_subs(bf16, int8, persistent)
        src = variant_source(tc_variants.SM90_SOURCE, subs, "tc_variants")
        assert len(subs) >= 1 and all(new in src for _, new in subs), label
