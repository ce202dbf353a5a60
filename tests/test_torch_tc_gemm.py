"""The split-precision arithmetic of the tensor-core GEMM core
(``l3ac_tpu_torch/csrc/tc_gemm.cuh``) and the ConvUnit weight preparation,
on the CPU.

``tc_gemm.gemm_emulated`` does the rounding the kernels do: for an fp32
weight 3 TF32 passes with round-to-nearest-away splits (``cvt.rna.tf32.f32``),
for an int8 one 3 bf16 passes of A split into three round-to-nearest-even
bf16 terms (scale after the sum), mma steps that add in fp32 toward zero,
and a fresh accumulator per K step of 32. Held at every product shape
of the 1kbps paths with M cut to 256 rows: against a float64 product, within
2x the error of the fp32 plain product and within TOL (the card's
kernel-vs-plain tolerance); and against the JAX package (the Pallas int8
kernel in interpret mode, the jnp ConvUnit).

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l3ac_tpu.models import layers as jl
from l3ac_tpu.ops import quantized as jq
from l3ac_tpu.ops.pallas import int8_matmul as pk_q
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.encoder import NARROW_MAX_C
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.ops import channel_norm, snake
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels.int8_matmul import int8_matmul_plain
from l3ac_tpu_torch.ops.kernels.tc_gemm import (gemm_emulated, split_bf16x3, split_tf32,
                                                tf32_rna)
from l3ac_tpu_torch.ops.quantized import quantize_params, quantize_weight
from _torch_threads import one_thread  # noqa: F401

TOL = 1e-4   # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
M = 256      # rows: the codec's M (6000 - 71160) cut
# int8_matmul (K, N): transformer qkv / out / GEGLU w1 / w2, ConvUnit pw1 / pw2
# at C = 192, 512, 256
INT8_SHAPES = [(128, 576), (192, 128), (128, 682), (341, 128), (192, 768), (768, 192),
               (512, 2048), (2048, 512), (256, 1024), (1024, 256)]
# the wide conv_unit's products (K, N): pw1 (C, 4C) and pw2 (4C, C)
FP32_SHAPES = [s for C in (192, 256, 512) for s in ((C, 4 * C), (4 * C, C))]


pytestmark = pytest.mark.usefixtures("one_thread")


def _rng(*key):
    return np.random.default_rng(list(key))


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _max_err(got, want):
    return (got.double() - want).abs().max().item()


@pytest.mark.parametrize("K,N", INT8_SHAPES)
def test_int8_split_is_as_accurate_as_fp32(K, N):
    """3 bf16 passes, scale after the sum: the exact function is s * sum(x q) + b."""
    rng = _rng(K, N)
    x, b = _t(rng, (M, K)), _t(rng, (N,), 0.1)
    q, s = quantize_weight(_t(rng, (N, K), K ** -0.5))
    exact = (x.double() @ q.double().T) * s.double() + b.double()
    got = gemm_emulated(x, q, scale=s, bias=b)
    plain = x @ (q.float() * s[:, None]).T + b
    e_split, e_plain = _max_err(got, exact), _max_err(plain, exact)
    assert e_split <= 2 * e_plain, (e_split, e_plain)
    assert e_split <= TOL * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize("K,N", FP32_SHAPES)
def test_fp32_split_is_as_accurate_as_fp32(K, N):
    """3xTF32 at the pw1 / pw2 shapes of C = 192, 256, 512."""
    rng = _rng(K, N, 1)
    a, w = _t(rng, (M, K)), _t(rng, (N, K), K ** -0.5)
    exact = a.double() @ w.double().T
    got = gemm_emulated(a, w)
    e_split, e_plain = _max_err(got, exact), _max_err(a @ w.T, exact)
    assert e_split <= 2 * e_plain, (e_split, e_plain)
    assert e_split <= TOL * max(1.0, exact.abs().max().item())


def test_every_int8_value_is_exact_in_bf16_and_tf32():
    q = torch.arange(-127, 128, dtype=torch.float32)
    x0, x1, x2 = split_bf16x3(q)
    assert torch.equal(x0, q) and not x1.any() and not x2.any()
    hi, lo = split_tf32(q)
    assert torch.equal(tf32_rna(q), q) and torch.equal(hi, q) and not lo.any()


def test_bf16x3_split_carries_all_24_bits():
    x = _t(_rng(8), (4096,), 3.0) * torch.exp2(_t(_rng(9), (4096,), 6.0).round())
    x0, x1, x2 = split_bf16x3(x)
    for part in (x0, x1, x2):
        assert torch.equal(part, part.bfloat16().float())
    assert _max_err(x0 + x1 + x2, x.double()) == 0.0


def test_tf32_rna_rounds_to_nearest_with_ties_away_from_zero():
    """Against a float64 rounding to 11 significant bits, and at the ties."""
    x = _t(_rng(3), (4096,), 10.0) * torch.exp2(_t(_rng(4), (4096,), 8.0).round())
    xd = x.double()
    ulp = torch.exp2(torch.floor(torch.log2(xd.abs())) - 10)
    want = torch.sign(xd) * torch.floor(xd.abs() / ulp + 0.5) * ulp
    assert torch.equal(tf32_rna(x).double(), want)
    one = 1.0 + 2.0 ** -11                                      # halfway to 1 + 2^-10
    ties = torch.tensor([one, -one, 1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0 * 2.0 ** -11 + 1.0])
    assert tf32_rna(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                       1.0 + 2.0 ** -9]
    bits = tf32_rna(x).view(torch.int32)
    assert not (bits & 0x1FFF).any()
    hi, lo = split_tf32(x)
    assert _max_err(hi + lo, xd) <= 2.0 ** -21 * xd.abs().max().item()


@pytest.mark.parametrize("K,N", INT8_SHAPES)
def test_scale_after_the_sum_agrees_with_scale_in_the_weight(K, N):
    """The kernel's s * sum(x q) against the plain version's sum(x (q s))."""
    rng = _rng(K, N, 2)
    x, b = _t(rng, (M, K)), _t(rng, (N,), 0.1)
    q, s = quantize_weight(_t(rng, (N, K), K ** -0.5))
    want = int8_matmul_plain(x, q, s, b)
    got = (x @ q.float().T) * s + b
    assert _max_err(got, want.double()) <= TOL * max(1.0, want.abs().max().item())


def test_int8_split_matches_the_jax_pallas_kernel():
    """The JAX package's int8 kernel (interpret mode) on the same inputs, at a
    GEGLU width: (K, N) = (341, 128), JAX layout (K, N)."""
    rng = _rng(5)
    x, b, w = _t(rng, (70, 341)), _t(rng, (128,), 0.1), _t(rng, (341, 128), 0.05)
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w.numpy()))
    want = np.asarray(pk_q.int8_matmul(jnp.asarray(x.numpy()), wq_j, s_j,
                                       jnp.asarray(b.numpy()), interpret=True))
    q, s = quantize_weight(w.T.contiguous())
    got = gemm_emulated(x, q, scale=s, bias=b).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def _conv_unit_params(C, use_norm):
    rng = _rng(C, 6)
    jp = jl.init_conv_unit(jax.random.PRNGKey(C), C, snake_act=True, use_norm=use_norm)
    jp["dw"]["w"] = jp["dw"]["w"] * 20.0
    jp["grn"]["gamma"] = jnp.asarray(rng.standard_normal(4 * C).astype(np.float32) * 0.3)
    jp["grn"]["beta"] = jnp.asarray(rng.standard_normal(4 * C).astype(np.float32) * 0.1)
    jp["alpha"] = jnp.asarray(np.abs(rng.standard_normal(4 * C)).astype(np.float32) * 0.3 + 0.7)
    return jp


def _unit(C, use_norm=True):
    unit = ConvUnit(C, use_norm=use_norm)
    unit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          weights.convert_subtree(_conv_unit_params(C, use_norm)).items()})
    return unit


def _conv_unit_tc_emulated(x, w, dilation):
    """conv_unit_tc.cu's three steps, its products emulated: dw conv and
    ChannelNorm, h = snake(a W1^T + b1), out = x + (h W2'^T + b2')."""
    B, T, C = x.shape
    k = w.dw_w.shape[-1]
    y = torch.nn.functional.conv1d(x.transpose(1, 2), w.dw_w, w.dw_b, groups=C,
                                   padding=(k - 1) * dilation // 2, dilation=dilation)
    y = y.transpose(1, 2)
    if w.norm_w is not None:
        y = channel_norm(y, w.norm_w, w.norm_b, dim=2)
    w2f, b2f = cu.fold_grn(w)
    h = snake(gemm_emulated(y.reshape(B * T, C), w.pw1_w) + w.pw1_b, w.alpha)
    return x + (gemm_emulated(h, w2f.t().contiguous()) + b2f).reshape(B, T, C)


@pytest.mark.parametrize("C,use_norm,dilation", [(64, True, 1), (128, False, 9)])
def test_conv_unit_tensor_core_scheme_matches_jax(C, use_norm, dilation):
    """The tensor-core ConvUnit (GRN folded, products split) against the JAX
    package's jnp unit on (B, T, C): the fold and the split together stay
    within fp32 rounding of the exact GRN."""
    jp = _conv_unit_params(C, use_norm)
    x = _t(_rng(C, 7), (2, 40, C))
    want = np.asarray(x.numpy() + jl.conv_unit_apply(jp, jnp.asarray(x.numpy()),
                                                     dilation=dilation))
    with torch.no_grad():
        got = _conv_unit_tc_emulated(x, _unit(C, use_norm).kernel_weights(), dilation).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_released_channels_last_widths_take_the_tensor_core_path():
    """The shape rule of ``conv_unit``: every released config runs its (B, T, C)
    units at multiples of 64; debug's C = 16 keeps the SIMT kernel."""
    for name in ("0k75bps", "1k5bps", "1kbps", "3kbps"):
        nc = get_config(name).network_config
        wide = [c for c in (*nc.encoder_dims, *nc.decoder_dims) if c > NARROW_MAX_C]
        assert wide and all(c % cu.TC_MULTIPLE == 0 for c in wide), (name, wide)
    assert get_config("debug").network_config.encoder_dims[-1] % cu.TC_MULTIPLE != 0


def _assert_prepared_from(p, w):
    """p holds, bit for bit, the split of pw1_w (pw1_w.t() in K-major layout)
    and of fold_grn's W2' transposed, and fold_grn's b2'."""
    w2f, b2f = cu.fold_grn(w)
    assert torch.equal(p.b2, b2f)
    w1_hi, w1_lo = split_tf32(w.pw1_w)
    w2_hi, w2_lo = split_tf32(w2f.t().contiguous())
    for got, want in ((p.w1_hi, w1_hi), (p.w1_lo, w1_lo), (p.w2_hi, w2_hi), (p.w2_lo, w2_lo)):
        assert got.is_contiguous() and torch.equal(got, want)


def test_prepared_weights_are_fold_grn_and_split_bit_for_bit():
    with torch.no_grad():
        w = _unit(64).kernel_weights()
        p = cu.prepared_weights(w)
        _assert_prepared_from(p, w)
        assert cu.prepared_weights(w) is p                      # cached


def test_prepared_weights_follow_load_state_dict():
    unit = _unit(64)
    with torch.no_grad():
        p = cu.prepared_weights(unit.kernel_weights())
        other = ConvUnit(64, use_norm=True)
        other.init_weights(torch.Generator().manual_seed(9))
        unit.load_state_dict(other.state_dict())
        w = unit.kernel_weights()
        q = cu.prepared_weights(w)
        assert q is not p
        _assert_prepared_from(q, w)


def test_prepared_weights_follow_an_in_place_update():
    unit = _unit(64)
    with torch.no_grad():
        p = cu.prepared_weights(unit.kernel_weights())
        unit.pw2.weight.mul_(2.0)
        w = unit.kernel_weights()
        q = cu.prepared_weights(w)
        assert q is not p
        _assert_prepared_from(q, w)


def test_prepared_weights_follow_quantize_params():
    """After quantize_params the unit's weights are the dequantized int8 ones,
    and the prepared operands are built from those."""
    holder = torch.nn.Module()
    holder.unit = _unit(64)
    with torch.no_grad():
        p = cu.prepared_weights(holder.unit.kernel_weights())
        quantize_params(holder)
        w = holder.unit.kernel_weights()
        q = cu.prepared_weights(w)
        assert q is not p and not torch.equal(q.w1_hi, p.w1_hi)
        _assert_prepared_from(q, w)


def test_prepared_weights_leave_the_weights_picklable_and_go_with_them():
    import gc
    import pickle
    unit = _unit(64)
    with torch.no_grad():
        cu.prepared_weights(unit.kernel_weights())
    slot = id(unit.pw1.weight)
    assert slot in cu._PREPARED
    pickle.loads(pickle.dumps(unit))
    del unit
    gc.collect()
    assert slot not in cu._PREPARED


def test_tc_variants_tool_needs_the_card():
    """tools/tc_variants.py times kernels only: without CUDA it exits with a
    message and builds nothing."""
    from l3ac_tpu_torch.tools import tc_variants
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tc_variants.main([])
    assert tc_variants.SOURCE.exists() and len(tc_variants.INT8) == 3 and len(tc_variants.FP32) == 2
