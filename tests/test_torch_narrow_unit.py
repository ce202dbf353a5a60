"""The arithmetic of the narrow ConvUnit kernel (``csrc/conv_unit_narrow.cu``)
and of the stage probe's product modes (``csrc/conv_unit_stages.cu``), modelled
in PyTorch on the CPU.

- The narrow unit: depthwise conv and ChannelNorm in fp32, then both products
  as the kernel sums them (``tc_gemm.gemm_emulated``: 3 TF32 passes with
  ``tf32_rna`` splits, mma steps that add in fp32 toward zero, a fresh
  accumulator per K step of 32; K zero-filled to steps of 8), GRN folded into
  pw2. Held against the unit in float64 (exact GRN): within 3x the error of
  the fp32 plain unit, at C = 8, 12, 24, 48, 96, dilations 1, 3, 9, snake and
  GELU (the split's own error per product, ~2^-21, shows beside fp32's at
  the shortest sums, K = 8 and 12: up to 2.5x there, 0.6-1.7x from C = 24
  on); and against the JAX package's jnp unit on (B, C, T).
- The probe: its products as one bf16 mma pass (m16n8k16: 16 exact products
  per step, added toward zero; a fresh accumulator per K step of 32), held
  against ``conv_unit_stages_plain`` within the probe's bf16 tolerance.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from l3ac_tpu.models import layers as jl
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.ops import channel_norm, gelu, snake
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import conv_unit_stages as cs
from l3ac_tpu_torch.ops.kernels.tc_gemm import K_STEP, _add_rz, gemm_emulated

TOL = 1e-4           # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
STAGE_TOL = 2.0 ** -6


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, C, snake_act):
    return cu.ConvUnitWeights(
        _t(rng, (C, 1, 7), 0.4), _t(rng, (C,), 0.1), 1.0 + _t(rng, (C,), 0.1),
        _t(rng, (C,), 0.1), _t(rng, (4 * C, C), C ** -0.5), _t(rng, (4 * C,), 0.1),
        (1.0 + _t(rng, (4 * C,), 0.2).abs()) if snake_act else None,
        _t(rng, (4 * C,), 0.3), _t(rng, (4 * C,), 0.1),
        _t(rng, (C, 4 * C), (4 * C) ** -0.5), _t(rng, (C,), 0.1))


def narrow_unit_emulated(x: torch.Tensor, w: cu.ConvUnitWeights, dilation: int) -> torch.Tensor:
    """conv_unit_narrow.cu's sums on x (B, C, T): time is the M axis of both
    products; pw2 walks the hidden units in chunks of 32, each one K step."""
    B, C, T = x.shape
    k = w.dw_w.shape[-1]
    y = F.conv1d(x, w.dw_w, w.dw_b, padding=(k - 1) * dilation // 2, dilation=dilation, groups=C)
    if w.norm_w is not None:
        y = channel_norm(y, w.norm_w, w.norm_b, dim=1)
    a = y.transpose(1, 2).reshape(B * T, C)
    h = gemm_emulated(a, w.pw1_w) + w.pw1_b
    h = snake(h, w.alpha) if w.alpha is not None else gelu(h)
    w2f, b2f = cu.fold_grn(w)   # gemm_emulated splits W2' as prepare_weights does
    out = gemm_emulated(h, w2f.t().contiguous()) + b2f
    return x + out.reshape(B, T, C).transpose(1, 2)


def _float64(w: cu.ConvUnitWeights) -> cu.ConvUnitWeights:
    return cu.ConvUnitWeights(*(None if t is None else t.double() for t in w))


@pytest.mark.parametrize("snake_act", [True, False])
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("C", [8, 12, 24, 48, 96])
def test_narrow_unit_sums_are_as_accurate_as_fp32(C, dilation, snake_act):
    rng = np.random.default_rng([C, dilation, snake_act])
    w = _weights(rng, C, snake_act)
    x = _t(rng, (2, C, 70))
    with torch.no_grad():
        exact = cu.conv_unit_plain(x.double(), _float64(w), channel_dim=1, dilation=dilation)
        got = narrow_unit_emulated(x, w, dilation)
        plain = cu.conv_unit_plain(x, w, channel_dim=1, dilation=dilation)
    e_model = (got.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    assert e_model <= 3 * e_plain, (e_model, e_plain)
    assert e_model <= TOL * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize("C,use_norm,dilation", [(24, True, 1), (48, False, 9)])
def test_narrow_unit_model_matches_jax(C, use_norm, dilation):
    """The JAX package's jnp unit on (B, C, T) (``residual_conv_unit_apply_t``'s
    unfused body), the same weights: the fold and the split stay within fp32
    rounding of the exact GRN."""
    import jax
    rng = np.random.default_rng(C)
    jp = jl.init_conv_unit(jax.random.PRNGKey(C), C, snake_act=True, use_norm=use_norm)
    jp["dw"]["w"] = jp["dw"]["w"] * 20.0
    jp["grn"]["gamma"] = jnp.asarray(rng.standard_normal(4 * C).astype(np.float32) * 0.3)
    jp["grn"]["beta"] = jnp.asarray(rng.standard_normal(4 * C).astype(np.float32) * 0.1)
    jp["alpha"] = jnp.asarray(np.abs(rng.standard_normal(4 * C)).astype(np.float32) * 0.3 + 0.7)
    x = _t(rng, (2, C, 60))
    want = np.asarray(x.numpy() + jl.conv_unit_apply_t(jp, jnp.asarray(x.numpy()),
                                                       dilation=dilation))
    unit = ConvUnit(C, use_norm=use_norm)
    unit.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in weights.convert_subtree(jp).items()})
    with torch.no_grad():
        got = narrow_unit_emulated(x, unit.kernel_weights(), dilation).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def gemm_bf16_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (N, K).T of bf16-valued fp32 operands as one bf16 mma
    pass: each m16n8k16 step adds 16 exact products toward zero, each K step
    of 32 into a fresh accumulator added to the fp32 total."""
    total = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], K_STEP):
        acc = torch.zeros_like(total)
        for k in range(k0, min(a.shape[1], k0 + K_STEP), 16):
            acc = _add_rz(acc, a[:, k:k + 16].double() @ b[:, k:k + 16].double().T)
        total = total + acc
    return total


def stages_products_emulated(x, dww, w1t, w2t, tile, mode):
    """conv_unit_stages.cu's product modes: the chain to the products as the
    plain version has it (fp32), then both products as one bf16 pass."""
    B, C, T = x.shape
    acc = x.float()
    if mode in ("dw_mm", "full"):
        acc = cs._depthwise(acc, dww, tile, halo=mode == "full")
    if mode == "full":
        u = acc.mean(1, keepdim=True)
        acc = (acc - u) / torch.sqrt(((acc - u) ** 2).mean(1, keepdim=True) + cs.NORM_EPS)
    a = acc.transpose(1, 2).reshape(B * T, C).bfloat16().float()
    h = gemm_bf16_emulated(a, w1t.float())
    if mode == "full":
        h = h + torch.sin(h) ** 2
    y = gemm_bf16_emulated(h.bfloat16().float(), w2t.float())
    return (acc + y.reshape(B, T, C).transpose(1, 2)).bfloat16()


@pytest.mark.parametrize("mode", ["mm", "dw_mm", "full"])
@pytest.mark.parametrize("C", [24, 48, 96])
def test_stage_products_as_one_bf16_pass_match_the_plain_probe(C, mode):
    rng = np.random.default_rng([C, len(mode)])
    x = _t(rng, (1, C, 256)).bfloat16()
    dww, w1t, w2t = (_t(rng, (C, 7)).bfloat16(), (_t(rng, (4 * C, C)) * 0.05).bfloat16(),
                     (_t(rng, (C, 4 * C)) * 0.05).bfloat16())
    want = cs.conv_unit_stages_plain(x, dww, w1t, w2t, 128, mode).float()
    got = stages_products_emulated(x, dww, w1t, w2t, 128, mode).float()
    assert (got - want).abs().max().item() <= STAGE_TOL * max(1.0, want.abs().max().item())
    assert (got == want).float().mean().item() >= 0.99


def test_narrow_variants_tool_applies_to_the_kernel_and_needs_the_card():
    """tools/narrow_variants.py builds its variants by text substitution on
    csrc/conv_unit_narrow.cu: every substitution matches the kernel's source
    exactly once; without CUDA the tool exits with a message, building
    nothing."""
    from l3ac_tpu_torch.tools import narrow_variants as nv
    sources = {nv.variant_source(subs) for _, subs, _ in nv.VARIANTS}
    assert len(sources) == len(nv.VARIANTS)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        nv.main([])
