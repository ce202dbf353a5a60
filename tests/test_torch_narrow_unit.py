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
- The bf16 narrow unit (``csrc/conv_unit_narrow_bf16.cu``): its operands read
  back from ``narrow_pack``'s buffer the way each lane reads its fragments,
  and its arithmetic in order (the taps from the bias by fma, the moments in
  the quad-shuffle order, the norm's and the snake's Newton quotients,
  ``sin2_ilp``, both products with one fp32 accumulator across K), held
  against ``conv_unit_plain_bf16`` at the debug widths and the 1kbps ones,
  dilations 1, 3, 9, snake and GELU, and against the JAX package's Pallas
  ``conv_unit_ct`` in interpret mode on bf16 inputs.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from l3ac_tpu.models import layers as jl
from l3ac_tpu.ops.pallas import conv_unit as pk_cu
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.ops import channel_norm, gelu, snake
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import conv_unit_stages as cs
from l3ac_tpu_torch.ops.kernels.gemm_sm90 import _fma32, newton_quotient, sin2_ilp
from l3ac_tpu_torch.ops.kernels.tc_gemm import K_STEP, _add_rz, gemm_emulated
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_bf16_emulated as gemm_one_acc
from _torch_threads import one_thread  # noqa: F401

TOL = 1e-4           # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
STAGE_TOL = 2.0 ** -6
BF16_TOL = 2.0 ** -6  # chip_smoke.py's bf16 kernels: within 2^-6 x max(1, max |plain|)


pytestmark = pytest.mark.usefixtures("one_thread")


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
    csrc/conv_unit_narrow.cu and (``--bf16``) csrc/conv_unit_narrow_bf16.cu:
    every substitution matches its kernel's source exactly once, and each
    variant differs from the others; without CUDA the tool exits with a
    message in both modes, building nothing."""
    from l3ac_tpu_torch.tools import narrow_variants as nv
    sources = {nv.variant_source(subs) for _, subs, _ in nv.VARIANTS}
    assert len(sources) == len(nv.VARIANTS)
    sources = {nv.variant_source(subs, bf16=True) for _, subs, _ in nv.VARIANTS_BF16}
    assert len(sources) == len(nv.VARIANTS_BF16)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for argv in ([], ["--bf16"]):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            nv.main(argv)


def _unpack_narrow(p: cu.PreparedBf16) -> tuple:
    """W1 (H, Cp), W2' (Cp, H) bf16, the hidden vectors (H, 4) and the fp32
    vectors (K + 4, Cp), read from ``p.narrow`` as the kernel reads them: lane
    4 g + t's 16 bytes at (pair, k16 step) hold B[k][n] of the mma fragments,
    b0 = (k 2t, 2t + 1) and b1 = (k 2t + 8, 2t + 9) of column n = g, for two
    n8 tiles."""
    C, K = p.dw.shape
    kP, steps = cu.narrow_shape(C)
    Cp, H = 16 * kP, cu.NARROW_STEP * steps
    buf = p.narrow
    n1 = 2 * steps * kP * 32 * 8
    frags = buf[:4 * n1].view(torch.bfloat16).view(2, 2 * steps, kP, 32, 8)
    i = torch.arange(8)
    lane = torch.arange(32)[:, None]
    g, t = lane // 4, lane % 4
    n_in = 8 * (i // 4) + g                     # (32, 8): column n of a pair's 16
    k_in = 8 * ((i // 2) % 2) + 2 * t + i % 2   # row k of a k16 step's 16
    w1 = torch.zeros(H, Cp, dtype=torch.bfloat16)
    w2 = torch.zeros(Cp, H, dtype=torch.bfloat16)
    for a in range(2 * steps):
        for b in range(kP):
            # W1: pair a of n8 tiles at k16 step b; W2': k16 step a, pair b
            w1[16 * a + n_in, 16 * b + k_in] = frags[0, a, b]
            w2[16 * b + n_in, 16 * a + k_in] = frags[1, a, b]
    rest = buf[4 * n1:].view(torch.float32)
    return w1, w2, rest[:4 * H].view(H, 4), rest[4 * H:].view(K + 4, Cp)


def narrow_bf16_emulated(x: torch.Tensor, p: cu.PreparedBf16, dilation: int) -> torch.Tensor:
    """conv_unit_narrow_bf16.cu on bf16 x (B, C, T): the depthwise taps
    fused-multiply-added in order from the bias in fp32; ChannelNorm's
    sums per lane (channels 16 ks + 8 h + 2 t + e, in that loop order) then
    across the quad by xor-shuffles 1 and 2, its divisions by the Newton
    quotient on sd's reciprocal; pw1 and pw2 with one fp32 accumulator
    across K (``tc_gemm.gemm_bf16_emulated``); b1, then the snake by
    ``sin_ilp`` and the quotient on the prepared alpha + eps and its
    reciprocal (or the exact GELU), rounded to bf16; out = bf16(x + (y +
    b2'))."""
    w1, w2, hv, cv = _unpack_narrow(p)
    B, C, T = x.shape
    K = p.dw.shape[-1]
    kP = cu.narrow_shape(C)[0]
    halo = (K - 1) * dilation // 2
    xp = F.pad(x.float(), (halo, halo))
    v = cv[K, :C][None, :, None].expand(B, C, T).clone()
    for k in range(K):
        v = _fma32(xp[..., k * dilation:k * dilation + T], cv[k, :C][None, :, None], v)
    if p.norm_w is not None:
        vp = F.pad(v, (0, 0, 0, 0)).new_zeros(B, 16 * kP, T)
        vp[:, :C] = v
        lanes = vp.view(B, kP, 2, 4, 2, T)                  # (B, ks, h, t, e, T)
        part = torch.zeros(B, 4, T)
        for ks in range(kP):
            for h in range(2):
                for e in range(2):
                    part = part + lanes[:, ks, h, :, e]
        s = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
        u = (s / C)[:, None]
        dv = torch.where(torch.arange(16 * kP)[None, :, None] < C, vp - u, torch.zeros(()))
        lanes = dv.view(B, kP, 2, 4, 2, T)
        part = torch.zeros(B, 4, T)
        for ks in range(kP):
            for h in range(2):
                for e in range(2):
                    part = _fma32(lanes[:, ks, h, :, e], lanes[:, ks, h, :, e], part)
        d2 = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
        sd = torch.sqrt(d2 / C + 1e-8)[:, None]
        v = _fma32(newton_quotient(v - u, sd.expand_as(v)), cv[K + 1, :C][None, :, None],
                   cv[K + 2, :C][None, :, None])
    a = F.pad(v.transpose(1, 2).reshape(B * T, C), (0, 16 * kP - C)).bfloat16()
    h = gemm_one_acc(a, w1) + hv[:, 0]
    if p.alpha is not None:
        h = h + newton_quotient(sin2_ilp(hv[:, 1] * h), hv[:, 2].expand_as(h))
    else:
        h = gelu(h)
    y = gemm_one_acc(h.bfloat16(), w2)[:, :C] + cv[K + 3, :C]
    return (x.float() + y.view(B, T, C).transpose(1, 2)).bfloat16()


def _bf16_unit(rng, C, snake_act, norm=True):
    w = _weights(rng, C, snake_act)
    if not norm:
        w = w._replace(norm_w=None, norm_b=None)
    return cu.ConvUnitWeights(*(None if t is None else t.bfloat16() for t in w))


def _assert_bf16_close(got, want, share=0.99):
    """chip_smoke.py's rule for a bf16 kernel; at least ``share`` bit-equal."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * max(1.0, want.float().abs().max().item()), err
    assert (got == want).float().mean().item() >= share


@pytest.mark.parametrize("snake_act", [True, False])
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("C", [8, 12, 16, 24, 48, 96])
def test_narrow_bf16_sums_match_the_plain_unit(C, dilation, snake_act):
    """The kernel's arithmetic against ``conv_unit_plain_bf16`` (norm at
    every width but C = 12, where the unit runs without)."""
    rng = np.random.default_rng([C, dilation, snake_act, 16])
    w = _bf16_unit(rng, C, snake_act, norm=C != 12)
    x = _t(rng, (2, C, 45)).bfloat16()
    p = cu.prepare_bf16(w)
    with torch.no_grad():
        _assert_bf16_close(narrow_bf16_emulated(x, p, dilation),
                           cu.conv_unit_plain_bf16(x, w, channel_dim=1, dilation=dilation))


@pytest.mark.parametrize("C,dilation,snake_act", [(8, 1, True), (12, 3, False), (16, 9, True)])
def test_narrow_bf16_sums_match_the_pallas_kernel(C, dilation, snake_act):
    """The JAX package's Pallas ``conv_unit_ct`` in interpret mode on bf16
    x and bf16 parameters (its norm by rsqrt, its b2' rounded to bf16: not
    the port's roundings, so the bf16 tolerance), the same weights."""
    import jax
    rng = np.random.default_rng([C, dilation, 17])
    jp = jl.init_conv_unit(jax.random.PRNGKey(C), C, snake_act=snake_act, use_norm=True)
    jp["dw"]["w"] = jp["dw"]["w"] * 20.0
    jp["grn"]["gamma"] = jnp.asarray(rng.standard_normal(4 * C).astype(np.float32) * 0.3)
    jp["grn"]["beta"] = jnp.asarray(rng.standard_normal(4 * C).astype(np.float32) * 0.1)
    if snake_act:
        jp["alpha"] = jnp.asarray(np.abs(rng.standard_normal(4 * C)).astype(np.float32) * 0.3 + 0.7)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    x = _t(rng, (2, C, 300)).bfloat16()
    want = np.asarray(pk_cu.conv_unit_ct(jnp.asarray(x.float().numpy(), jnp.bfloat16), jp,
                                         dilation=dilation, interpret=True).astype(jnp.float32))
    unit = ConvUnit(C, use_norm=True, snake_act=snake_act)
    unit.load_state_dict({k: torch.from_numpy(np.array(v.astype(jnp.float32)))
                          for k, v in weights.convert_subtree(jp).items()})
    unit = unit.to(torch.bfloat16)
    with torch.no_grad():
        got = narrow_bf16_emulated(x, cu.prepare_bf16(unit.kernel_weights()), dilation)
    _assert_bf16_close(got, torch.from_numpy(np.array(want)).bfloat16(), share=0.9)


def test_narrow_pack_holds_the_weights_in_fragment_order():
    """``narrow_pack`` at C = 12 (K zero-filled to 16, 48 hidden units to 64):
    read back as the kernel reads it, the products, the hidden vectors (b1,
    alpha, alpha + eps, its fp32 reciprocal) and the fp32 vectors are the
    prepared weights, zero (or the neutral snake) past C and 4C."""
    rng = np.random.default_rng(21)
    C, H = 12, 64
    p = cu.prepare_bf16(_bf16_unit(rng, C, True))
    assert p.narrow.dtype == torch.uint8 and p.narrow.shape == (cu.narrow_packed_bytes(C, 7),)
    w1, w2, hv, cv = _unpack_narrow(p)
    assert torch.equal(w1[:4 * C, :C], p.w1) and not w1[4 * C:].any() and not w1[:, C:].any()
    assert torch.equal(w2[:C, :4 * C], p.w2) and not w2[C:].any() and not w2[:, 4 * C:].any()
    d = p.alpha + 1e-8
    assert torch.equal(hv[:4 * C], torch.stack([p.b1, p.alpha, d, 1.0 / d], 1))
    assert torch.equal(hv[4 * C:, 0], torch.zeros(H - 4 * C)) and (hv[4 * C:, 1] == 1).all()
    assert torch.equal(cv[:7, :C], p.dw.t()) and torch.equal(cv[7, :C], p.dw_b)
    assert torch.equal(cv[8, :C], p.norm_w) and torch.equal(cv[9, :C], p.norm_b)
    assert torch.equal(cv[10, :C], p.b2) and not cv[:, C:].any()
    assert cu.prepare_bf16(_bf16_unit(rng, 128, True)).narrow is None   # past NARROW_MAX_C
