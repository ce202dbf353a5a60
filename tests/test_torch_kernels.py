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

from l3ac_tpu.models import layers as jl
from l3ac_tpu.models import tconv as jt
from l3ac_tpu.ops import attention as jattn
from l3ac_tpu.ops.pallas import conv_unit as pk_cu
from l3ac_tpu.ops.pallas import first_block as pk_fb
from l3ac_tpu.ops.pallas import local_attention as pk_attn
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.models.tconv import FirstBlock
from l3ac_tpu_torch.ops import channel_norm, snake
from l3ac_tpu_torch.ops import kernels as K
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import local_attention as la

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
    assert K.LAUNCHES == before


def test_wrappers_take_fp32_only():
    unit = ConvUnit(8)
    with pytest.raises(TypeError, match="float32"):
        cu.conv_unit_ct(torch.zeros(1, 8, 16, dtype=torch.bfloat16), unit.kernel_weights())
    with pytest.raises(TypeError, match="float32"):
        fb.first_block(torch.zeros(1, 16, dtype=torch.bfloat16),
                       FirstBlock(8).kernel_weights())
    q = torch.zeros(1, 1, 16, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        la.local_attention(q, q, q, window_size=16)
