"""The port's plain ops (l3ac_tpu_torch.ops) against their JAX twins on the CPU.

Inputs come from seeded numpy and go to both packages. Tolerances are fp32
(rtol 1e-5, atol 1e-6) unless a test says why it needs more.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l3ac_tpu import ops as jops
from l3ac_tpu.ops import attention as jattn
from l3ac_tpu.ops import fsq as jfsq
from l3ac_tpu_torch import ops as tops
from l3ac_tpu_torch.ops import attention as tattn
from l3ac_tpu_torch.ops import fsq as tfsq

RNG = np.random.default_rng(21)


def _np(shape, std=1.0):
    return (RNG.standard_normal(shape) * std).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_activations():
    x, a = _np((2, 50, 8)), np.abs(_np((8,))) + 0.5
    t = torch.from_numpy
    _close(tops.snake(t(x), t(a)), jops.snake(jnp.asarray(x), jnp.asarray(a)))
    _close(tops.gelu(t(x)), jops.gelu(jnp.asarray(x)))
    _close(tops.geglu(t(x)), jops.geglu(jnp.asarray(x)))
    _close(tops.silu(t(x)), jops.silu(jnp.asarray(x)))


@pytest.mark.parametrize("k,dil,groups", [(7, 1, 1), (7, 3, 8), (3, 1, 1), (1, 1, 1)])
def test_conv1d(k, dil, groups):
    B, T, C, Co = 2, 40, 8, 8
    x, w, b = _np((B, T, C)), _np((k, C // groups, Co), 0.3), _np((Co,))
    pad = (k - 1) * dil // 2
    want = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), padding=pad,
                       dilation=dil, groups=groups)
    got = tops.conv1d(torch.from_numpy(x).transpose(1, 2),
                      torch.from_numpy(w.transpose(2, 1, 0).copy()), torch.from_numpy(b),
                      padding=pad, dilation=dil, groups=groups)
    _close(got.transpose(1, 2), want, atol=1e-5)


@pytest.mark.parametrize("channels_last", [False, True])
def test_conv1d_strided_matmul(channels_last):
    B, T, C, Co, K = 2, 60, 12, 16, 5
    x, w, b = _np((B, T, C)), _np((K, C, Co), 0.3), _np((Co,))
    want = jops.conv1d_strided_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x) if channels_last else torch.from_numpy(x).transpose(1, 2)
    got = tops.conv1d_strided_matmul(xt, torch.from_numpy(w.transpose(2, 1, 0).copy()),
                                     torch.from_numpy(b), channels_last=channels_last)
    _close(got if channels_last else got.transpose(1, 2), want, atol=1e-5)


def test_linear():
    """The port's dense layers are ``nn.Linear`` modules holding the JAX weight
    transposed, as ``weights.from_jax_params`` loads it."""
    x, w, b = _np((2, 9, 16)), _np((16, 24)), _np((24,))
    want = jops.conv.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    lin = torch.nn.Linear(16, 24)
    lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        _close(lin(torch.from_numpy(x)), want, atol=1e-5)


@pytest.mark.parametrize("dim", [-1, 1])
def test_norms(dim):
    x, g, b = _np((2, 30, 16), 3.0) + 1.0, _np((16,)) + 1.0, _np((16,))
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x) if dim == -1 else torch.from_numpy(x).transpose(1, 2)
    back = (lambda y: y) if dim == -1 else (lambda y: y.transpose(1, 2))
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)
    _close(back(tops.channel_norm(tx, tg, tb, dim=dim)),
           jops.channel_norm(jx, jnp.asarray(g), jnp.asarray(b)), atol=1e-5)
    _close(back(tops.grn(tx, tg, tb, dim=dim)),
           jops.grn(jx, jnp.asarray(g), jnp.asarray(b)), atol=1e-5)
    if dim == -1:
        _close(tops.layer_norm(tx, tg, tb),
               jops.layer_norm(jx, jnp.asarray(g), jnp.asarray(b)), atol=1e-5)


@pytest.mark.parametrize("k", [1, 5, 45])
def test_trend_pool(k):
    """torch pads (max -inf, avg 0 and / k); same summation order as JAX."""
    x = _np((2, 100, 3))
    want = jops.trend_pool(jnp.asarray(x), k)
    got = tops.trend_pool(torch.from_numpy(x).transpose(1, 2), k).transpose(1, 2)
    _close(got, want, rtol=0, atol=0)


def test_fsq_matches_jax():
    z = _np((3, 20, 6), 1.5)
    levels = (7, 7, 7, 7, 7, 7)
    jq, ji, jl = jfsq.quantize(jnp.asarray(z), levels)
    tq, ti, tl = tfsq.quantize(torch.from_numpy(z), levels)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tq, jq, rtol=0, atol=0)
    assert ti.dtype == torch.int32


def test_fsq_exact_ties_round_half_to_even():
    """z = 0 squashes to exactly 0.5; with L - 1 odd, 0.5 * (L - 1) is a tie
    (1.5, 2.5, 3.5), which both packages round to even (2, 2, 4)."""
    levels = (4, 6, 8)
    z = np.zeros((1, 3), np.float32)
    _, ji, jl = jfsq.quantize(jnp.asarray(z), levels)
    _, ti, tl = tfsq.quantize(torch.from_numpy(z), levels)
    assert tfsq.pre_round(torch.from_numpy(z), levels).tolist() == [[1.5, 2.5, 3.5]]
    assert tl.tolist() == [[2, 2, 4]] == np.asarray(jl).tolist()
    assert ti.tolist() == np.asarray(ji).tolist() == [2 + 2 * 4 + 4 * 24]


def _dyn_params(dim, heads):
    d = dim // 2
    jp = {"w0": _np((1, d)), "b0": _np((d,), 0.5), "w1": _np((d, d), d ** -0.5),
          "b1": _np((d,), 0.1), "w2": _np((d, heads), d ** -0.5), "b2": _np((heads,), 0.1)}
    tp = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v) for k, v in jp.items()}
    return {k: jnp.asarray(v) for k, v in jp.items()}, tp


@pytest.mark.parametrize("n", [16, 250])
def test_dynamic_position_bias(n):
    jp, tp = _dyn_params(32, 6)
    want = jattn.dynamic_position_bias(jp, n)
    got = tattn.dynamic_position_bias(tp, n)
    assert got.shape == (6, n, 2 * n)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_local_attention_plain(with_bias):
    B, H, T, D, n = 2, 3, 48, 16, 16
    q, k, v = _np((B, H, T, D)), _np((B, H, T, D)), _np((B, H, T, D))
    bias = _np((H, n, 2 * n)) if with_bias else None
    want = jattn.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 window_size=n,
                                 bias=None if bias is None else jnp.asarray(bias))
    got = tattn.local_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                window_size=n,
                                bias=None if bias is None else torch.from_numpy(bias))
    _close(got, want, rtol=1e-4, atol=1e-5)


def test_base_block_matches_jax():
    """BaseBlock with dilated branches (the EnhanceBlock geometry)."""
    import jax
    from l3ac_tpu.models import tconv as jt
    from l3ac_tpu_torch.models.tconv import BaseBlock
    jp = jt.init_base_block(jax.random.PRNGKey(1), 4)
    x = _np((2, 200, 1))
    want = jt.base_block_apply(jp, jnp.asarray(x))
    m = BaseBlock(4)
    with torch.no_grad():
        for br, p in zip(m.branches, jp["branches"]):
            br.weight.copy_(torch.from_numpy(np.asarray(p["w"]).transpose(2, 1, 0).copy()))
            br.bias.copy_(torch.from_numpy(np.array(p["b"])))
        got = m(torch.from_numpy(x).transpose(1, 2))
    _close(got.transpose(1, 2), want, atol=1e-6)


@pytest.mark.parametrize("scale", [2, 3, 5])
@pytest.mark.parametrize("channels_last", [True, False])
def test_upsample_linear(scale, channels_last):
    """torch's align_corners=False rule: the edge frame repeats at both
    edges. Same blend formula as JAX, so equal to fp32 rounding."""
    from l3ac_tpu.ops import transposed as jtx
    x = _np((2, 17, 6), 2.0)
    if channels_last:
        want = np.asarray(jops.upsample_linear(jnp.asarray(x), scale))
        got = tops.upsample_linear(torch.from_numpy(x), scale, dim=1)
    else:
        xt = np.ascontiguousarray(x.transpose(0, 2, 1))
        want = np.asarray(jtx.upsample_linear_t(jnp.asarray(xt), scale))
        got = tops.upsample_linear(torch.from_numpy(xt), scale, dim=2)
    _close(got, want, rtol=0, atol=1e-6)
    t_axis = 1 if channels_last else 2
    first = np.take(want, range(scale // 2), axis=t_axis)
    edge = np.take(x if channels_last else x.transpose(0, 2, 1), [0], axis=t_axis)
    np.testing.assert_allclose(first, np.broadcast_to(edge, first.shape), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [-1, 1])
def test_instance_norm(dim):
    """Over time per channel, eps 1e-5 inside the sqrt."""
    from l3ac_tpu.ops import transposed as jtx
    x, g, b = _np((2, 40, 4), 3.0) + 2.0, _np((4,)) + 1.0, _np((4,))
    if dim == -1:
        want = jops.instance_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
        got = tops.instance_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    else:
        xt = np.ascontiguousarray(x.transpose(0, 2, 1))
        want = jtx.instance_norm_t(jnp.asarray(xt), jnp.asarray(g), jnp.asarray(b))
        got = tops.instance_norm(torch.from_numpy(xt), torch.from_numpy(g),
                                 torch.from_numpy(b), dim=1)
    _close(got, want, atol=1e-5)


def test_indices_to_codes_whole_range():
    """Every index of the 7^6 codebook unpacks to JAX's level indices and
    codes exactly; 0 and 7^6 - 1 are the all -1 and all +1 codes."""
    levels = (7, 7, 7, 7, 7, 7)
    idx = np.arange(7 ** 6, dtype=np.int32).reshape(7 ** 3, 7 ** 3)
    want_li = np.asarray(jfsq.indices_to_level_indices(jnp.asarray(idx), levels))
    want = np.asarray(jfsq.indices_to_codes(jnp.asarray(idx), levels))
    got_li = tfsq.indices_to_level_indices(torch.from_numpy(idx), levels)
    got = tfsq.indices_to_codes(torch.from_numpy(idx), levels)
    np.testing.assert_array_equal(got_li.numpy(), want_li)
    np.testing.assert_array_equal(got.numpy(), want)
    ends = tfsq.indices_to_codes(torch.tensor([0, 7 ** 6 - 1]), levels)
    assert ends.tolist() == [[-1.0] * 6, [1.0] * 6]
    # unpack inverts the pack of quantize
    _, packed, li = tfsq.quantize(torch.from_numpy(_np((50, 6), 2.0)), levels)
    np.testing.assert_array_equal(tfsq.indices_to_level_indices(packed, levels).numpy(),
                                  li.numpy())
