"""CUDA kernels against their plain versions on the card, at small shapes and
with the options the 1kbps encode path does not take (no ChannelNorm, GELU,
dilation, narrow debug widths, ragged tiles, no bias). Needs a CUDA device;
skips without one. This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 1e-4  # max abs error <= TOL * max(1, max |plain|), as in chip_smoke.py


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _t(rng, shape, std, dev):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)


def _check(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("C,T,dilation,norm,snake,channels_last", [
    (8, 157, 1, True, True, False),
    (12, 64, 3, False, True, False),
    (16, 1, 1, True, False, False),
    (100, 333, 1, False, False, True),
    (192, 70, 9, True, True, True),
    (16, 200, 1, True, True, True),
])
def test_conv_unit_kernel(dev, C, T, dilation, norm, snake, channels_last):
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(C + T)
    w = cu.ConvUnitWeights(
        _t(rng, (C, 1, 7), 0.4, dev), _t(rng, (C,), 0.1, dev),
        (1.0 + _t(rng, (C,), 0.1, dev)) if norm else None,
        _t(rng, (C,), 0.1, dev) if norm else None,
        _t(rng, (4 * C, C), C ** -0.5, dev), _t(rng, (4 * C,), 0.1, dev),
        (1.0 + _t(rng, (4 * C,), 0.2, dev).abs()) if snake else None,
        _t(rng, (4 * C,), 0.1, dev), _t(rng, (4 * C,), 0.1, dev),
        _t(rng, (C, 4 * C), (4 * C) ** -0.5, dev), _t(rng, (C,), 0.1, dev))
    x = _t(rng, (2, T, C) if channels_last else (2, C, T), 1.0, dev)
    fn = cu.conv_unit if channels_last else cu.conv_unit_ct
    _check(fn(x, w, dilation=dilation),
           cu.conv_unit_plain(x, w, channel_dim=2 if channels_last else 1,
                              dilation=dilation))


@pytest.mark.parametrize("T,Cout", [(1, 8), (30, 8), (300, 24), (777, 64)])
def test_first_block_kernel(dev, T, Cout):
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    rng = np.random.default_rng(T)
    w = fb.FirstBlockWeights(_t(rng, (5, 4, 7), 0.4, dev), _t(rng, (5, 4), 0.1, dev),
                             _t(rng, (80, 20), 20 ** -0.5, dev), _t(rng, (80,), 0.1, dev),
                             _t(rng, (Cout, 81), 81 ** -0.5, dev), _t(rng, (Cout,), 0.1, dev))
    x = _t(rng, (3, T), 0.5, dev)
    _check(fb.first_block(x, w), fb.first_block_plain(x, w))


@pytest.mark.parametrize("n,W,D,with_bias", [(16, 3, 32, True), (64, 2, 32, False),
                                              (100, 1, 32, True), (65, 4, 8, True)])
def test_local_attention_kernel(dev, n, W, D, with_bias):
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    rng = np.random.default_rng(n * W)
    B, H = 2, 3
    q, k, v = (_t(rng, (B, H, n * W, D), 1.0, dev) for _ in range(3))
    bias = _t(rng, (H, n, 2 * n), 1.0, dev) if with_bias else None
    _check(la.local_attention(q, k, v, window_size=n, bias=bias),
           la.local_attention_plain(q, k, v, window_size=n, bias=bias))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    q = torch.zeros(1, 2, 32, 64, device=dev)
    with pytest.raises(ValueError, match="D <= 32"):
        la.local_attention(q, q, q, window_size=16)
    q = torch.zeros(1, 2, 30, 32, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        la.local_attention(q, q, q, window_size=16)


def test_debug_encode_matches_cpu(dev):
    from l3ac_tpu_torch.models.zoo import get_model
    from l3ac_tpu_torch.ops import kernels as K
    gpu = get_model("debug", device=dev, seed=3)
    cpu = get_model("debug", device="cpu", seed=3)
    audio = (np.random.default_rng(0).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    K.reset_launches()
    q_g, i_g = gpu.encode_audio(audio)
    assert all(K.LAUNCHES[k] > 0 for k in K.LAUNCHES), K.LAUNCHES
    q_c, i_c = cpu.encode_audio(audio)
    assert (i_g.cpu() == i_c).float().mean().item() >= 0.999
