"""CUDA kernels against their plain versions on the card, at small shapes and
with the options the 1kbps paths do not take (no ChannelNorm, GELU,
dilation, narrow debug widths, ragged tiles, no bias, upsample rate 4), at
the decoder's wide conv_unit widths (C = 256, 512), int8_matmul at ragged M, K
and N, and the two bf16 probe kernels (interleave in both layouts and store
strategies; conv_unit_stages in all seven modes, bit-equal where the chain
has no sum over channels). Needs a CUDA device;
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
    (256, 101, 1, True, True, True),
    (512, 77, 1, True, True, True),
    (200, 40, 3, False, False, True),
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


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("scale", [2, 3, 4, 5])
def test_up_fused_kernel(dev, channels_last, scale):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    rng = np.random.default_rng(scale)
    Ci, Co, T = (256, 96, 150) if channels_last else (48, 24, 333)
    w = uf.UpWeights(_t(rng, (Co, Ci), Ci ** -0.5, dev), _t(rng, (Co,), 0.3, dev),
                     1.0 + _t(rng, (Co,), 0.2, dev), _t(rng, (Co,), 0.2, dev))
    x = _t(rng, (2, T, Ci) if channels_last else (2, Ci, T), 1.0, dev)
    cd = 2 if channels_last else 1
    if channels_last:
        _check(uf.up_fused(x, w, scale=scale), uf.up_fused_plain(x, w, scale=scale, channel_dim=cd))
    else:
        _check(uf.up_fused_ct(x, w, scale=scale),
               uf.up_fused_plain(x, w, scale=scale, channel_dim=cd))
        got = uf.up_fused_ct(x, w, scale=scale, phase_split=True)
        want = uf.up_fused_plain(x, w, scale=scale, channel_dim=cd, phase_split=True)
        _check(torch.stack(got), torch.stack(want))


def test_up_fused_kernel_without_norm_at_scale_one(dev):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    rng = np.random.default_rng(1)
    w = uf.UpWeights(_t(rng, (12, 16), 0.25, dev), _t(rng, (12,), 0.3, dev), None, None)
    x = _t(rng, (2, 16, 70), 1.0, dev)
    _check(uf.up_fused_ct(x, w, scale=1), uf.up_fused_plain(x, w, scale=1, channel_dim=1))


@pytest.mark.parametrize("C,T", [(24, 2000), (24, 51), (8, 1500)])
@pytest.mark.parametrize("poly", [True, False])
def test_legacy_tail_kernel(dev, C, T, poly):
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    rng = np.random.default_rng(C + T)
    pos = lambda shape: 1.0 + _t(rng, shape, 0.3, dev).abs()
    w = lt.TailWeights(pos((3, C)), _t(rng, (3, C, C, 7), 0.1, dev), _t(rng, (3, C), 0.1, dev),
                       pos((3, C)), _t(rng, (3, C, C), 0.1, dev), _t(rng, (3, C), 0.1, dev),
                       pos((C,)), _t(rng, (1, C, 7), 0.1, dev), _t(rng, (1,), 0.05, dev))
    x = _t(rng, (2, C, T - T % 2 if poly else T), 1.0, dev)
    want = lt.legacy_tail_plain(x, w)
    if poly:
        got = lt.legacy_tail_poly_ct(x[..., 0::2].contiguous(), x[..., 1::2].contiguous(), w)
    else:
        got = lt.legacy_tail_ct(x, w)
    _check(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    q = torch.zeros(1, 2, 32, 64, device=dev)
    with pytest.raises(ValueError, match="D <= 32"):
        la.local_attention(q, q, q, window_size=16)
    q = torch.zeros(1, 2, 30, 32, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        la.local_attention(q, q, q, window_size=16)
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w = uf.UpWeights(torch.zeros(6, 8, device=dev), torch.zeros(6, device=dev), None, None)
    with pytest.raises(ValueError, match="multiple of 4"):
        uf.up_fused_ct(torch.zeros(1, 8, 10, device=dev), w, scale=2)
    tw = lt.TailWeights(*(torch.zeros(s, device=dev) for s in
                          ((3, 20), (3, 20, 20, 7), (3, 20), (3, 20), (3, 20, 20), (3, 20),
                           (20,), (1, 20, 7), (1,))))
    with pytest.raises(ValueError, match="C in"):
        lt.legacy_tail_ct(torch.zeros(1, 20, 10, device=dev), tw)


@pytest.mark.parametrize("M,K,N,bias", [(1, 1, 1, True), (5, 64, 32, True), (300, 341, 128, False),
                                         (129, 128, 682, True), (333, 2048, 65, True),
                                         (1000, 100, 1000, False)])
def test_int8_matmul_kernel(dev, M, K, N, bias):
    from l3ac_tpu_torch.ops.kernels import int8_matmul as im
    from l3ac_tpu_torch.ops.quantized import quantize_weight
    rng = np.random.default_rng(M + K + N)
    w_q, scale = quantize_weight(_t(rng, (N, K), K ** -0.5, dev))
    b = _t(rng, (N,), 0.3, dev) if bias else None
    x = _t(rng, (2, M, K), 1.0, dev)
    _check(im.int8_matmul(x, w_q, scale, b), im.int8_matmul_plain(x, w_q, scale, b))


def test_int8_matmul_rejects_what_the_kernel_does_not_take(dev):
    from l3ac_tpu_torch.ops.kernels import int8_matmul as im
    from l3ac_tpu_torch.ops.quantized import quantize_weight
    w_q, scale = quantize_weight(torch.ones(8, 16, device=dev))
    x = torch.ones(4, 16, device=dev)
    with pytest.raises(TypeError, match="A6"):
        im.int8_matmul(x.bfloat16(), w_q, scale)
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul(torch.ones(4, 32, device=dev)[:, ::2], w_q, scale)
    with pytest.raises(ValueError, match="cuda"):
        im.int8_matmul(x, w_q.cpu(), scale)
    with pytest.raises(ValueError, match="on cpu"):
        im.int8_matmul(x, w_q, scale.cpu())
    with pytest.raises(TypeError, match="int8"):
        im.int8_matmul(x, w_q.float(), scale)
    with pytest.raises(ValueError, match="do not match"):
        im.int8_matmul(torch.ones(4, 15, device=dev), w_q, scale)


def test_debug_decode_matches_cpu(dev):
    """Every decode kernel on the debug path (and the interleaved tail with a
    last rate of 3) against the CPU plain path."""
    from l3ac_tpu_torch.models.zoo import get_model
    from l3ac_tpu_torch.ops import kernels as K
    idx = np.random.default_rng(1).integers(0, 125, (2, 30)).astype(np.int32)
    for net, tail in (({}, "legacy_tail_poly_ct"), ({"decode_rates": [2, 2, 3]}, "legacy_tail_ct")):
        gpu = get_model("debug", device=dev, seed=4, network_config=net)
        cpu = get_model("debug", device="cpu", seed=4, network_config=net)
        K.reset_launches()
        a_g = gpu.decode_audio(indices=idx)
        assert K.LAUNCHES[tail] == 1 and K.LAUNCHES["up_fused_ct"] > 0, K.LAUNCHES
        assert (a_g.cpu() - cpu.decode_audio(indices=idx)).abs().max().item() <= 1e-3


def test_debug_encode_matches_cpu(dev):
    from l3ac_tpu_torch.models.zoo import get_model
    from l3ac_tpu_torch.ops import kernels as K
    gpu = get_model("debug", device=dev, seed=3)
    cpu = get_model("debug", device="cpu", seed=3)
    audio = (np.random.default_rng(0).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    K.reset_launches()
    q_g, i_g = gpu.encode_audio(audio)
    encode = ("first_block", "conv_unit_ct", "conv_unit", "local_attention")
    assert all(K.LAUNCHES[k] > 0 for k in encode), K.LAUNCHES
    q_c, i_c = cpu.encode_audio(audio)
    assert (i_g.cpu() == i_c).float().mean().item() >= 0.999


def _bf16(rng, shape, std, dev):
    return _t(rng, shape, std, dev).bfloat16()


@pytest.mark.parametrize("shape,s", [((2, 24, 333), 2), ((1, 8, 100), 3), ((2, 5, 77), 4),
                                     ((1, 16, 40), 8), ((3, 1, 9), 1)])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_interleave_kernel_is_bit_equal(dev, shape, s, channels_last, packed):
    from l3ac_tpu_torch.ops.kernels import interleave as il
    x = _bf16(np.random.default_rng(s), shape, 1.0, dev)
    got = il.interleave(x, s, channels_last=channels_last, packed=packed)
    torch.cuda.synchronize()
    want = il.interleave_plain(x, s, channels_last=channels_last)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


STAGE_TOL = 2.0 ** -6  # max abs error <= STAGE_TOL * max(1, max |plain|): ~2 bf16 ulps


@pytest.mark.parametrize("B,C,T,tile", [(2, 24, 512, 128), (1, 48, 300, 100), (2, 96, 256, 64),
                                        (1, 5, 96, 96), (1, 192, 130, 65)])
def test_conv_unit_stages_kernel(dev, B, C, T, tile):
    from l3ac_tpu_torch.ops.kernels import conv_unit_stages as cs
    rng = np.random.default_rng(C + T)
    x = _bf16(rng, (B, C, T), 1.0, dev)
    w = (_bf16(rng, (C, 7), 1.0, dev), _bf16(rng, (4 * C, C), 0.05, dev),
         _bf16(rng, (C, 4 * C), 0.05, dev))
    for mode in cs.MODES:
        got = cs.conv_unit_stages(x, *w, tile, mode)
        torch.cuda.synchronize()
        want = cs.conv_unit_stages_plain(x, *w, tile, mode)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        if mode in ("copy", "halo_only", "dw"):
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), mode
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= STAGE_TOL * max(1.0, want.float().abs().max().item()), (mode, err)


def test_probe_kernels_reject_what_they_do_not_take(dev):
    from l3ac_tpu_torch.ops.kernels import conv_unit_stages as cs
    from l3ac_tpu_torch.ops.kernels import interleave as il
    x = torch.zeros(1, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        il.interleave(x.float(), 2)
    w = (torch.zeros(8, 7, device=dev, dtype=torch.bfloat16),
         torch.zeros(32, 8, device=dev, dtype=torch.bfloat16),
         torch.zeros(8, 32, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        cs.conv_unit_stages(x.float(), *w, 32, "dw")
    with pytest.raises(TypeError, match="bfloat16"):
        cs.conv_unit_stages(x, w[0].float(), *w[1:], 32, "dw")
    with pytest.raises(ValueError, match="multiple of tile"):
        cs.conv_unit_stages(x, *w, 48, "full")
    with pytest.raises(ValueError, match="contiguous"):
        cs.conv_unit_stages(torch.zeros(1, 8, 128, device=dev, dtype=torch.bfloat16)[..., ::2],
                            *w, 32, "copy")
