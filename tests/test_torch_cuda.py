"""CUDA kernels against their plain versions on the card, at small shapes and
with the options the 1kbps paths do not take (the stem with T across its
tiles, below its halo and 1, Cout 1-64, B 1-8, weights x50 and from
FirstBlock's prepared weights; local_attention with the full
bias and with the table, on contiguous operands and on strided head views,
n = 750 at B = 1, D = 8 and 32; the tail at C = 8, 12, 16, 24 with T across
its tiles; no ChannelNorm, GELU,
dilation, narrow debug widths, ragged tiles, no bias, upsample rate 4), the
up paths on both kernels (the tensor-core one at 512 -> 256 and 256 -> 96,
the streaming one at every narrow and debug width, scales 1-5, T across
their tiles, phase_split, the route rule and its raise), at
the wide conv_unit widths on the tensor-core path (C = 192, 256, 512 at
dilations 1, 3, 9) and its shape rule, conv_unit_ct on the narrow
tensor-core kernel at every width up to 96 (ragged T, edge columns,
dilations 1, 3, 9, both activations) and its shape rule, an int8 1kbps
roundtrip of a model built under inference mode, int8_matmul at ragged M, K
and N, and the two bf16 probe kernels (interleave in both layouts and store
strategies; conv_unit_stages in all seven modes, at small shapes and at the
probe's own, bit-equal where the chain has no sum over channels); the bf16
variants of the four encode kernels against their bf16 plain versions
(within 2^-6 x max(1, max |plain|); the narrow one also at C = 96,
dilation 9, and on x that is not 16-byte aligned), the widths of ROADMAP C3 against the
fp32 plain versions (head dim 64 and 128, stem Cout up to 256, conv_unit C
768 and 1024, tail C 4-64, the tensor-core up path at any Co up to 512, the
streaming one at (B, C, T) Co up to 128), the prepared-weight caches of a
model moved to bf16; the bf16 variants of the decode kernels (both up
paths, the tail in both input modes, int8_matmul) against their bf16 plain
versions at the released and at ragged shapes, each launching its bf16
kernel on bf16 input (launch counts and output dtype), and a bf16 debug
decode and bf16 int8 roundtrip against the CPU; the bf16 attention
(``local_attention_bf16.cu``) at n = 16, 64, 100, 250, 750, one and three
windows, D = 8-128, the table, the full bias and none, on its TMA and its
cp.async route (the route counted), and the bf16 (B, C, T) up path
(``up_fused_bf16.cu``) at the 1kbps widths on either side of its warp tile
and on x at a storage offset that is no multiple of 8. Needs a
CUDA device; skips without one. This file imports no JAX, so it runs on a
machine without it:

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


def _unit_weights(rng, C, norm, snake, dev):
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    return cu.ConvUnitWeights(
        _t(rng, (C, 1, 7), 0.4, dev), _t(rng, (C,), 0.1, dev),
        (1.0 + _t(rng, (C,), 0.1, dev)) if norm else None,
        _t(rng, (C,), 0.1, dev) if norm else None,
        _t(rng, (4 * C, C), C ** -0.5, dev), _t(rng, (4 * C,), 0.1, dev),
        (1.0 + _t(rng, (4 * C,), 0.2, dev).abs()) if snake else None,
        _t(rng, (4 * C,), 0.1, dev), _t(rng, (4 * C,), 0.1, dev),
        _t(rng, (C, 4 * C), (4 * C) ** -0.5, dev), _t(rng, (C,), 0.1, dev))


@pytest.mark.parametrize("norm,snake", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("C", [192, 256, 512])
def test_conv_unit_tensor_core_path(dev, C, dilation, norm, snake):
    """The wide units on conv_unit_tc.cu; B T = 2 x 203 rows is no multiple of
    the 128-row tile, and T is shorter than the dilated kernel's reach at
    d = 9 only at the edges."""
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(C + dilation)
    w = _unit_weights(rng, C, norm, snake, dev)
    x = _t(rng, (2, 203, C), 1.0, dev)
    _check(cu.conv_unit(x, w, dilation=dilation),
           cu.conv_unit_plain(x, w, channel_dim=2, dilation=dilation))


def test_conv_unit_dispatch_is_a_shape_rule(dev, monkeypatch):
    """C % 64 == 0 takes the tensor-core path, any other C the general route;
    one count per call either way, and a refused path raises."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(7)

    def refuse(*a, **k):
        raise RuntimeError("refused")

    w16, x16 = _unit_weights(rng, 16, True, True, dev), _t(rng, (2, 50, 16), 1.0, dev)
    w64, x64 = _unit_weights(rng, 64, True, True, dev), _t(rng, (2, 50, 64), 1.0, dev)
    before = K.LAUNCHES["conv_unit"]
    with monkeypatch.context() as m:
        m.setattr(cu, "_launch_tc", refuse)
        _check(cu.conv_unit(x16, w16), cu.conv_unit_plain(x16, w16, channel_dim=2))
        with pytest.raises(RuntimeError, match="refused"):
            cu.conv_unit(x64, w64)
    with monkeypatch.context() as m:
        m.setattr(cu, "_launch_general", refuse)
        _check(cu.conv_unit(x64, w64), cu.conv_unit_plain(x64, w64, channel_dim=2))
    assert K.LAUNCHES["conv_unit"] == before + 2


def test_conv_unit_tensor_core_path_rejects_a_strided_input(dev):
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    w = _unit_weights(np.random.default_rng(8), 192, True, True, dev)
    with pytest.raises(ValueError, match="contiguous"):
        cu.conv_unit(torch.zeros(2, 100, 192, device=dev)[:, ::2], w)


def test_conv_unit_reuses_prepared_weights_until_they_change(dev):
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(9)
    w = _unit_weights(rng, 64, True, True, dev)
    x = _t(rng, (1, 40, 64), 1.0, dev)
    cu.conv_unit(x, w)
    p = cu.prepared_weights(w)
    cu.conv_unit(x, w)
    assert cu.prepared_weights(w) is p
    w.pw2_w.mul_(2.0)
    _check(cu.conv_unit(x, w), cu.conv_unit_plain(x, w, channel_dim=2))
    assert cu.prepared_weights(w) is not p


@pytest.mark.parametrize("C,T,dilation,norm,snake", [
    (8, 1, 1, True, True), (8, 77, 3, True, False), (12, 301, 9, False, True),
    (16, 77, 1, True, True), (24, 1, 9, True, True), (24, 301, 1, True, True),
    (24, 4096, 3, True, False), (48, 77, 9, True, True), (48, 1000, 1, False, True),
    (96, 1, 3, True, True), (96, 301, 1, True, True), (96, 2053, 9, True, False),
    (5, 130, 1, True, True), (44, 64, 3, False, False), (90, 129, 1, True, True)])
def test_conv_unit_ct_narrow_kernel(dev, C, T, dilation, norm, snake):
    """conv_unit_narrow.cu against the plain unit: ragged T (one column, 77,
    301, one past a tile), the 50 edge columns on their own (where the halo
    rule acts), C not a multiple of 8 or 16."""
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(C * T + dilation)
    w = _unit_weights(rng, C, norm, snake, dev)
    x = _t(rng, (3, C, T), 1.0, dev)
    got = cu.conv_unit_ct(x, w, dilation=dilation)
    want = cu.conv_unit_plain(x, w, channel_dim=1, dilation=dilation)
    _check(got, want)
    n = min(50, T)
    _check(torch.cat([got[..., :n], got[..., -n:]], -1), torch.cat([want[..., :n], want[..., -n:]], -1))


def test_conv_unit_ct_runs_only_the_narrow_kernel(dev, monkeypatch):
    """conv_unit_ct at C <= NARROW_MAX_C never reaches the general route: with
    its launch refused it still runs, with the narrow one refused it raises;
    one count per call; C above NARROW_MAX_C runs conv_unit's rule on the
    transposed x (C = 100: the general route; it raised before ROADMAP C3
    closed), and a unit's prepared operands are passed through."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(11)

    def refuse(*a, **k):
        raise RuntimeError("refused")

    w, x = _unit_weights(rng, 24, True, True, dev), _t(rng, (2, 24, 300), 1.0, dev)
    before = K.LAUNCHES["conv_unit_ct"]
    with monkeypatch.context() as m:
        m.setattr(cu, "_launch_general", refuse)
        _check(cu.conv_unit_ct(x, w), cu.conv_unit_plain(x, w, channel_dim=1))
        p = cu.prepare_weights(w)
        no_products = w._replace(pw1_w=None, pw2_w=None)
        _check(cu.conv_unit_ct(x, no_products, prepared=lambda: p),
               cu.conv_unit_plain(x, w, channel_dim=1))
    with monkeypatch.context() as m:
        m.setattr(cu, "_launch_narrow", refuse)
        with pytest.raises(RuntimeError, match="refused"):
            cu.conv_unit_ct(x, w)
    assert K.LAUNCHES["conv_unit_ct"] == before + 2
    w100 = _unit_weights(rng, 100, True, True, dev)
    x100 = _t(rng, (1, 100, 40), 1.0, dev)
    routes = dict(cu.ROUTES)
    _check(cu.conv_unit_ct(x100, w100), cu.conv_unit_plain(x100, w100, channel_dim=1))
    assert cu.ROUTES["channels_last"] == routes["channels_last"] + 1
    with pytest.raises(ValueError, match="contiguous"):
        cu.conv_unit_ct(torch.zeros(2, 24, 600, device=dev)[..., ::2], w)


def test_int8_1kbps_roundtrip_built_under_inference_mode(dev):
    """The released config built inside torch.inference_mode() (ordinary
    weights all the same), quantized, and run: the narrow units take their
    operands prepared once from the int8 buffers, reused by the next
    request; the card agrees with the CPU on the same int8 weights."""
    from l3ac_tpu_torch.models.layers import ConvUnit
    from l3ac_tpu_torch.models.zoo import get_model
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.quantized import Int8Linear, quantize_params
    with torch.inference_mode():
        gpu = get_model("1kbps", device=dev, seed=2)
    assert not any(t.is_inference() for t in gpu.codec.parameters())
    quantize_params(gpu.codec)
    cpu = get_model("1kbps", device="cpu", seed=2)
    quantize_params(cpu.codec)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.codec.state_dict().items()})
    audio = (np.random.default_rng(5).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    K.reset_launches()
    a_g = gpu.roundtrip(audio)
    torch.cuda.synchronize()
    assert K.LAUNCHES["conv_unit_ct"] == 6 and K.LAUNCHES["int8_matmul"] > 0, K.LAUNCHES
    narrow = [u for u in gpu.codec.modules()
              if isinstance(u, ConvUnit) and isinstance(u.pw1, Int8Linear) and u.pw1.in_features <= 96]
    assert narrow and all(u.prepared() is u.prepared() for u in narrow)
    assert (a_g.cpu() - cpu.roundtrip(audio)).abs().max().item() <= 1e-3


FB_TILE = 128  # csrc/first_block.cu: output columns per tile


def _stem_weights(rng, Cout, dev, scale=1.0):
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    return fb.FirstBlockWeights(
        _t(rng, (5, 4, 7), 0.4 * scale, dev), _t(rng, (5, 4), 0.1 * scale, dev),
        _t(rng, (80, 20), 20 ** -0.5 * scale, dev), _t(rng, (80,), 0.1 * scale, dev),
        _t(rng, (Cout, 81), 81 ** -0.5 * scale, dev), _t(rng, (Cout,), 0.1 * scale, dev))


@pytest.mark.parametrize("B,T,Cout", [
    (3, 1, 8), (3, 30, 8), (3, 300, 24), (3, 777, 64),
    (1, FB_TILE - 1, 24), (8, FB_TILE, 24), (1, FB_TILE + 1, 8), (8, 2 * FB_TILE + 47, 64),
    (8, 1, 24), (1, 2 * FB_TILE + 47, 12), (2, 1000, 1), (1, 5000, 33)])
def test_first_block_kernel(dev, B, T, Cout):
    """T across the kernel's tiles (one short of a tile, one, one past it,
    two and a halo), below the 47-sample halo and 1; Cout 1-64, padded to
    n8 tiles; the first and last three columns on their own."""
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    rng = np.random.default_rng([B, T, Cout])
    w = _stem_weights(rng, Cout, dev)
    x = _t(rng, (B, T), 0.5, dev)
    got, want = fb.first_block(x, w), fb.first_block_plain(x, w)
    _check(got, want)
    edges = lambda y: torch.cat([y[..., :3], y[..., -3:]], -1)
    _check(edges(got), edges(want))


def test_first_block_kernel_at_large_weights_and_from_a_module(dev):
    """Weights x50 (outputs of hundreds, where the edge columns matter), and
    FirstBlock's forward on its prepared weights: one launch, the pack
    built once."""
    from l3ac_tpu_torch.models.tconv import FirstBlock
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    rng = np.random.default_rng(50)
    w = _stem_weights(rng, 24, dev, scale=50.0)
    x = _t(rng, (2, 3 * FB_TILE + 5), 0.5, dev)
    _check(fb.first_block(x, w), fb.first_block_plain(x, w))
    stem = FirstBlock(24, device=dev)
    stem.init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():
        p = stem.prepared()
        K.reset_launches()
        got = stem(x)
        assert K.LAUNCHES["first_block"] == 1 and stem.prepared() is p
        _check(got, fb.first_block_plain(x, stem.kernel_weights()))


def test_first_block_kernel_raises_on_cout_above_64(dev):
    """Above 64 channels the kernel walks 64-channel tiles (65 runs), at any
    Cout (ROADMAP C3: 257 and 600 run where the kernel raised above 256);
    weight shapes that do not match raise."""
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    x = _t(np.random.default_rng(1), (1, 300), 0.3, dev)
    for cout in (65, 257, 600):
        w = _stem_weights(np.random.default_rng(0), cout, dev)
        _check(fb.first_block(x, w), fb.first_block_plain(x, w))
    with pytest.raises(ValueError, match="weight shapes"):
        fb.first_block(x, w._replace(b2=w.b2[:-1]))


@pytest.mark.parametrize("n,W,D,bias,strided,B,H", [
    (16, 3, 32, "full", False, 2, 3), (64, 2, 32, None, False, 2, 3),
    (100, 1, 32, "full", False, 2, 3), (65, 4, 8, "full", False, 2, 3),
    (16, 3, 32, "table", True, 2, 3), (65, 4, 8, "table", True, 2, 3),
    (100, 2, 8, "full", True, 2, 3), (250, 2, 32, "table", False, 2, 6),
    (750, 3, 32, "table", True, 1, 6), (750, 2, 32, "full", True, 1, 2)])
def test_local_attention_kernel(dev, n, W, D, bias, strided, B, H):
    """The full bias and the (2n, H) table; contiguous operands and the
    model's strided head views of one (B, T, 3 H D) projection."""
    from l3ac_tpu_torch.ops.attention import expand_position_table
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    rng = np.random.default_rng(n * W + D)
    T = n * W
    if strided:
        qkv = _t(rng, (B, T, 3 * H * D), 1.0, dev)
        q, k, v = (c.view(B, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (_t(rng, (B, H, T, D), 1.0, dev) for _ in range(3))
    table = _t(rng, (2 * n, H), 1.0, dev) if bias == "table" else None
    full = _t(rng, (H, n, 2 * n), 1.0, dev) if bias == "full" else None
    want = la.local_attention_plain(q, k, v, window_size=n,
                                    bias=full if table is None else expand_position_table(table))
    got = la.local_attention(q, k, v, window_size=n, bias=full, bias_table=table)
    assert got.shape == (B, H, T, D) and got.permute(0, 2, 1, 3).is_contiguous()
    _check(got, want)


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


def _up_case(dev, Ci, Co, T, channels_last, norm=True, B=2, seed=0):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    rng = np.random.default_rng([Ci, Co, T, seed])
    w = uf.UpWeights(_t(rng, (Co, Ci), Ci ** -0.5, dev), _t(rng, (Co,), 0.3, dev),
                     (1.0 + _t(rng, (Co,), 0.2, dev)) if norm else None,
                     _t(rng, (Co,), 0.2, dev) if norm else None)
    return w, _t(rng, (B, T, Ci) if channels_last else (B, Ci, T), 1.0, dev)


def _up_check(got, want, edges=8):
    """The whole output, then its first and last ``edges`` columns along time
    (the last axis) on their own, where the clamp acts."""
    _check(got, want)
    _check(torch.cat([got[..., :edges], got[..., -edges:]], -1),
           torch.cat([want[..., :edges], want[..., -edges:]], -1))


@pytest.mark.parametrize("T", [1, 63, 65, 150, 1779])
@pytest.mark.parametrize("scale", [3, 4, 5])
@pytest.mark.parametrize("Ci,Co", [(512, 256), (256, 96)])
def test_up_fused_tensor_core_kernel_at_the_real_widths(dev, Ci, Co, scale, T):
    """(B, T, C) at the 1kbps / 0k75bps / 3kbps wide widths on
    csrc/up_fused_tc.cu; T = 63 and 65 sit on either side of its 62-row
    tile, 1779 is the 1kbps stage-0 length."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _up_case(dev, Ci, Co, T, True)
    before = uf.ROUTES["tc"]
    got = uf.up_fused(x, w, scale=scale)
    assert uf.ROUTES["tc"] == before + 1
    _up_check(got.transpose(1, 2), uf.up_fused_plain(x, w, scale=scale, channel_dim=2)
              .transpose(1, 2))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("T", [1, 63, 65, 150, 1779])
@pytest.mark.parametrize("Ci,Co,scale", [(96, 48, 3), (48, 24, 2), (96, 48, 4)])
def test_up_fused_ct_streaming_kernel_at_the_real_widths(dev, Ci, Co, scale, T, split):
    """(B, C, T) at the narrow widths on csrc/up_fused.cu, interleaved and
    phase_split; odd T, so no output row starts 16-byte aligned."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _up_case(dev, Ci, Co, T, False)
    before = uf.ROUTES["stream"]
    got = uf.up_fused_ct(x, w, scale=scale, phase_split=split)
    want = uf.up_fused_plain(x, w, scale=scale, channel_dim=1, phase_split=split)
    assert uf.ROUTES["stream"] == before + 1
    if split:
        assert len(got) == scale
        got, want = torch.stack(got), torch.stack(want)
    _up_check(got, want)


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("Ci,Co", [(16, 12), (12, 8), (8, 8), (24, 24), (48, 48)])
def test_up_fused_ct_streaming_kernel_at_the_debug_widths(dev, Ci, Co, scale):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _up_case(dev, Ci, Co, 300, False)     # T % 4 == 0: 16-byte input copies
    _up_check(uf.up_fused_ct(x, w, scale=scale),
              uf.up_fused_plain(x, w, scale=scale, channel_dim=1))
    got = uf.up_fused_ct(x, w, scale=scale, phase_split=True)
    _up_check(torch.stack(got), torch.stack(uf.up_fused_plain(x, w, scale=scale, channel_dim=1,
                                                              phase_split=True)))


@pytest.mark.parametrize("channels_last", [True, False])
def test_up_fused_without_norm_at_scale_one_on_both_kernels(dev, channels_last):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    Ci, Co = (256, 96) if channels_last else (48, 24)
    w, x = _up_case(dev, Ci, Co, 150, channels_last, norm=False)
    fn = uf.up_fused if channels_last else uf.up_fused_ct
    _check(fn(x, w, scale=1), uf.up_fused_plain(x, w, scale=1, channel_dim=2 if channels_last
                                                 else 1))


def test_up_fused_route_is_a_shape_rule(dev):
    """(B, T, C) with Co a multiple of 32 takes the tensor-core kernel; other
    (B, T, C) shapes that the streaming kernel takes run there; (B, C, T)
    streams up to 128 channels; what neither takes runs the general route
    (it raised before ROADMAP C3 closed), one launch a call."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    for Ci, Co, cl, route in ((256, 96, True, "tc"), (100, 20, True, "stream"),
                              (96, 48, False, "stream"), (64, 32, False, "stream"),
                              (512, 100, True, "tc"), (256, 61, True, "tc")):
        w, x = _up_case(dev, Ci, Co, 70, cl)
        before = dict(uf.ROUTES)
        fn = uf.up_fused if cl else uf.up_fused_ct
        got = fn(x, w, scale=3)
        assert uf.ROUTES[route] == before[route] + 1 and sum(uf.ROUTES.values()) == \
            sum(before.values()) + 1, (Ci, Co, cl)
        _check(got, uf.up_fused_plain(x, w, scale=3, channel_dim=2 if cl else 1))
    K.reset_launches()
    before = uf.ROUTES["general"]
    for Ci, Co, cl in ((1100, 100, True), (256, 513, True), (96, 130, False), (200, 48, False)):
        w, x = _up_case(dev, Ci, Co, 20, cl)
        _check((uf.up_fused if cl else uf.up_fused_ct)(x, w, scale=2),
               uf.up_fused_plain(x, w, scale=2, channel_dim=2 if cl else 1))
    assert K.LAUNCHES["up_fused"] == K.LAUNCHES["up_fused_ct"] == 2
    assert uf.ROUTES["general"] == before + 4


def test_up_fused_reuses_prepared_weights_until_they_change(dev):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _up_case(dev, 256, 96, 70, True)
    p = uf.prepared_up(w)
    got = uf.up_fused(x, w, scale=3)
    assert uf.prepared_up(w) is p and "tc" in p
    w.w.mul_(2.0)
    assert uf.prepared_up(w) is not p
    _check(uf.up_fused(x, w, scale=3), uf.up_fused_plain(x, w, scale=3, channel_dim=2))
    assert not torch.equal(got, uf.up_fused(x, w, scale=3))


@pytest.mark.parametrize("C,T", [(24, 2000), (24, 51), (8, 1500), (12, 1369), (16, 700)])
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
    """What no kernel takes raises (T off the window grid, both biases, a
    non-contiguous head dim); the widths and views the fast kernels do not
    take (D = 132, unaligned rows, an up path to 136, a tail of 22) run the
    general route, where they raised before ROADMAP C3 closed."""
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    rng = np.random.default_rng(5)
    general = la.ROUTES["general"]
    q = _t(rng, (1, 2, 32, 132), 1.0, dev)
    _check(la.local_attention(q, q, q, window_size=16),
           la.local_attention_plain(q, q, q, window_size=16))
    q = torch.zeros(1, 2, 30, 32, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        la.local_attention(q, q, q, window_size=16)
    q = _t(rng, (1, 2, 32, 32), 1.0, dev)
    odd_stride = _t(rng, (1, 2, 32, 33), 1.0, dev)[..., 1:]
    _check(la.local_attention(odd_stride, q, q, window_size=16),
           la.local_attention_plain(odd_stride, q, q, window_size=16))
    shifted = _t(rng, (2 * 32 * 32 + 1,), 1.0, dev)[1:].view(1, 2, 32, 32)
    _check(la.local_attention(q, shifted, q, window_size=16),
           la.local_attention_plain(q, shifted, q, window_size=16))
    assert la.ROUTES["general"] == general + 3
    with pytest.raises(ValueError, match="not contiguous"):
        la.local_attention(q.transpose(2, 3), q, q, window_size=16)
    with pytest.raises(ValueError, match="not both"):
        la.local_attention(q, q, q, window_size=16, bias=torch.zeros(2, 16, 32, device=dev),
                           bias_table=torch.zeros(32, 2, device=dev))
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w = uf.UpWeights(_t(rng, (136, 8), 0.3, dev), _t(rng, (136,), 0.1, dev), None, None)
    x = _t(rng, (1, 8, 10), 1.0, dev)
    _check(uf.up_fused_ct(x, w, scale=2), uf.up_fused_plain(x, w, scale=2, channel_dim=1))
    tw = lt.TailWeights(*(_t(rng, s, 0.1, dev) for s in
                          ((3, 22), (3, 22, 22, 7), (3, 22), (3, 22), (3, 22, 22), (3, 22),
                           (22,), (1, 22, 7), (1,))))
    x = _t(rng, (1, 22, 10), 1.0, dev)
    _check(lt.legacy_tail_ct(x, tw), lt.legacy_tail_plain(x, tw))


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


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("K,N", [(341, 128), (128, 682)])
@pytest.mark.parametrize("M", [1, 127, 18000])
def test_int8_matmul_tensor_core_ragged(dev, M, K, N, bias):
    """The GEGLU widths: K = 341 (fp32 rows of 1364 B, int8 rows of 341 B, no
    16-byte copies) and N = 682, at one row, a ragged tile and the window-750
    M of an 8 x 10 s request."""
    from l3ac_tpu_torch.ops.kernels import int8_matmul as im
    from l3ac_tpu_torch.ops.quantized import quantize_weight
    rng = np.random.default_rng(M + K + N)
    w_q, scale = quantize_weight(_t(rng, (N, K), K ** -0.5, dev))
    b = _t(rng, (N,), 0.3, dev) if bias else None
    x = _t(rng, (M, K), 1.0, dev)
    _check(im.int8_matmul(x, w_q, scale, b), im.int8_matmul_plain(x, w_q, scale, b))


def test_int8_matmul_rejects_what_the_kernel_does_not_take(dev):
    from l3ac_tpu_torch.ops.kernels import int8_matmul as im
    from l3ac_tpu_torch.ops.quantized import quantize_weight
    w_q, scale = quantize_weight(torch.ones(8, 16, device=dev))
    x = torch.ones(4, 16, device=dev)
    with pytest.raises(TypeError, match="float32, torch.bfloat16 only"):
        im.int8_matmul(x.half(), w_q, scale)
    with pytest.raises(TypeError, match="bfloat16"):       # the bias in x's dtype
        im.int8_matmul(x.bfloat16(), w_q, scale, torch.zeros(8, device=dev))
    # bf16 x launches the bf16 kernel (no cast to the fp32 one)
    from l3ac_tpu_torch.ops import kernels as K
    K.reset_launches()
    got = im.int8_matmul(x.bfloat16(), w_q, scale)
    assert got.dtype == torch.bfloat16 and K.LAUNCHES["int8_matmul"] == 1
    _check_bf16(got, im.int8_matmul_plain_bf16(x.bfloat16(), w_q, scale))
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


@pytest.mark.parametrize("B,C,T", [(8, 96, 26624), (8, 48, 79872), (8, 24, 159744)])
def test_conv_unit_stages_at_the_probe_shapes(dev, B, C, T):
    """The bisection's own shapes and tile (2048): the 16-byte paths."""
    from l3ac_tpu_torch.ops.kernels import conv_unit_stages as cs
    from l3ac_tpu_torch.tools import bisect_kernel as bk
    inp = bk.make(B, C, T, dev=dev)
    for mode in cs.MODES:
        got = cs.conv_unit_stages(*inp, 2048, mode)
        torch.cuda.synchronize()
        want = cs.conv_unit_stages_plain(*inp, 2048, mode)
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


# -- bf16 (the encode half of ROADMAP A6) and the widths of ROADMAP C3 --------

BF16_TOL = 2.0 ** -6  # bf16: max abs error <= BF16_TOL * max(1, max |plain|), as in chip_smoke.py


def _check_bf16(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * max(1.0, want.float().abs().max().item()), err


@pytest.fixture()
def bf16_products(dev):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


@pytest.mark.parametrize("Cout,B,T", [(24, 2, 5000), (24, 1, 30), (7, 3, 333), (128, 2, 700),
                                      (256, 1, 300)])
def test_first_block_bf16_kernel(bf16_products, Cout, B, T):
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    dev = bf16_products
    rng = np.random.default_rng(Cout + T)
    w = fb.FirstBlockWeights(*(_t(rng, s, std, dev).bfloat16() for s, std in (
        ((5, 4, 7), 0.4), ((5, 4), 0.1), ((80, 20), 20 ** -0.5), ((80,), 0.1),
        ((Cout, 81), 81 ** -0.5), ((Cout,), 0.1))))
    x = _t(rng, (B, T), 0.3, dev).bfloat16()
    _check_bf16(fb.first_block(x, w), fb.first_block_plain(x, w))


@pytest.mark.parametrize("C,T,channels_last,norm,snake", [
    (24, 1000, False, True, True), (8, 157, False, True, True), (96, 333, False, False, True),
    (12, 64, False, True, False), (48, 1, False, True, True),
    (64, 150, True, True, True), (192, 203, True, True, True), (256, 70, True, False, False),
    (16, 99, True, True, True), (40, 50, True, True, False),
])
def test_conv_unit_bf16_kernels(bf16_products, C, T, channels_last, norm, snake):
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    dev = bf16_products
    rng = np.random.default_rng(C + T)
    w = cu.ConvUnitWeights(*(None if t is None else t.bfloat16()
                             for t in _unit_weights(rng, C, norm, snake, dev)))
    x = _t(rng, (2, T, C) if channels_last else (2, C, T), 1.0, dev).bfloat16()
    fn = cu.conv_unit if channels_last else cu.conv_unit_ct
    cd = 2 if channels_last else 1
    _check_bf16(fn(x, w), cu.conv_unit_plain_bf16(x, w, channel_dim=cd))


@pytest.mark.parametrize("C,T,dilation,offset", [(96, 1000, 9, 0), (96, 333, 9, 3),
                                                 (24, 777, 3, 5), (8, 50, 1, 1)])
def test_conv_unit_ct_bf16_wide_halo_and_unaligned_x(bf16_products, C, T, dilation, offset):
    """The narrow bf16 kernel's two side branches. At C = 96 and dilation 9
    the halo (27 columns) is wider than the 24 that its two x stages leave
    room for beside the weights, so the outer taps read device memory. x at
    a storage offset that is no multiple of 8 elements is not 16-byte
    aligned, so x is staged and out stored element by element."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    dev = bf16_products
    rng = np.random.default_rng(C + T + offset)
    w = cu.ConvUnitWeights(*(t.bfloat16() for t in _unit_weights(rng, C, True, True, dev)))
    x = _t(rng, (offset + 2 * C * T,), 1.0, dev).bfloat16()[offset:].view(2, C, T)
    assert (x.data_ptr() % 16 == 0) == (offset % 8 == 0)
    before = K.LAUNCHES["conv_unit_ct"]
    got = cu.conv_unit_ct(x, w, dilation=dilation)
    assert K.LAUNCHES["conv_unit_ct"] == before + 1
    _check_bf16(got, cu.conv_unit_plain_bf16(x, w, channel_dim=1, dilation=dilation))


def test_conv_unit_bf16_raises_off_the_tensor_core_widths(bf16_products):
    """bf16 off the tensor-core widths (C = 12) runs the general route, where
    it raised before ROADMAP C3 closed; one launch."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    dev = bf16_products
    rng = np.random.default_rng(1)
    w = cu.ConvUnitWeights(*(t.bfloat16() for t in _unit_weights(rng, 12, True, True, dev)))
    K.reset_launches()
    general = cu.ROUTES["general"]
    x = _t(rng, (1, 20, 12), 1.0, dev).bfloat16()
    _check_bf16(cu.conv_unit(x, w), cu.conv_unit_plain_bf16(x, w, channel_dim=2))
    assert K.LAUNCHES["conv_unit"] == 1 and cu.ROUTES["general"] == general + 1


@pytest.mark.parametrize("D,n,bias", [(32, 250, "table"), (8, 16, "full"), (64, 64, "table"),
                                      (128, 40, "none"), (20, 16, "table")])
def test_local_attention_bf16_kernel(bf16_products, D, n, bias):
    from l3ac_tpu_torch.ops.attention import expand_position_table
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    dev = bf16_products
    rng = np.random.default_rng(D + n)
    H, T = 3, 3 * n
    qkv = _t(rng, (2, T, 3 * H * D), 1.0, dev).bfloat16()
    q, k, v = (c.view(2, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1))
    table = _t(rng, (2 * n, H), 1.0, dev).bfloat16()
    kw = {"table": {"bias_table": table}, "full": {"bias": expand_position_table(table)},
          "none": {}}[bias]
    _check_bf16(la.local_attention(q, k, v, window_size=n, **kw),
                la.local_attention_plain(q, k, v, window_size=n, **kw))


@pytest.mark.parametrize("n,W,D,bias,view", [
    (16, 3, 32, "table", "proj"), (64, 1, 32, "full", "proj"), (250, 3, 32, "table", "proj"),
    (750, 1, 32, "table", "proj"), (750, 3, 32, "none", "proj"), (100, 3, 32, "none", "proj"),
    (16, 1, 8, "full", "proj"), (64, 3, 20, "table", "proj"), (100, 1, 64, "full", "proj"),
    (250, 3, 128, "table", "proj"), (16, 3, 128, "none", "contig"), (100, 3, 32, "table", "proj+4"),
    (64, 1, 8, "full", "proj+4"), (250, 3, 64, "none", "proj+4"), (750, 1, 20, "table", "contig"),
    (64, 3, 16, "table", "proj"), (100, 2, 64, "table", "contig"),
    *[(n, 3 if n < 750 else 1, 48, bias, view) for n in (16, 250, 750)
      for bias in ("table", "full", "none") for view in ("proj", "proj+4")]])
def test_local_attention_bf16_routes(bf16_products, n, W, D, bias, view):
    """The bf16 kernel at n = 16, 64, 250, 750 and 100 (no multiple of 64),
    one to three windows, D = 8, 16, 20, 32, 64, 128, the table, the full bias
    and none, on the model's head views of one (B, T, 3 H D) projection, on
    that projection at a storage offset of 4 elements (8-byte aligned: the
    cp.async route) and on contiguous operands; the route counted where the
    strides and addresses put it, and the instantiation (columns of the
    padded head dim) that ``instance_for`` names."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.attention import expand_position_table
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    dev = bf16_products
    rng = np.random.default_rng([n, W, D])
    B, H, T = 2, 3, n * W
    if view == "contig":
        q, k, v = (_t(rng, (B, H, T, D), 1.0, dev).bfloat16() for _ in range(3))
    else:
        off = 4 if view == "proj+4" else 0
        buf = _t(rng, (off + B * T * 3 * H * D,), 1.0, dev).bfloat16()
        qkv = buf[off:].view(B, T, 3 * H * D)
        q, k, v = (c.view(B, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1))
    table = _t(rng, (2 * n, H), 1.0, dev).bfloat16()
    kw = {"table": {"bias_table": table}, "full": {"bias": expand_position_table(table)},
          "none": {}}[bias]
    expected = "tma" if view != "proj+4" and D % 8 == 0 else "cp_async"
    before, K.LAUNCHES["local_attention"] = dict(la.ROUTES), 0
    inst = dict(la.INSTANCES)
    got = la.local_attention(q, k, v, window_size=n, **kw)
    assert K.LAUNCHES["local_attention"] == 1
    assert {r: la.ROUTES[r] - before[r] for r in la.ROUTES} == \
        {r: int(r == expected) for r in la.ROUTES}
    assert {c: la.INSTANCES[c] - inst[c] for c in la.INSTANCES} == \
        {c: int(c == la.instance_for(D)) for c in la.INSTANCES}
    assert got.shape == (B, H, T, D) and got.permute(0, 2, 1, 3).is_contiguous()
    _check_bf16(got, la.local_attention_plain(q, k, v, window_size=n, **kw))


@pytest.mark.parametrize("D", [40, 64, 100, 128])
def test_local_attention_kernel_at_wide_heads(dev, D):
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    rng = np.random.default_rng(D)
    n, H, T = 48, 2, 144
    qkv = _t(rng, (2, T, 3 * H * D), 1.0, dev)
    q, k, v = (c.view(2, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1))
    table = _t(rng, (2 * n, H), 1.0, dev)
    _check(la.local_attention(q, k, v, window_size=n, bias_table=table),
           la.local_attention_plain(q, k, v, window_size=n, bias_table=table))


@pytest.mark.parametrize("Cout", [65, 128, 200, 256])
def test_first_block_kernel_above_64_channels(dev, Cout):
    from l3ac_tpu_torch.ops.kernels import first_block as fb
    rng = np.random.default_rng(Cout)
    w = fb.FirstBlockWeights(*(_t(rng, s, std, dev) for s, std in (
        ((5, 4, 7), 0.4), ((5, 4), 0.1), ((80, 20), 20 ** -0.5), ((80,), 0.1),
        ((Cout, 81), 81 ** -0.5), ((Cout,), 0.1))))
    x = _t(rng, (2, 1000), 0.3, dev)
    _check(fb.first_block(x, w), fb.first_block_plain(x, w))


@pytest.mark.parametrize("C", [640, 768, 1024])
def test_conv_unit_tensor_core_path_above_512(dev, C):
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = np.random.default_rng(C)
    w = _unit_weights(rng, C, True, True, dev)
    x = _t(rng, (2, 77, C), 1.0, dev)
    _check(cu.conv_unit(x, w), cu.conv_unit_plain(x, w, channel_dim=2))


def _tail_case(dev, C, T, std):
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    rng = np.random.default_rng(C + T)
    pos = lambda shape: 1.0 + _t(rng, shape, 0.3, dev).abs()
    w = lt.TailWeights(pos((3, C)), _t(rng, (3, C, C, 7), std, dev), _t(rng, (3, C), 0.1, dev),
                       pos((3, C)), _t(rng, (3, C, C), std, dev), _t(rng, (3, C), 0.1, dev),
                       pos((C,)), _t(rng, (1, C, 7), std, dev), _t(rng, (1,), 0.05, dev))
    return w, _t(rng, (2, C, T), 1.0, dev)


@pytest.mark.parametrize("C", [4, 20, 28, 32, 48, 64])
@pytest.mark.parametrize("poly", [True, False])
def test_legacy_tail_kernel_at_every_width(dev, C, poly):
    """Every width, the weights at test_legacy_tail_kernel's conditioning:
    its std of 0.1 at C = 24, scaled by sqrt(24 / C) as the fan-in grows."""
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    w, x = _tail_case(dev, C, 900, 0.1 * (24 / C) ** 0.5)
    want = lt.legacy_tail_plain(x, w)
    got = lt.legacy_tail_poly_ct(x[..., 0::2].contiguous(), x[..., 1::2].contiguous(), w) \
        if poly else lt.legacy_tail_ct(x, w)
    _check(got, want)


def test_legacy_tail_kernel_at_64_channels_is_as_accurate_as_fp32(dev):
    """C = 64 at a std of 0.1 (twice the init scale, 89 % of the outputs
    saturated): the fp32 plain version itself is 7e-5 off float64 there, so
    the kernel is held to float64, within 1.5x the fp32 plain version's own
    error."""
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    w, x = _tail_case(dev, 64, 3000, 0.1)
    exact = lt.legacy_tail_plain(x.double(), lt.TailWeights(*(t.double() for t in w))).float()
    plain_err = (lt.legacy_tail_plain(x, w) - exact).abs().max().item()
    err = (lt.legacy_tail_ct(x, w) - exact).abs().max().item()
    assert err <= 1.5 * plain_err, (err, plain_err)


@pytest.mark.parametrize("Ci,Co,scale", [(768, 320, 5), (320, 80, 3), (130, 100, 2),
                                         (512, 512, 2), (98, 257, 3), (1024, 33, 1)])
def test_up_fused_tensor_core_kernel_at_any_width(dev, Ci, Co, scale):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _up_case(dev, Ci, Co, 65, True)
    before = uf.ROUTES["tc"]
    got = uf.up_fused(x, w, scale=scale)
    assert uf.ROUTES["tc"] == before + 1
    _check(got, uf.up_fused_plain(x, w, scale=scale, channel_dim=2))


def test_prepared_weights_rebuilt_after_a_move_to_bf16(dev):
    """A model moved with .to(torch.bfloat16) rebuilds its packs: the cached
    fp32 operands are not reused for the bf16 kernels."""
    from l3ac_tpu_torch.models.zoo import get_model
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    m = get_model("debug", device=dev, seed=3)
    audio = np.random.default_rng(3).standard_normal((1, m.mc.hop_length * 20)).astype(np.float32)
    m.encode_audio(audio)
    unit, stem = m.codec.encoder.stages[0].units[0], m.codec.encoder.first
    p32, s32 = unit.prepared(), stem.prepared()
    assert isinstance(p32, cu.PreparedWeights)
    m.codec.to(torch.bfloat16)
    m = type(m)(m.config, m.codec)
    pbf, sbf = unit.prepared(), stem.prepared()
    assert isinstance(pbf, cu.PreparedBf16) and pbf.w1.dtype == torch.bfloat16
    assert sbf is not s32 and sbf.packed.numel() != s32.packed.numel()
    q, idx = m.encode_audio(audio)
    assert q.dtype == torch.bfloat16
    cpu = get_model("debug", device="cpu", seed=3, dtype=torch.bfloat16)
    _, idx_c = cpu.encode_audio(audio)
    assert (idx.cpu() == idx_c).float().mean().item() >= 0.97


# -- bf16 decode and bf16 int8; the (B, C, T) up path up to Co 128 -----------

@pytest.mark.parametrize("Ci,Co,scale,split", [(12, 80, 2, False), (12, 80, 2, True),
                                               (96, 128, 3, False), (128, 128, 4, True),
                                               (37, 113, 3, False), (80, 65, 2, True)])
@pytest.mark.parametrize("T", [1, 333, 1001])
def test_up_fused_ct_streaming_kernel_to_128_channels(dev, Ci, Co, scale, split, T):
    """The streaming kernel past Co = 64 (whole Co per block; the tile halves
    where shared memory needs it), odd T, phase_split."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _up_case(dev, Ci, Co, T, False)
    before = uf.ROUTES["stream"]
    got = uf.up_fused_ct(x, w, scale=scale, phase_split=split)
    want = uf.up_fused_plain(x, w, scale=scale, channel_dim=1, phase_split=split)
    assert uf.ROUTES["stream"] == before + 1
    if split:
        got, want = torch.stack(got), torch.stack(want)
    _up_check(got, want)


def _bf16_up(w, x):
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    return uf.UpWeights(*(None if t is None else t.bfloat16() for t in w)), x.bfloat16()


@pytest.mark.parametrize("Ci,Co,T,scale,cl,split,norm", [
    (512, 256, 1779, 5, True, False, True), (256, 96, 150, 3, True, False, True),
    (130, 100, 65, 2, True, False, True), (20, 36, 301, 3, True, False, False),
    (768, 320, 63, 5, True, False, True), (96, 48, 333, 3, False, False, True),
    (48, 24, 1001, 2, False, True, True), (12, 80, 300, 2, False, False, True),
    (128, 128, 129, 3, False, True, True), (16, 12, 70, 1, False, False, False),
    (24, 72, 99, 2, True, False, True)])
def test_up_fused_bf16_kernels(bf16_products, Ci, Co, T, scale, cl, split, norm):
    """Both up paths' bf16 variants at the 1kbps widths and at ragged ones
    (Ci % 8 != 0, Co not a multiple of 4 or 32, no norm), on the route the
    shape takes; each launch counted, the output bf16."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    dev = bf16_products
    w, x = _bf16_up(*_up_case(dev, Ci, Co, T, cl, norm=norm))
    name = "up_fused" if cl else "up_fused_ct"
    route = uf.route_for(Ci, Co, cl, bf16=True)
    before, K.LAUNCHES[name] = dict(uf.ROUTES), 0
    got = uf.up_fused(x, w, scale=scale) if cl else \
        uf.up_fused_ct(x, w, scale=scale, phase_split=split)
    want = uf.up_fused_plain_bf16(x, w, scale=scale, channel_dim=2 if cl else 1,
                                  phase_split=split)
    assert uf.ROUTES[route] == before[route] + 1 and K.LAUNCHES[name] == 1
    if split:
        got, want = torch.stack(got), torch.stack(want)
    if cl:
        got, want = got.transpose(1, 2), want.transpose(1, 2)
    _check_bf16(got, want)
    _check_bf16(torch.cat([got[..., :8], got[..., -8:]], -1),
                torch.cat([want[..., :8], want[..., -8:]], -1))


@pytest.mark.parametrize("Ci,Co,T,scale,norm", [
    (8, 32, 63, 1, True), (128, 64, 200, 2, False), (256, 96, 61, 3, True),
    (1024, 128, 1001, 4, True), (64, 160, 61, 2, False), (192, 192, 130, 5, True),
    (192, 224, 65, 3, True), (512, 256, 124, 5, False), (768, 256, 1, 16, True)])
def test_up_fused_wgmma_bf16_at_every_co(bf16_products, Ci, Co, T, scale, norm):
    """csrc/up_fused_tc_bf16.cu at every Co it instantiates (32-256: wgmma
    n16-n128 chunks per warpgroup), with and without the norm, at scales 1-16
    and at T below, at and past one 62-row tile; the route asserted."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _bf16_up(*_up_case(bf16_products, Ci, Co, T, True, norm=norm))
    assert uf.route_for(Ci, Co, True, bf16=True, x_ptr=x.data_ptr()) == "wgmma"
    before = uf.ROUTES["wgmma"]
    got = uf.up_fused(x, w, scale=scale)
    want = uf.up_fused_plain_bf16(x, w, scale=scale, channel_dim=2)
    assert uf.ROUTES["wgmma"] == before + 1
    got, want = got.transpose(1, 2), want.transpose(1, 2)
    _check_bf16(got, want)
    _check_bf16(torch.cat([got[..., :8], got[..., -8:]], -1),
                torch.cat([want[..., :8], want[..., -8:]], -1))


@pytest.mark.parametrize("offset", [3, 5])
@pytest.mark.parametrize("Ci,Co,T,scale", [(512, 256, 200, 5), (256, 96, 150, 3)])
def test_up_fused_bf16_kernel_on_unaligned_x(bf16_products, offset, Ci, Co, T, scale):
    """bf16 (B, T, C) x at a storage offset that is no multiple of 8
    elements: the wgmma kernel's TMA needs a 16-byte aligned base, so the
    route rule sends it to "tc", which copies it element by element."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    dev = bf16_products
    w, _ = _bf16_up(*_up_case(dev, Ci, Co, T, True))
    rng = np.random.default_rng(offset)
    x = _t(rng, (offset + 2 * T * Ci,), 1.0, dev).bfloat16()[offset:].view(2, T, Ci)
    assert x.data_ptr() % 16 != 0
    assert uf.route_for(Ci, Co, True, bf16=True, x_ptr=x.data_ptr()) == "tc"
    before = uf.ROUTES["tc"]
    got = uf.up_fused(x, w, scale=scale)
    want = uf.up_fused_plain_bf16(x, w, scale=scale, channel_dim=2)
    assert uf.ROUTES["tc"] == before + 1
    _check_bf16(got, want)


@pytest.mark.parametrize("T", [1, 63, 65, 1001])
@pytest.mark.parametrize("Ci,Co,scale,split", [(96, 48, 3, False), (48, 24, 2, True)])
def test_up_fused_ct_bf16_kernel_at_the_real_widths(bf16_products, Ci, Co, scale, split, T):
    """csrc/up_fused_bf16.cu at the 1kbps (B, C, T) widths: T = 1, below and
    above its 30-column warp tile (63, 65) and 1001; the stream route
    counted, the edge columns held on their own."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    w, x = _bf16_up(*_up_case(bf16_products, Ci, Co, T, False))
    before = uf.ROUTES["stream"]
    got = uf.up_fused_ct(x, w, scale=scale, phase_split=split)
    want = uf.up_fused_plain_bf16(x, w, scale=scale, channel_dim=1, phase_split=split)
    assert uf.ROUTES["stream"] == before + 1
    if split:
        got, want = torch.stack(got), torch.stack(want)
    _check_bf16(got, want)
    _check_bf16(torch.cat([got[..., :8], got[..., -8:]], -1),
                torch.cat([want[..., :8], want[..., -8:]], -1))


@pytest.mark.parametrize("offset,Ci,Co,scale,split,T", [(3, 96, 48, 3, False, 1001),
                                                        (5, 48, 24, 2, True, 777),
                                                        (1, 37, 113, 3, False, 65)])
def test_up_fused_ct_bf16_kernel_on_unaligned_x(bf16_products, offset, Ci, Co, scale, split, T):
    """x at a storage offset that is no multiple of 8 elements: its rows'
    16-byte pieces start before the tensor."""
    from l3ac_tpu_torch.ops.kernels import up_fused as uf
    dev = bf16_products
    w, _ = _bf16_up(*_up_case(dev, Ci, Co, T, False))
    rng = np.random.default_rng(offset)
    x = _t(rng, (offset + 2 * Ci * T,), 1.0, dev).bfloat16()[offset:].view(2, Ci, T)
    assert x.data_ptr() % 16 != 0
    got = uf.up_fused_ct(x, w, scale=scale, phase_split=split)
    want = uf.up_fused_plain_bf16(x, w, scale=scale, channel_dim=1, phase_split=split)
    if split:
        got, want = torch.stack(got), torch.stack(want)
    _check_bf16(got, want)


def _bf16_tail(dev, C, T, std):
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    w, x = _tail_case(dev, C, T, std)
    return lt.TailWeights(*(t.bfloat16() for t in w)), x.bfloat16()


@pytest.mark.parametrize("C,T", [(24, 3000), (24, 160110), (8, 4002), (32, 900), (64, 1000),
                                 (20, 600)])
@pytest.mark.parametrize("poly", [True, False])
def test_legacy_tail_bf16_kernel(bf16_products, C, T, poly):
    """The bf16 tail, weights at 2.5x the model's init scale (std 0.05 at C =
    24, scaled by sqrt(24 / C)), at the 8 x 10 s row length and ragged ones;
    the launch counted, the audio bf16."""
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    w, x = _bf16_tail(bf16_products, C, T, 0.05 * (24 / C) ** 0.5)
    name = "legacy_tail_poly_ct" if poly else "legacy_tail_ct"
    K.LAUNCHES[name] = 0
    got = lt.legacy_tail_poly_ct(x[..., 0::2].contiguous(), x[..., 1::2].contiguous(), w) \
        if poly else lt.legacy_tail_ct(x, w)
    assert K.LAUNCHES[name] == 1
    _check_bf16(got, lt.legacy_tail_plain_bf16(x, w))


def test_legacy_tail_bf16_kernel_is_as_accurate_as_its_plain_version(bf16_products):
    """At 5x init (a saturated output) one-ulp differences of intermediate
    bf16 roundings grow, so the kernel is held to the float64 chain on the
    same bf16 values: within 2 % of the bf16 plain version's relative L2."""
    from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
    w, x = _bf16_tail(bf16_products, 24, 20000, 0.1)
    exact = lt.legacy_tail_plain(x.double(), lt.TailWeights(*(t.double() for t in w)))
    rel = lambda a: ((a.double() - exact).norm() / exact.norm()).item()
    got = lt.legacy_tail_poly_ct(x[..., 0::2].contiguous(), x[..., 1::2].contiguous(), w)
    assert rel(got) <= 1.02 * rel(lt.legacy_tail_plain_bf16(x, w))


@pytest.mark.parametrize("M,K,N,bias", [(18000, 128, 576, False), (18000, 341, 128, False),
                                        (6000, 128, 682, False), (14232, 192, 768, True),
                                        (1, 341, 682, True), (127, 37, 15, True),
                                        (200, 16, 7, False)])
def test_int8_matmul_bf16_kernel(bf16_products, M, K, N, bias):
    """The bf16 variant at the int8 path's product shapes (K = 341 and N =
    682 ragged) and odd ones: within one bf16 ulp of its plain version almost
    everywhere, and within 2^-6 x max(1, max |plain|)."""
    from l3ac_tpu_torch.ops import kernels as Kn
    from l3ac_tpu_torch.ops.kernels import int8_matmul as im
    from l3ac_tpu_torch.ops.quantized import quantize_weight
    dev = bf16_products
    rng = np.random.default_rng(M + K + N)
    w_q, scale = quantize_weight(_t(rng, (N, K), K ** -0.5, dev))
    b = _t(rng, (N,), 0.3, dev).bfloat16() if bias else None
    x = _t(rng, (M, K), 1.0, dev).bfloat16()
    Kn.LAUNCHES["int8_matmul"] = 0
    got = im.int8_matmul(x, w_q, scale, b)
    want = im.int8_matmul_plain_bf16(x, w_q, scale, b)
    assert Kn.LAUNCHES["int8_matmul"] == 1
    _check_bf16(got, want)
    ulp = want.float().abs() * 2.0 ** -7
    assert ((got.float() - want.float()).abs() <= ulp).float().mean().item() >= 0.999


def test_debug_bf16_decode_and_int8_roundtrip_match_cpu(dev):
    """A bf16 debug model decodes on the card through the bf16 kernels (each
    decode kernel launched, bf16 audio), as close to the fp32 decode as the
    CPU's bf16 plain decode is (within 1.5x; chip_smoke.py's rule: one-ulp
    differences early in the seeded decoder move its audio as far as bf16
    does); the same model quantized roundtrips with int8_matmul launched,
    indices >= 0.97 equal to the CPU's."""
    from l3ac_tpu_torch.models.zoo import get_model
    from l3ac_tpu_torch.ops import kernels as K
    from l3ac_tpu_torch.ops.quantized import quantize_params
    idx = np.random.default_rng(2).integers(0, 125, (2, 40)).astype(np.int32)
    gpu = get_model("debug", device=dev, seed=6, dtype=torch.bfloat16)
    cpu = get_model("debug", device="cpu", seed=6, dtype=torch.bfloat16)
    K.reset_launches()
    a_g = gpu.decode_audio(indices=idx)
    torch.cuda.synchronize()
    assert a_g.dtype == torch.bfloat16
    assert K.LAUNCHES["legacy_tail_poly_ct"] == 1 and K.LAUNCHES["up_fused_ct"] > 0, K.LAUNCHES
    a32 = get_model("debug", device="cpu", seed=6).decode_audio(indices=idx).double()
    rel = lambda a, b: ((a.double() - b.double()).norm() / b.double().norm()).item()
    vs32 = rel(a_g.cpu(), a32)
    assert vs32 <= 0.25 and vs32 <= 1.5 * rel(cpu.decode_audio(indices=idx), a32)
    for m in (gpu, cpu):
        quantize_params(m.codec)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.codec.state_dict().items()})
    audio = (np.random.default_rng(3).standard_normal((2, gpu.mc.hop_length * 40)) * 0.3
             ).astype(np.float32)
    K.reset_launches()
    _, i_g = gpu.encode_audio(audio)
    y = gpu.decode_audio(indices=i_g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["int8_matmul"] > 0 and y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()
    _, i_c = cpu.encode_audio(audio)
    assert (i_g.cpu() == i_c).float().mean().item() >= 0.97


# -- training: the kernels' autograd Functions (ops/kernels/autograd.py) ------

@pytest.mark.parametrize("size", ["debug", "1kbps"])
@pytest.mark.parametrize("name", ["first_block", "conv_unit_ct", "conv_unit", "local_attention",
                                  "up_fused_ct", "up_fused", "legacy_tail_poly_ct",
                                  "legacy_tail_ct"])
def test_kernel_gradient_through_its_function(dev, name, size):
    """The gradient of (out * r).sum() through the kernel's Function (forward:
    the launch; backward: the plain version's VJP) against the same through
    the plain version, every input, within 1e-5 relative L2 (chip_smoke.py's
    FAMILY_GRAD_TOL); the launch counted once."""
    from l3ac_tpu_torch import grad_check
    from l3ac_tpu_torch.ops import kernels as K
    call, plain, inputs = grad_check.case(name, size, dev)
    K.reset_launches()
    out, got = grad_check.grads(call, inputs)
    assert K.LAUNCHES[name] == 1, K.LAUNCHES
    p_out, want = grad_check.grads(plain, inputs)
    _check(out, p_out)
    for i, (g, w) in enumerate(zip(got, want)):
        assert grad_check.rel_l2(g, w) <= 1e-5, (name, i, grad_check.rel_l2(g, w))


def test_debug_training_step_on_the_card(dev):
    """A debug training step (2 x 4 tokens, the waveform loss): each kernel
    launched as an encode plus a decode launches it, none in the backward;
    loss and every gradient against the CPU's (leaves of roundoff alone,
    ``grad_check.negligible``, aside); bf16 under autograd raises."""
    from l3ac_tpu_torch import grad_check, train
    from l3ac_tpu_torch.config import get_config
    from l3ac_tpu_torch.models.codec import Codec
    from l3ac_tpu_torch.ops import kernels as K
    mc = get_config("debug").network_config
    gpu = Codec(mc, device=dev)
    gpu.init_weights(torch.Generator().manual_seed(0))
    cpu = Codec(mc)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    audio = (np.random.default_rng(0).standard_normal((2, 4 * mc.hop_length)) * 0.3
             ).astype(np.float32)
    K.reset_launches()
    with torch.no_grad():
        q, _ = gpu.encode(torch.from_numpy(audio).to(dev))
        gpu.decode(q)
    roundtrip = dict(K.LAUNCHES)
    K.reset_launches()
    loss_g, _ = train.loss_fn(gpu, torch.from_numpy(audio).to(dev))
    forward = dict(K.LAUNCHES)
    loss_g.backward()
    assert dict(K.LAUNCHES) == forward == roundtrip
    loss_c, _ = train.loss_fn(cpu, torch.from_numpy(audio))
    loss_c.backward()
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    want = {n: c.grad for n, c in cpu.named_parameters()}
    zero = grad_check.negligible(want)             # roundoff alone
    for n, p in gpu.named_parameters():
        if n not in zero:
            assert grad_check.rel_l2(p.grad.cpu(), want[n]) <= 1e-3, n
    gpu.to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        train.loss_fn(gpu, torch.from_numpy(audio).to(dev).bfloat16())


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("mode", ["kp", "prev_k, left_edge 0", "prev_k, left_edge 1",
                                  "kp + prev_k"])
@pytest.mark.parametrize("dtype,n,W,view", [
    (dt, n, W, view) for dt in ("fp32", "bf16")
    for n, W, view in ((100, 3, "proj"), (250, 2, "proj"), (16, 3, "contig"), (100, 2, "proj+4"))
    if not (dt == "fp32" and view == "proj+4")])   # an 8-byte offset is a bf16 route
def test_local_attention_previous_window_operands(bf16_products, dtype, D, mode, n, W, view):
    """Both attention kernels with JAX's previous-window operands: ``kp`` (the
    rotary path's previous-role keys, a view like k), ``prev_k`` / ``prev_v``
    (window 0's previous block) with ``left_edge`` 0 and 1, and both at
    once; on the model's head views of one projection, contiguous operands,
    and (bf16) a projection at an 8-byte offset, the cp.async route; n = 100
    and 250 put a key tile across the previous / current boundary. Held
    against the plain version at phase 3's tolerances; the launches counted
    in ``ROUTES`` under "kp" / "prev_k"."""
    from l3ac_tpu_torch.ops.attention import rotary_operands
    from l3ac_tpu_torch.ops.kernels import local_attention as la
    dev = bf16_products
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    rng = np.random.default_rng([n, W, D, len(mode)])
    B, H, T = 2, 3, n * W
    if view == "contig":
        q, k, v = (_t(rng, (B, H, T, D), 1.0, dev).to(dt) for _ in range(3))
    else:
        off = 4 if view == "proj+4" else 0
        buf = _t(rng, (off + B * T * 3 * H * D,), 1.0, dev).to(dt)
        q, k, v = (c.view(B, T, H, D).permute(0, 2, 1, 3)
                   for c in buf[off:].view(B, T, 3 * H * D).chunk(3, dim=-1))
    table = _t(rng, (2 * n, H), 1.0, dev).to(dt)
    kw = {}
    if "kp" in mode:
        q, k, kw["kp"] = rotary_operands(q, k, n)
    if "prev_k" in mode:
        kw["prev_k"], kw["prev_v"] = (_t(rng, (B, H, n, D), 1.0, dev).to(dt) for _ in range(2))
        kw["left_edge"] = int(mode.endswith("1"))
    before = dict(la.ROUTES)
    got = la.local_attention(q, k, v, window_size=n, bias_table=table, **kw)
    assert la.ROUTES["kp"] - before["kp"] == int("kp" in kw)
    assert la.ROUTES["prev_k"] - before["prev_k"] == int("prev_k" in kw)
    if dtype == "bf16":
        route = "cp_async" if view == "proj+4" else "tma"
        assert la.ROUTES[route] - before[route] == 1
    want = la.local_attention_plain(q, k, v, window_size=n, bias_table=table, **kw)
    (_check_bf16 if dtype == "bf16" else _check)(got, want)
