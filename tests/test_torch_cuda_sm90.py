"""The bf16 wgmma GEMM core (``l3ac_tpu_torch/csrc/gemm_sm90.cuh``) on the
card: the core alone on the TMA route at ragged shapes and every epilogue,
and ``int8_matmul`` on bf16 x on the cp.async route, each against its plain
version with chip_smoke.py's bf16 rule. Needs a CUDA device; skips without
one. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_sm90.py
"""

import numpy as np
import pytest
import torch

from l3ac_tpu_torch.ops.kernels import gemm_sm90 as g
from l3ac_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_plain_bf16
from l3ac_tpu_torch.ops.quantized import quantize_weight

pytestmark = pytest.mark.cuda

TOL = 2.0 ** -6   # chip_smoke.py, bf16 kernels: max abs error <= TOL * max(1, max |plain|)


def _rng(*key):
    return np.random.default_rng(list(key))


def _t(rng, shape, std=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dtype)


def _assert_bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g_, w_ = got.float(), want.float()
    err = (g_ - w_).abs().max().item()
    assert err <= TOL * max(1.0, w_.abs().max().item()), err
    ulp = torch.where(w_ == 0, torch.ones_like(w_), w_.abs() * 2.0 ** -7)
    assert ((g_ - w_).abs() <= ulp).float().mean().item() >= 0.999


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("Mr,Kd,N,act", [(1000, 512, 2048, "snake"), (333, 2048, 512, "residual"),
                                         (77, 16, 64, "gelu"), (129, 200, 202, None)])
def test_core_against_its_plain_version_on_the_card(dev, Mr, Kd, N, act):
    rng = _rng(Mr, Kd, 9)
    bf = torch.bfloat16
    a, w = _t(rng, (Mr, Kd), 1.0, bf).to(dev), _t(rng, (N, Kd), Kd ** -0.5, bf).to(dev)
    bias, alpha = _t(rng, (N,), 0.1).to(dev), (1.0 + _t(rng, (N,), 0.2).abs()).to(dev)
    res = _t(rng, (Mr, N), 1.0, bf).to(dev) if act == "residual" else None
    kw = dict(bias=bias, alpha=alpha if act == "snake" else None, res=res,
              act=None if act == "residual" else act)
    before = g.ROUTES["tma"]
    got = g.gemm_bf16(a, w, **kw)
    torch.cuda.synchronize()
    assert g.ROUTES["tma"] == before + 1
    _assert_bf16_close(got.cpu(), g.gemm_plain_bf16(a, w, **kw).cpu())


def test_int8_cp_async_route_on_the_card(dev):
    rng = _rng(11)
    x = _t(rng, (300, 341), 1.0, torch.bfloat16).to(dev)
    q, s = quantize_weight(_t(rng, (128, 341), 0.05).to(dev))
    before = g.ROUTES["cp_async"]
    got = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert g.ROUTES["cp_async"] == before + 1
    _assert_bf16_close(got.cpu(), int8_matmul_plain_bf16(x, q, s).cpu())


def test_maps_built_per_call_under_inference_mode(dev):
    """Weights made under inference mode are never cached, so their tensor
    maps are built at every call and must live until the launch has read
    them: the bf16 ConvUnit and int8_matmul on such weights, held to plain."""
    from l3ac_tpu_torch.ops.kernels import conv_unit as cu
    rng = _rng(13)
    bf = torch.bfloat16
    C = 192
    with torch.inference_mode():
        x = _t(rng, (2, 100, C), 1.0, bf).to(dev)
        w = cu.ConvUnitWeights(*(t.to(dev) for t in (
            _t(rng, (C, 1, 7), 7 ** -0.5, bf), _t(rng, (C,), 0.1, bf),
            (1.0 + _t(rng, (C,), 0.1)).to(bf), _t(rng, (C,), 0.1, bf),
            _t(rng, (4 * C, C), C ** -0.5, bf), _t(rng, (4 * C,), 0.1, bf),
            (1.0 + _t(rng, (4 * C,), 0.2).abs()).to(bf), _t(rng, (4 * C,), 0.1, bf),
            _t(rng, (4 * C,), 0.1, bf), _t(rng, (C, 4 * C), (4 * C) ** -0.5, bf),
            _t(rng, (C,), 0.1, bf))))
        for _ in range(3):
            got = cu.conv_unit(x, w)
            torch.cuda.synchronize()
            _assert_bf16_close(got.cpu(), cu.conv_unit_plain_bf16(x, w, channel_dim=2).cpu())
        xq = _t(rng, (300, 192), 1.0, bf).to(dev)
        q, s = quantize_weight(_t(rng, (768, 192), 0.05).to(dev))
        for _ in range(3):
            got = int8_matmul(xq, q, s)
            torch.cuda.synchronize()
            _assert_bf16_close(got.cpu(), int8_matmul_plain_bf16(xq, q, s).cpu())
