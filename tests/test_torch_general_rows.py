"""The general routes' two row passes (``csrc/general_rows.cu``: the unit's
dw + norm pass, the up path's blend + norm pass) on the CPU: their sums as
the kernels form them (``tests/_torch_rows.py``), held against the plain
versions the card holds them to.

- dw + norm at C in {1, 7, 16, 100, 1280, 2050}, dilations 1, 3, 9, fp32
  and bf16, with and without the norm, in one chunk and in small chunks
  (the chunks' (count, mean, M2) merged by Chan's formula): against the
  plain unit's depthwise conv and ChannelNorm.
- blend + norm at Co in {1, 7, 16, 100, 1280, 2050}, s 1-5, in the three
  output layouts (channels-last rows on a warp; channels-first and
  phase_split on half a warp), fp32 and bf16, with and without the norm,
  in one chunk and in small chunks: against the plain upsample and
  ChannelNorm.
- ``tools/rows_variants.py``'s substitutions apply once to the kernel's
  source, and the tool needs the card.

Tolerances: fp32 1e-4 x max(1, max |plain|), bf16 2^-6 x (two bf16 ulps),
the kernels' own on the card (``chip_smoke.py``, PERF.md §2): the sums run
in another order than the plain version's. No JAX here; the JAX
ChannelNorm case is in ``tests/test_torch_general_tc.py``. The kernels
themselves run on the card in ``chip_smoke.py`` phase 12.
"""

import numpy as np
import pytest
import torch

from _torch_rows import dw_norm_emulated, up_blend_norm_emulated
from _torch_threads import one_thread  # noqa: F401
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.norms import channel_norm
from l3ac_tpu_torch.ops.resample import interleave, phase_weights, upsample_phases

TOL, BF16_TOL = 1e-4, 2.0 ** -6
WIDTHS = (1, 7, 16, 100, 1280, 2050)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

pytestmark = pytest.mark.usefixtures("one_thread")


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _held(got, want, dtype):
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape and got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


def _dw_plain(x, dw, dw_b, nw, nb, dil):
    y = cu._depthwise(x.float().transpose(1, 2), dw[:, None, :], dw_b, dil, None, None)
    y = y if nw is None else channel_norm(y, nw, nb, dim=1)
    return y.transpose(1, 2).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", WIDTHS)
def test_dw_norm_sums_match_the_plain_pass(C, dtype):
    rng = np.random.default_rng(C)
    dt = DTYPES[dtype]
    x = _t(rng, (2, 11, C)).to(dt)
    dw, dw_b = _t(rng, (C, 7), 7 ** -0.5), _t(rng, (C,), 0.1)
    nw, nb = 1.0 + _t(rng, (C,), 0.1), _t(rng, (C,), 0.1)
    V = 8 if dt == torch.bfloat16 else 4
    for dil in (1, 3, 9):
        want = _dw_plain(x, dw, dw_b, nw, nb, dil)
        for cw in (None, 3 * V):   # one chunk; chunks of three groups
            _held(dw_norm_emulated(x, dw, dw_b, nw, nb, dil, cw), want, dt)
    _held(dw_norm_emulated(x, dw, dw_b, None, None, 3), _dw_plain(x, dw, dw_b, None, None, 3), dt)


def _up_plain(z, s, nw, nb, layout, dt):
    ph = upsample_phases(z, s, 1) if s > 1 else [z]
    ph = ph if nw is None else [channel_norm(p, nw, nb, dim=2) for p in ph]
    if layout == "ps":
        return tuple(p.transpose(1, 2).to(dt) for p in ph)
    y = interleave(ph, 1).to(dt)
    return y if layout == "cl" else y.transpose(1, 2)


UP_CASES = [(Co, s) for Co in (7, 100) for s in range(1, 6)] + \
    [(Co, s) for Co in (1, 16, 1280, 2050) for s in (2, 5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Co,s", UP_CASES)
def test_blend_norm_sums_match_the_plain_pass(Co, s, dtype):
    rng = np.random.default_rng(Co * 10 + s)
    dt = DTYPES[dtype]
    z = _t(rng, (2, 5, Co))
    nw, nb = 1.0 + _t(rng, (Co,), 0.2), _t(rng, (Co,), 0.2)
    taps = phase_weights(s)
    for layout in ("cl", "cf", "ps"):
        want = _up_plain(z, s, nw, nb, layout, dt)
        for cw in (None, 12):   # one chunk; chunks of 12 channels
            got = up_blend_norm_emulated(z, taps, nw, nb, layout, dt, cw)
            _held(torch.stack(got) if layout == "ps" else got,
                  torch.stack(want) if layout == "ps" else want, dt)
    _held(up_blend_norm_emulated(z, taps, None, None, "cf", dt),
          _up_plain(z, s, None, None, "cf", dt), dt)


def test_the_blend_rounds_each_product_and_the_sum_once():
    """Phase p of z: cur wc + nbr wo in fp32 equals the plain version's
    upsample to the bit (its products and sum, each rounded once, in the
    other order: the sum's rounding does not depend on it)."""
    z = _t(np.random.default_rng(5), (1, 40, 9))
    for s in range(2, 6):
        got = up_blend_norm_emulated(z, phase_weights(s), None, None, "cl", torch.float32)
        assert torch.equal(got, interleave(upsample_phases(z, s, 1), 1))


def test_rows_variants_substitutions_apply_once_and_need_the_card(monkeypatch):
    from l3ac_tpu_torch.tools import rows_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    sources = {variant_source(tool.SOURCE, subs, "rows_variants") for _, subs, _ in tool.VARIANTS}
    assert len(sources) == len(tool.VARIANTS)
    assert tool.SIMT_SOURCE.exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["rows_variants"])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main()
