"""The tensor-core ConvUnit kernels' prepared product operands
(``ops/kernels/conv_unit.py:prepared_weights`` / ``cached_prepare``,
``models/layers.py:ConvUnit.prepared``) on the CPU, pure torch:

- weights that are inference tensors (a unit built under
  ``torch.inference_mode()``) have no version counter: their operands are
  prepared on every call, never cached, and equal ``prepare_weights``';
- ``get_model`` builds its codec outside inference mode, wherever it is
  called;
- an int8 unit's operands are keyed on its ``w_q`` / ``w_scale`` buffers,
  pw2's bias and GRN: reused from call to call, rebuilt after an in-place
  change or ``load_state_dict``.
"""

import pytest
import torch

from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.quantized import quantize_params


def _unit(C, seed=0, int8=False):
    holder = torch.nn.Module()
    holder.unit = ConvUnit(C, use_norm=True)
    holder.unit.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        holder.unit.grn.gamma.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(seed + 1))
        holder.unit.grn.beta.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 2))
    if int8:
        quantize_params(holder, min_size=1)
    return holder.unit


def _assert_equal(p, q):
    assert type(p) is type(q)
    for a, b in zip(p, q):  # a TP shard's fields (b1, alpha) are None on a whole unit
        assert (a is None and b is None) or (a.is_contiguous() and torch.equal(a, b))


@pytest.mark.parametrize("C", [24, 192])
def test_inference_tensor_weights_are_prepared_uncached(C):
    with torch.inference_mode():
        unit = _unit(C)
        w = unit.kernel_weights()
        assert w.pw1_w.is_inference()
        p = cu.prepared_weights(w)
        _assert_equal(p, cu.prepare_weights(w))
        q = cu.prepared_weights(w)
    assert q is not p and id(w.pw1_w) not in cu._PREPARED
    _assert_equal(q, p)


def test_inference_tensor_int8_buffers_are_prepared_uncached():
    with torch.inference_mode():
        unit = _unit(24, int8=True)
        assert unit.pw1.w_q.is_inference()
        p = unit.prepared()
        _assert_equal(p, cu.prepare_weights(unit.kernel_weights()))
        assert unit.prepared() is not p
    assert id(unit.pw1.w_q) not in cu._PREPARED


def test_get_model_builds_outside_inference_mode():
    with torch.inference_mode():
        m = get_model("debug", device="cpu")
    tensors = [*m.codec.parameters(), *m.codec.buffers()]
    assert tensors and not any(t.is_inference() for t in tensors)
    unit = next(u for u in m.codec.modules() if isinstance(u, ConvUnit))
    with torch.inference_mode():
        p = unit.prepared()
        assert unit.prepared() is p


def test_int8_unit_reuses_its_prepared_operands():
    unit = _unit(24, int8=True)
    with torch.inference_mode():
        p = unit.prepared()
        _assert_equal(p, cu.prepare_weights(unit.kernel_weights()))
        assert unit.prepared() is p
        assert unit.prepared() is p


@pytest.mark.parametrize("change", ["w_q.mul_", "w_scale.mul_", "grn.gamma.add_",
                                    "load_state_dict"])
def test_int8_unit_rebuilds_after_a_change(change):
    unit = _unit(24, int8=True)
    with torch.inference_mode():
        p = unit.prepared()
    with torch.no_grad():
        if change == "w_q.mul_":
            unit.pw2.w_q.mul_(-1)
        elif change == "w_scale.mul_":
            unit.pw1.w_scale.mul_(2.0)
        elif change == "grn.gamma.add_":
            unit.grn.gamma.add_(0.5)
        else:
            unit.load_state_dict(_unit(24, seed=7, int8=True).state_dict())
    with torch.inference_mode():
        q = unit.prepared()
        assert q is not p
        _assert_equal(q, cu.prepare_weights(unit.kernel_weights()))
        assert unit.prepared() is q


def test_int8_narrow_unit_on_the_cpu_runs_the_dequantized_plain_version():
    """The CPU path (what JAX's int8 (B, C, T) unit computes) is unchanged:
    conv_unit_ct's plain version on the weights dequantized in that call."""
    unit = _unit(16, int8=True)
    x = torch.randn(2, 16, 50, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = unit(x, channels_last=False)
        want = cu.conv_unit_plain(x, unit.kernel_weights(), channel_dim=1)
    assert torch.equal(got, want)
