"""The autograd layer of the CUDA kernels (``ops/kernels/autograd.py``), on the
CPU.

Every wrapper of the training path takes its CUDA branch here, with the route
forced to the kernel and each launch replaced by a test-only launch that
computes the plain version without autograd, as a kernel would. Then:

- each family's gradient through its ``KernelFunction`` equals autograd's
  through the plain version, for every input (activations, weights, the
  attention's position table), at ``grad_check``'s debug shapes (the
  backward recomputes the same plain version);
- under ``no_grad`` and for inputs that need no grad the wrappers launch
  directly, with no Function;
- bf16 under autograd raises, and so do ``int8_matmul`` and an int8 unit;
- on the CPU the plain path also runs in float64 (the reference the card's
  training check measures both fp32 paths against): a debug step's loss and
  gradients there lie near the fp32 ones;
- a whole ``debug`` training step through the forced kernels gives the plain
  path's loss and every parameter's gradient (within 1e-5 relative L2: a
  few sums accumulate in another order), launches each family as an
  encode plus a decode does (the backward launches nothing), and builds each
  prepared weight set once per step: again after an optimizer step, never
  twice within one, none on a step without a change.

The real kernels' gradients are held on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` with the same cases.
"""

import numpy as np
import pytest
import torch

import l3ac_tpu_torch.ops.kernels as K
from l3ac_tpu_torch import grad_check, train
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models import decoder as mdec
from l3ac_tpu_torch.models import tconv
from l3ac_tpu_torch.models.codec import Codec
from l3ac_tpu_torch.models.layers import ConvUnit
from l3ac_tpu_torch.ops.attention import local_attention as attention_plain
from l3ac_tpu_torch.ops.kernels import autograd as ag
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels import int8_matmul as im
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.ops.kernels import up_fused as uf
from l3ac_tpu_torch.ops.resample import interleave
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = grad_check.FAMILIES


def _count(name):
    K.LAUNCHES[name] += 1


def force(m):
    """Route every wrapper to its CUDA branch on CPU tensors, each launch a
    stand-in that runs the plain version with no autograd graph and counts
    where the real launch counts."""
    m.setattr(K, "route", lambda x, name: True)

    @torch.no_grad()
    def narrow(x, w, p, dilation):
        return cu.conv_unit_plain(x, w, channel_dim=1, dilation=dilation)

    @torch.no_grad()
    def wide(x, w, dilation, **kw):
        return cu.conv_unit_plain(x, w, channel_dim=2, dilation=dilation)

    @torch.no_grad()
    def general(x, w, p, dilation, partial, name):
        return cu.conv_unit_plain(x, w, channel_dim=2, dilation=dilation, partial=partial)

    @torch.no_grad()
    def stem(x, w):
        _count("first_block")
        return fb.first_block_plain(x, w.weights if isinstance(w, fb.PreparedStem) else w)

    @torch.no_grad()
    def attention(q, k, v, bias, table, n, ptrs, strides):
        return attention_plain(q, k, v, window_size=n, bias=bias,
                               bias_table=table).permute(0, 2, 1, 3)

    @torch.no_grad()
    def up(x, w, scale, *, channels_last, phase_split, name, prepared):
        _count(name)
        out = uf.up_fused_plain(x, w, scale=scale, channel_dim=2 if channels_last else 1,
                                phase_split=phase_split)
        return torch.stack(out) if phase_split else out

    @torch.no_grad()
    def tail(x0, x1, w, T, name):
        _count(name)
        w = w.weights if isinstance(w, lt.PreparedTail) else w
        return lt.legacy_tail_plain(x0 if x1 is None else interleave([x0, x1], 2), w)

    m.setattr(cu, "_launch_narrow", narrow)
    m.setattr(cu, "_launch_tc", wide)
    m.setattr(cu, "_launch_general", general)
    m.setattr(fb, "_launch", stem)
    m.setattr(la, "_launch", attention)
    m.setattr(uf, "_launch", up)
    m.setattr(lt, "_launch", tail)


class Spy:
    """Counts the calls of a function it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_gradient_through_its_function_equals_the_plain_one(name, monkeypatch):
    call, plain, inputs = grad_check.case(name, "debug", "cpu")
    _, want = grad_check.grads(plain, inputs)
    spy = Spy(ag.KernelFunction.apply)
    with monkeypatch.context() as m:
        force(m)
        m.setattr(ag.KernelFunction, "apply", spy)
        out, got = grad_check.grads(call, inputs)
    assert spy.calls == 1
    assert out.shape == plain(*inputs).shape
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == inputs[i].shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7, msg=f"{name} input {i}")
        assert g.abs().sum() > 0, f"{name}: input {i} gets no gradient"


@pytest.mark.parametrize("name", FAMILIES)
def test_wrappers_launch_directly_without_autograd(name, monkeypatch):
    call, plain, inputs = grad_check.case(name, "debug", "cpu")
    spy = Spy(ag.KernelFunction.apply)
    with monkeypatch.context() as m:
        force(m)
        m.setattr(ag.KernelFunction, "apply", spy)
        with torch.no_grad():
            a = call(*inputs)
        b = call(*(t.detach() for t in inputs))
    assert spy.calls == 0 and not a.requires_grad and not b.requires_grad
    with torch.no_grad():
        torch.testing.assert_close(a, plain(*inputs), rtol=0, atol=0)


def test_bf16_and_int8_raise_under_autograd(monkeypatch):
    call, _, inputs = grad_check.case("conv_unit_ct", "debug", "cpu")
    low = [t.detach().bfloat16().requires_grad_() for t in inputs]
    w_q = torch.ones(8, 16, dtype=torch.int8)
    x = torch.ones(3, 16, requires_grad=True)
    with monkeypatch.context() as m:
        force(m)
        with pytest.raises(TypeError, match="float32 only"):
            call(*low)
        with pytest.raises(TypeError, match="float32 only"):
            im.int8_matmul(x, w_q, torch.ones(8), None)
        with torch.no_grad():   # int8 outside autograd is the launch, as before
            m.setattr(im, "_launch", lambda x, w_q, s, b: x @ (w_q.float() * s[:, None]).T)
            assert im.int8_matmul(x, w_q, torch.ones(8), None).shape == (3, 8)


def test_the_plain_path_takes_float64_on_the_cpu():
    codec = _codec()
    c64 = _codec().double()
    hop = get_config("debug").network_config.hop_length
    audio = torch.from_numpy((np.random.default_rng(1).standard_normal((2, 4 * hop)) * 0.3)
                             .astype(np.float32))
    loss, _ = train.loss_fn(codec, audio)
    loss64, _ = train.loss_fn(c64, audio.double())
    assert loss64.dtype == torch.float64
    assert abs(loss64.item() - loss.item()) <= 1e-5 * abs(loss64.item())
    loss.backward()
    loss64.backward()
    want = {n: p.grad for n, p in c64.named_parameters()}
    zero = grad_check.negligible(want)
    for n, p in codec.named_parameters():
        if n not in zero:
            assert grad_check.rel_l2(p.grad.double(), want[n]) <= 1e-3, n
    with pytest.raises(TypeError, match="float32"):
        cu.conv_unit_ct(torch.zeros(1, 8, 16, dtype=torch.float16), codec.decoder.stages[2]
                        .units[0].kernel_weights())


def _codec(seed=0):
    mc = get_config("debug").network_config
    codec = Codec(mc)
    codec.init_weights(torch.Generator().manual_seed(seed))
    return codec


def test_int8_unit_raises_under_autograd_on_the_card_route(monkeypatch):
    from l3ac_tpu_torch.ops.quantized import quantize_params
    codec = _codec()
    quantize_params(codec, min_size=1)
    unit = codec.decoder.stages[0].units[0]
    x = torch.ones(1, unit.dw.weight.shape[0], 20, requires_grad=True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(TypeError, match="int8 weight-only units do not train"):
        unit(x, channels_last=False)


def test_a_training_step_through_the_forced_kernels(monkeypatch):
    """Loss and every parameter's gradient as the plain path gives them; the
    launches of an encode plus a decode; each prepared set built once per
    step."""
    rng = np.random.default_rng(0)
    hop = get_config("debug").network_config.hop_length
    audio = torch.from_numpy((rng.standard_normal((2, 5 * hop)) * 0.3).astype(np.float32))
    codec = _codec()
    loss_p, _ = train.loss_fn(codec, audio, spectral=True)
    loss_p.backward()
    want = {n: p.grad.clone() for n, p in codec.named_parameters()}

    spy = Spy(ag.KernelFunction.apply)
    builds = {"unit": Spy(cu.prepare_weights), "stem": Spy(tconv.pack),
              "tail": Spy(mdec.pack)}
    with monkeypatch.context() as m:
        force(m)
        m.setattr(ag.KernelFunction, "apply", spy)
        m.setattr(cu, "prepare_weights", builds["unit"])
        m.setattr(tconv, "pack", builds["stem"])
        m.setattr(mdec, "pack", builds["tail"])
        K.reset_launches()
        with torch.no_grad():
            q, _ = codec.encode(audio)
            codec.decode(q)
        roundtrip = dict(K.LAUNCHES)
        assert builds["unit"].calls == n_units(codec) > 0
        assert builds["stem"].calls == 1 and builds["tail"].calls == 1

        optimizer = torch.optim.Adam(codec.parameters(), lr=1e-3)
        for step in range(2):
            for b in builds.values():
                b.calls = 0
            K.reset_launches()
            spy.calls = 0
            codec.zero_grad(set_to_none=True)
            loss, _ = train.loss_fn(codec, audio, spectral=True)
            forward = dict(K.LAUNCHES)
            loss.backward()
            assert dict(K.LAUNCHES) == forward == roundtrip   # the backward launches none
            assert spy.calls == sum(forward.values())
            # the first step's sets were built by the encode above, before any
            # change; after an optimizer step each is rebuilt once
            want_builds = 0 if step == 0 else 1
            assert builds["stem"].calls == want_builds and builds["tail"].calls == want_builds
            assert builds["unit"].calls == want_builds * n_units(codec)
            if step == 0:
                assert torch.equal(loss, loss_p)
                for n, p in codec.named_parameters():
                    # the same sums, a few accumulated in another order
                    assert grad_check.rel_l2(p.grad, want[n]) <= 1e-5, n
            optimizer.step()


def n_units(codec):
    """The ConvUnits: each one's forward asks for its prepared operands
    (``conv_unit_ct``'s narrow kernel, ``conv_unit``'s tensor-core or
    general route)."""
    return sum(isinstance(m, ConvUnit) for m in codec.modules())
