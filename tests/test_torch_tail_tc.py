"""The arithmetic of the tensor-core tail kernel (``csrc/legacy_tail.cu``)
modelled in PyTorch on the CPU, and the tail weights it takes, prepared once.

- ``tail_emulated`` sums as the kernel does: per unit, the snake with the
  prepared reciprocal 1 / (alpha + eps), the dilated k7 conv as 7 products
  of row-shifted time-major operands (``tc_gemm.gemm_emulated``: 3 TF32
  passes, ``tf32_rna`` splits, mma steps that add toward zero; each tap
  (K = Cin) a fresh accumulator added to the fp32 total in tap order), b1
  and the second snake, the 1x1 as one more such product, the residual
  zeroed outside [0, T); then the last snake, the C -> 1 conv and tanh in
  fp32. Held against the float64 plain tail within 3x the fp32 plain
  version's own error, at C = 8, 12, 24, in both input modes, with T
  spanning several of the kernel's 684-sample tiles (a tile's halo makes
  its sums those of the whole sequence, so the model needs no tiles).
- The plain tail and the model against JAX's Pallas tail in interpret mode
  at one small shape (the plain one is also held in
  ``tests/test_torch_kernels.py``; this is a cross-check).
- ``pack`` holds the weights bit for bit as the kernel reads them;
  ``Decoder.tail_prepared`` and ``prepared_tail`` cache it, rebuild it after
  ``load_state_dict`` and an in-place ``mul_``, never cache it for
  inference tensors, and a warm decode stacks no tail weight and packs
  nothing.
- ``tools/tail_variants.py``'s text substitutions apply to the kernel's source,
  and the tool needs the card.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from l3ac_tpu.ops.pallas import legacy_tail as pk_tail
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.decoder import Decoder
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.activations import EPS
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_emulated, split_tf32
from l3ac_tpu_torch.ops.resample import interleave

TOL = 1e-4   # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, C):
    """Above init scale, as chip_smoke.py: pre-tanh values O(1-10)."""
    pos = lambda shape: 1.0 + _t(rng, shape, 0.3).abs()
    return lt.TailWeights(pos((3, C)), _t(rng, (3, C, C, 7), 0.1), _t(rng, (3, C), 0.1),
                          pos((3, C)), _t(rng, (3, C, C), 0.1), _t(rng, (3, C), 0.1),
                          pos((C,)), _t(rng, (1, C, 7), 0.1), _t(rng, (1,), 0.05))


def _snake_r(h, a):
    """The kernel's snake: h + sin(a h)^2 * (1 / (a + eps)), the reciprocal in fp32."""
    s = torch.sin(a * h)
    return h + s * s * (1.0 / (a + EPS))


def tail_emulated(x: torch.Tensor, w: lt.TailWeights) -> torch.Tensor:
    """csrc/legacy_tail.cu's sums on the interleaved x (B, C, T) -> (B, T)."""
    B, C, T = x.shape
    out = torch.empty(B, T)
    for b in range(B):
        xr = x[b].t()                                          # (T, C), time-major
        for u, d in enumerate(lt.DILATIONS):
            a = F.pad(_snake_r(xr, w.a1[u]), (0, 0, 3 * d, 3 * d))
            conv = torch.zeros(T, C)
            for k in range(7):
                conv = conv + gemm_emulated(a[k * d:k * d + T].contiguous(),
                                            w.w1[u, :, :, k].contiguous())
            h = _snake_r(conv + w.b1[u], w.a2[u])
            xr = xr + (gemm_emulated(h, w.w2[u].contiguous()) + w.b2[u])
        y = F.conv1d(_snake_r(xr, w.ao).t()[None], w.wo, w.bo, padding=3)
        out[b] = torch.tanh(y)[0, 0]
    return out


def _float64(w: lt.TailWeights) -> lt.TailWeights:
    return lt.TailWeights(*(t.double() for t in w))


@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("C", [8, 12, 24])
def test_tail_sums_are_as_accurate_as_fp32(C, poly):
    rng = np.random.default_rng([C, poly])
    w = _weights(rng, C)
    T = 1500
    if poly:
        x0, x1 = _t(rng, (1, C, T // 2)), _t(rng, (1, C, T // 2))
        x = interleave([x0, x1], 2)
    else:
        x = _t(rng, (1, C, T))
    with torch.no_grad():
        exact = lt.legacy_tail_plain(x.double(), _float64(w))
        plain = lt.legacy_tail_poly_ct(x0, x1, w) if poly else lt.legacy_tail_ct(x, w)
        got = tail_emulated(x, w)
    e_model = (got.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    assert e_model <= 3 * e_plain, (e_model, e_plain)
    assert e_model <= TOL * max(1.0, exact.abs().max().item())


def test_tail_and_its_model_match_the_pallas_tail(monkeypatch):
    """The phase-pair tail at C = 8, T = 600, the Pallas tile cut to 128 so
    that the phases span several tiles."""
    C, T = 8, 600
    rng = np.random.default_rng(11)
    w = _weights(rng, C)
    x0, x1 = _t(rng, (1, C, T // 2)), _t(rng, (1, C, T // 2))
    units = [{"alpha1": jnp.asarray(w.a1[u].numpy()),
              "conv1": {"w": jnp.asarray(w.w1[u].permute(2, 1, 0).numpy()),
                        "b": jnp.asarray(w.b1[u].numpy())},
              "alpha2": jnp.asarray(w.a2[u].numpy()),
              "conv2": {"w": jnp.asarray(w.w2[u].t()[None].numpy()),
                        "b": jnp.asarray(w.b2[u].numpy())}} for u in range(3)]
    out_conv = {"w": jnp.asarray(w.wo.permute(2, 1, 0).numpy()), "b": jnp.asarray(w.bo.numpy())}
    monkeypatch.setattr(pk_tail, "TILE", 128)
    pallas = np.asarray(pk_tail.legacy_tail_poly_ct(
        jnp.asarray(x0.numpy()), jnp.asarray(x1.numpy()), units, jnp.asarray(w.ao.numpy()),
        out_conv, interpret=True))[..., 0]
    with torch.no_grad():
        plain = lt.legacy_tail_poly_ct(x0, x1, w).numpy()
        model = tail_emulated(interleave([x0, x1], 2), w).numpy()
    assert plain.shape == pallas.shape == (1, T)
    assert 0.1 < np.abs(pallas).mean() and (np.abs(pallas) < 0.999).mean() > 0.5
    np.testing.assert_allclose(plain, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(model, pallas, rtol=0, atol=1e-5)


def _assert_packed_from(p: torch.Tensor, w: lt.TailWeights) -> None:
    """p holds, bit for bit: w1 (3, 7, Cout, Cin) and w2 (3, Cout, Cin),
    zero-filled to rows of Cp + 4, split into TF32 hi / lo; then b1, a1,
    1 / (a1 + eps), a2, 1 / (a2 + eps), b2, ao, 1 / (ao + eps), wo (7, C), bo."""
    C = w.ao.shape[0]
    Cp = lt.padded_channels(C)
    assert p.shape == (lt.packed_floats(C),) and p.is_contiguous()
    w1 = torch.zeros(3, 7, Cp, Cp + 4)
    w1[:, :, :C, :C] = w.w1.permute(0, 3, 1, 2)
    w2 = torch.zeros(3, Cp, Cp + 4)
    w2[:, :C, :C] = w.w2
    pieces = [*split_tf32(w1), *split_tf32(w2)]
    for name in ("b1", "a1", "r1", "a2", "r2", "b2"):
        src = getattr(w, name) if name[0] != "r" else 1.0 / (getattr(w, "a" + name[1]) + EPS)
        pieces.append(F.pad(src, (0, Cp - C)))
    pieces += [F.pad(w.ao, (0, Cp - C)), F.pad(1.0 / (w.ao + EPS), (0, Cp - C)),
               F.pad(w.wo[0].t(), (0, Cp - C)), F.pad(w.bo, (0, 3))]
    want = torch.cat([t.reshape(-1) for t in pieces])
    assert torch.equal(p, want)
    # the fp32 fields are the weights themselves
    vec = 2 * w1.numel() + 2 * w2.numel()
    assert torch.equal(p[vec:vec + 3 * Cp].view(3, Cp)[:, :C], w.b1)
    assert torch.equal(p[-4:-3], w.bo)


def _decoder(seed=0):
    model = get_model("debug", device="cpu", seed=seed)
    return model.codec.decoder


def test_prepared_tail_is_pack_bit_for_bit_and_cached():
    dec = _decoder()
    with torch.no_grad():
        p = dec.tail_prepared()
        w = dec.tail_weights()
        for got, want in zip(p.weights, w):
            assert torch.equal(got, want)
        assert torch.equal(p.packed, lt.pack(w))
        _assert_packed_from(p.packed, w)
        assert dec.tail_prepared() is p
        rng = np.random.default_rng(3)
        tw = _weights(rng, 12)
        packed = lt.prepared_tail(tw)
        _assert_packed_from(packed, tw)
        assert lt.prepared_tail(tw) is packed


def test_prepared_tail_follows_load_state_dict_and_in_place_changes():
    dec = _decoder(0)
    with torch.no_grad():
        p = dec.tail_prepared()
        dec.load_state_dict(_decoder(7).state_dict())
        q = dec.tail_prepared()
        assert q is not p and not torch.equal(q.packed, p.packed)
        _assert_packed_from(q.packed, dec.tail_weights())
        dec.tail_units[1].conv1.weight.mul_(2.0)
        r = dec.tail_prepared()
        assert r is not q
        _assert_packed_from(r.packed, dec.tail_weights())
        dec.tail_alpha.add_(0.5)
        assert dec.tail_prepared() is not r


def test_prepared_tail_is_never_cached_for_inference_tensors():
    with torch.inference_mode():   # a decoder built here holds inference tensors
        dec = Decoder(get_config("debug").network_config)
        dec.init_weights(torch.Generator().manual_seed(0))
        assert dec.tail_alpha.is_inference()
        p, q = dec.tail_prepared(), dec.tail_prepared()
        assert p is not q and torch.equal(p.packed, q.packed)
        w = dec.tail_weights()
        assert lt.prepared_tail(w) is not lt.prepared_tail(w)


def test_a_warm_decode_stacks_and_packs_no_tail_weight(monkeypatch):
    dec = _decoder()
    params = [p for name, p in dec.named_parameters()
              if name.startswith(("tail_units", "tail_alpha", "out_conv"))]
    stacked, packs = [], []
    stack, pack = torch.stack, lt.pack

    def spy_stack(ts, *a, **kw):
        stacked.extend(t for t in ts if any(t is p for p in params))
        return stack(ts, *a, **kw)

    def spy_pack(w):
        packs.append(w)
        return pack(w)

    monkeypatch.setattr(torch, "stack", spy_stack)
    monkeypatch.setattr(lt, "pack", spy_pack)
    import l3ac_tpu_torch.models.decoder as mdec
    monkeypatch.setattr(mdec, "pack", spy_pack)
    x = _t(np.random.default_rng(0), (1, 12, 32))
    with torch.no_grad():
        first = dec(x)
        assert stacked and len(packs) == 1       # built once, on the cold call
        stacked.clear()
        packs.clear()
        assert torch.equal(dec(x), first)
    assert not stacked and not packs


def test_tail_variants_tool_applies_to_the_kernel_and_needs_the_card():
    """tools/tail_variants.py builds its variants by text substitution on the tail
    kernel's source: every substitution matches it exactly once; without CUDA
    the tool exits with a message, building nothing."""
    from l3ac_tpu_torch.tools import tail_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    sources = {variant_source(tool.SOURCE, subs, "tail_variants") for _, subs, _ in tool.VARIANTS}
    assert len(sources) == len(tool.VARIANTS)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])
