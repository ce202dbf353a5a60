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
- The bf16 kernel (``csrc/legacy_tail_bf16.cu``): ``tail_bf16_emulated``
  reads ``pack_bf16``'s buffer as each lane reads its fragments and sums as
  the kernel does (the snakes by ``sin2_ilp`` and the Newton quotient on the
  prepared reciprocal, rounded to bf16; the k7 conv as one product over the
  taps folded into K with one fp32 accumulator, ``gemm_bf16_emulated``; the
  bf16 roundings of the chain; the output conv's fmas in the kernel's
  order), held against ``legacy_tail_plain_bf16`` at 2.5x init, against the
  float64 chain at 5x (the ratio chip_smoke.py holds), and against JAX's
  Pallas tail in interpret mode on bf16 inputs, in both input modes;
  ``pack_bf16`` bit for bit, cached and rebuilt as the fp32 pack is.

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
from l3ac_tpu_torch.ops.kernels.gemm_sm90 import _fma32, newton_quotient, sin2_ilp
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_bf16_emulated, gemm_emulated, split_tf32
from l3ac_tpu_torch.ops.resample import interleave
from _torch_threads import one_thread  # noqa: F401

TOL = 1e-4   # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
BF16_TOL = 2.0 ** -6         # chip_smoke.py's bf16 kernels: within 2^-6 x max(1, max |plain|)
TAIL_BF16_F64_RATIO = 1.02   # chip_smoke.py: x5 weights, kernel vs float64 within this of plain's


pytestmark = pytest.mark.usefixtures("one_thread")


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
    kernels' sources (fp32 and, ``--bf16``, csrc/legacy_tail_bf16.cu): every
    substitution matches its source exactly once, and each variant differs
    from the others; without CUDA the tool exits with a message in both
    modes, building nothing."""
    from l3ac_tpu_torch.tools import tail_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    for source, variants in ((tool.SOURCE, tool.VARIANTS), (tool.SOURCE_BF16, tool.VARIANTS_BF16)):
        sources = {variant_source(source, subs, "tail_variants") for _, subs, _ in variants}
        assert len(sources) == len(variants)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for argv in ([], ["--bf16"]):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            tool.main(argv)


# -- the bf16 kernel ---------------------------------------------------------

def _bf16_weights(rng, C, std24):
    """chip_smoke.py's bf16 tail weights: the std scaled by sqrt(24 / C)."""
    pos = lambda shape: 1.0 + _t(rng, shape, 0.3).abs()
    std = std24 * (24 / C) ** 0.5
    return lt.TailWeights(*(v.bfloat16() for v in (
        pos((3, C)), _t(rng, (3, C, C, 7), std), _t(rng, (3, C), 0.1), pos((3, C)),
        _t(rng, (3, C, C), std), _t(rng, (3, C), 0.1), pos((C,)), _t(rng, (1, C, 7), std),
        _t(rng, (1,), 0.05))))


def _unpack_bf16(p: torch.Tensor, C: int) -> tuple:
    """w1 folded (3, 16 P, 16 J1), w2 (3, 16 P, 16 P) bf16 and the fp32
    vector part of ``pack_bf16``'s buffer, read as the kernel reads it: lane
    4 g + t's 16 bytes at (k16 step, pair) hold B[k][n] = W[n][k] of two n8
    tiles, (k 2t, 2t + 1) and (2t + 8, 2t + 9) of column n = g."""
    C8, P, J1 = lt.bf16_shape(C)
    n1, n2 = 3 * J1 * P * 32 * 8, 3 * P * P * 32 * 8
    f = p[:2 * (n1 + n2)].view(torch.bfloat16)
    f1, f2 = f[:n1].view(3, J1, P, 32, 8), f[n1:].view(3, P, P, 32, 8)
    i, lane = torch.arange(8), torch.arange(32)[:, None]
    n_in = 8 * (i // 4) + lane // 4
    k_in = 8 * ((i // 2) % 2) + 2 * (lane % 4) + i % 2
    w1 = torch.zeros(3, 16 * P, 16 * J1, dtype=torch.bfloat16)
    w2 = torch.zeros(3, 16 * P, 16 * P, dtype=torch.bfloat16)
    for q in range(P):
        for j in range(J1):
            w1[:, 16 * q + n_in, 16 * j + k_in] = f1[:, j, q]
        for j in range(P):
            w2[:, 16 * q + n_in, 16 * j + k_in] = f2[:, j, q]
    return w1, w2, p[2 * (n1 + n2):].view(torch.float32)


def _snake_ilp(h, a, r):
    """The bf16 kernel's snake: sin2_ilp, then the quotient by alpha + eps on
    the prepared reciprocal."""
    return h + newton_quotient(sin2_ilp(a * h), (a + EPS).expand_as(h))


def tail_bf16_emulated(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """csrc/legacy_tail_bf16.cu's sums on bf16 x (B, C, T) interleaved ->
    (B, T) bf16, from its buffer."""
    B, C, T = x.shape
    C8, P, J1 = lt.bf16_shape(C)
    Cp = 8 * C8
    w1, w2, v = _unpack_bf16(packed, C)
    vec = lambda i: v[i * Cp:(i + 1) * Cp]                       # Cp floats from i Cp on
    b1, a1, r1, a2, r2, b2 = ((lambda u, i=i: vec(3 * i + u)) for i in range(6))
    ao, ro, wo, bo = vec(18), vec(19), v[20 * Cp:27 * Cp].view(7, Cp), v[27 * Cp]
    keep = torch.arange(Cp) < C
    rnd = lambda t: t.bfloat16().float()
    xr = F.pad(x.float().transpose(1, 2), (0, Cp - C))         # (B, T, Cp), time-major
    for u, d in enumerate(lt.DILATIONS):
        a = torch.where(keep, rnd(_snake_ilp(xr, a1(u), r1(u))), 0.0)
        ap = F.pad(a, (0, 0, 3 * d, 3 * d))
        im = torch.cat([ap[:, k * d:k * d + T] for k in range(7)], -1)
        im = F.pad(im, (0, 16 * J1 - 7 * Cp)).reshape(B * T, -1).bfloat16()
        h = rnd(gemm_bf16_emulated(im, w1[u])[:, :Cp] + b1(u))
        h = torch.where(keep, rnd(_snake_ilp(h, a2(u), r2(u))), 0.0)
        y = gemm_bf16_emulated(F.pad(h, (0, 16 * P - Cp)).bfloat16(), w2[u])[:, :Cp]
        xr = rnd(xr + rnd(y + b2(u)).view(B, T, Cp))
    a = F.pad(torch.where(keep, rnd(_snake_ilp(xr, ao, ro)), 0.0), (0, 0, 3, 3))
    yv = torch.full((B, T), float(bo))
    for k in range(7):
        for c in range(C):
            yv = _fma32(wo[k, c].expand_as(yv), a[:, k:k + T, c], yv)
    return torch.tanh(yv).bfloat16()


def _assert_bf16_close(got, want, share):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * max(1.0, want.float().abs().max().item()), err
    assert (got == want).float().mean().item() >= share


@pytest.mark.parametrize("C", [8, 12, 20, 24, 32])
def test_tail_bf16_sums_match_the_plain_tail(C):
    """At 2.5x init the emulated kernel against ``legacy_tail_plain_bf16``;
    at 5x its relative L2 to the float64 chain within chip_smoke.py's ratio
    of the plain version's. C = 32 is the wide route's width."""
    rng = np.random.default_rng([C, 5])
    x = _t(rng, (1, C, 700)).bfloat16()
    for std, check in ((0.05, "plain"), (0.1, "float64")):
        w = _bf16_weights(rng, C, std)
        with torch.no_grad():
            got = tail_bf16_emulated(x, lt.pack_bf16(w))
            plain = lt.legacy_tail_plain_bf16(x, w)
        if check == "plain":
            _assert_bf16_close(got, plain, 0.95)
        else:
            exact = lt.legacy_tail_plain(x.double(), lt.TailWeights(*(t.double() for t in w)))
            rel = lambda a: ((a.double() - exact).norm() / exact.norm()).item()
            assert rel(got) <= TAIL_BF16_F64_RATIO * rel(plain), (rel(got), rel(plain))


@pytest.mark.parametrize("poly", [True, False])
def test_tail_bf16_sums_match_the_pallas_tail(poly, monkeypatch):
    """JAX's Pallas tail in interpret mode on bf16 input and bf16 weights
    (2.5x init), its tile cut to 256 so that T = 600 spans several tiles."""
    C, T = 24, 600
    rng = np.random.default_rng(13)
    w = _bf16_weights(rng, C, 0.05)
    f = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    units = [{"alpha1": f(w.a1[u]), "conv1": {"w": f(w.w1[u].permute(2, 1, 0)), "b": f(w.b1[u])},
              "alpha2": f(w.a2[u]), "conv2": {"w": f(w.w2[u].t()[None]), "b": f(w.b2[u])}}
             for u in range(3)]
    out_conv = {"w": f(w.wo.permute(2, 1, 0)), "b": f(w.bo)}
    x = _t(rng, (1, C, T)).bfloat16()
    monkeypatch.setattr(pk_tail, "TILE", 256)
    if poly:
        want = pk_tail.legacy_tail_poly_ct(f(x[..., 0::2]), f(x[..., 1::2]), units, f(w.ao),
                                           out_conv, interpret=True)[..., 0]
    else:
        want = pk_tail.legacy_tail_ct(f(x), units, f(w.ao), out_conv, interpret=True)[..., 0]
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        got = tail_bf16_emulated(x, lt.pack_bf16(w))
    assert 0.1 < want.float().abs().mean().item()
    _assert_bf16_close(got, want, 0.95)


def _assert_bf16_packed_from(p: torch.Tensor, w: lt.TailWeights) -> None:
    """p holds, bit for bit: the k7 weights folded (column 8 C8 tap + c),
    w2, zero past C, in fragment order; then the fp32 vectors."""
    C = w.ao.shape[0]
    C8, P, J1 = lt.bf16_shape(C)
    Cp = 8 * C8
    assert p.dtype == torch.uint8 and p.shape == (lt.packed_bytes_bf16(C),) and p.is_contiguous()
    w1, w2, v = _unpack_bf16(p, C)
    want1 = torch.zeros(3, 16 * P, 7, Cp, dtype=torch.bfloat16)
    want1[:, :C, :, :C] = w.w1.permute(0, 1, 3, 2)
    assert torch.equal(w1[:, :, :7 * Cp], want1.view(3, 16 * P, 7 * Cp))
    assert not w1[:, :, 7 * Cp:].any()
    assert torch.equal(w2[:, :C, :C], w.w2) and not w2[:, C:].any() and not w2[:, :, C:].any()
    wf = lt.TailWeights(*(t.float() for t in w))
    pad = lambda t: F.pad(t, (0, Cp - C))
    rc = lambda a: pad(1.0 / (a + EPS))
    want_v = torch.cat([t.reshape(-1) for t in (
        pad(wf.b1), pad(wf.a1), rc(wf.a1), pad(wf.a2), rc(wf.a2), pad(wf.b2), pad(wf.ao),
        rc(wf.ao), pad(wf.wo[0].t()), F.pad(wf.bo, (0, 3)))])
    assert torch.equal(v, want_v)


def test_bf16_tail_pack_is_bit_for_bit_cached_and_rebuilt():
    """The bf16 decoder's ``tail_prepared`` holds ``pack_bf16`` (``pack`` of
    bf16 weights), cached; rebuilt after ``load_state_dict`` and an in-place
    change; never cached for inference tensors."""
    dec = get_model("debug", device="cpu", seed=0, dtype=torch.bfloat16).codec.decoder
    with torch.no_grad():
        p = dec.tail_prepared()
        assert torch.equal(p.packed, lt.pack_bf16(dec.tail_weights()))
        _assert_bf16_packed_from(p.packed, dec.tail_weights())
        assert dec.tail_prepared() is p
        dec.load_state_dict(get_model("debug", device="cpu", seed=7,
                                      dtype=torch.bfloat16).codec.decoder.state_dict())
        q = dec.tail_prepared()
        assert q is not p and not torch.equal(q.packed, p.packed)
        _assert_bf16_packed_from(q.packed, dec.tail_weights())
        dec.tail_units[1].conv1.weight.mul_(2.0)
        r = dec.tail_prepared()
        assert r is not q
        _assert_bf16_packed_from(r.packed, dec.tail_weights())
        tw = _bf16_weights(np.random.default_rng(4), 20, 0.05)
        packed = lt.prepared_tail(tw)
        _assert_bf16_packed_from(packed, tw)
        assert lt.prepared_tail(tw) is packed
    with torch.inference_mode():
        tw = lt.TailWeights(*(t.clone() for t in tw))
        assert lt.prepared_tail(tw) is not lt.prepared_tail(tw)
