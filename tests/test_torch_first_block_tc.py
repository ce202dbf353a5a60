"""The arithmetic of the tensor-core stem kernel (``csrc/first_block.cu``)
modelled in PyTorch on the CPU, and the stem weights it takes, packed once.

- ``first_block_emulated`` computes as the kernel does, tile by tile from
  the tile's staged audio alone (128 columns and a 47-sample halo, zero
  outside [0, T)): the max pools from running maxima over 4, 8 and 16
  samples, the average pools summed in index order, each pooled signal zero
  outside [0, T); the k7 branch convs as fp32 FMAs in tap order; product 1
  (K 20 padded to 24) and product 2 (the hidden axis permuted as the kernel
  hands product 1's accumulator to product 2) as 3 TF32 passes through
  ``tc_gemm.gemm_emulated``, with b1 and the exact GELU between them; the
  raw sample's column, b2 and the output in fp32. Held against the float64
  plain stem within 3x the fp32 plain version's own error, at init-scale
  weights and x50, at T = 1, below the halo, at ragged last tiles, on the
  columns each side of every tile boundary and on the first and last three;
  and against the JAX package's jnp stem.
- ``pack`` holds W1 and W2 in fragment order, split into TF32 hi / lo: un-
  permuted and un-split they are the weights within TF32 rounding, the pads
  are zero, and Cout 8, 12 and 24 pack to the kernel's sizes.
- ``FirstBlock.prepared`` and ``prepared_stem`` cache the pack, rebuild it
  after ``load_state_dict`` and an in-place ``mul_``, never cache it for
  inference tensors, and a warm forward on the kernel's route stacks and
  packs nothing; on the CPU the forward is the plain stem on the live
  parameters, with their gradients.
- ``tools/first_block_variants.py``'s text substitutions apply to the
  kernel's source, and the tool needs the card.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from l3ac_tpu.models import tconv as jt
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.tconv import FirstBlock
from l3ac_tpu_torch.ops.activations import gelu
from l3ac_tpu_torch.ops.kernels import first_block as fb
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_emulated, tf32_rna

TOL = 1e-4   # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
TILE, HALO = fb.TILE, fb.HALO
ALEN = TILE + 6   # a pooled branch signal of a tile, with the k7 conv's halo


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, Cout, scale=1.0):
    return fb.FirstBlockWeights(_t(rng, (5, 4, 7), 0.4 * scale), _t(rng, (5, 4), 0.1 * scale),
                                _t(rng, (80, 20), 20 ** -0.5 * scale), _t(rng, (80,), 0.1 * scale),
                                _t(rng, (Cout, 81), 81 ** -0.5 * scale),
                                _t(rng, (Cout,), 0.1 * scale))


def _fma(a, b, c):
    """fp32 fmaf: the exact product and sum, rounded once (to float64, then
    fp32; the double rounding can differ from the card's in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _running_max(a, n):
    """max of a[i .. i + n) for every i where it fits."""
    return a.unfold(-1, n, 1).amax(-1)


# the kernel's permutation of product 2's K axis: k = t of step j is hidden
# unit 8j + 2t, k = t + 4 is 8j + 2t + 1
PERM = torch.tensor([8 * j + (2 * k if k < 4 else 2 * (k - 4) + 1)
                     for j in range(10) for k in range(8)])


def _tile(x, w, t0, T):
    """One tile of the kernel: output columns t0 .. t0 + TILE of x (B, T)."""
    B, Cout = x.shape[0], w.w2.shape[0]
    lo, hi = t0 - HALO, t0 + TILE + HALO
    xs = F.pad(x[:, max(lo, 0):min(hi, T)], (max(-lo, 0), max(hi - T, 0)))   # (B, TILE + 94)
    m4 = _running_max(xs.abs(), 4)
    m8 = torch.maximum(m4[:, :-4], m4[:, 4:])
    m16 = torch.maximum(m8[:, :-8], m8[:, 8:])
    branches = [xs[:, HALO - 3:HALO - 3 + ALEN]]                 # k = 1: the raw signal
    for k in fb.POOLS[1:]:
        p = k // 2
        r = torch.arange(ALEN + 2 * p)
        s = r + HALO - 3 - 2 * p
        if k == 5:
            m = torch.maximum(m4[:, s], m4[:, s + 1])
        elif k == 11:
            m = torch.maximum(m8[:, s], m8[:, s + 3])
        elif k == 21:
            m = torch.maximum(m16[:, s], m16[:, s + 5])
        else:
            m = torch.maximum(torch.maximum(m16[:, s], m16[:, s + 16]), m16[:, s + 29])
        v = t0 - 3 - p + r
        m = torch.where((v >= 0) & (v < T), m, 0.0)
        acc = m[:, :ALEN]
        for d in range(1, k):
            acc = acc + m[:, d:d + ALEN]
        u = t0 - 3 + torch.arange(ALEN)
        branches.append(torch.where((u >= 0) & (u < T), acc / k, 0.0))
    H = torch.zeros(B, TILE, 24)
    for br, a in enumerate(branches):
        for c in range(4):
            h = w.branch_b[br, c].expand(B, TILE)
            for k in range(7):
                h = _fma(w.branch_w[br, c, k].expand(B, TILE), a[:, k:k + TILE], h)
            H[:, :, 4 * br + c] = h
    w1 = F.pad(w.w1, (0, 4))                                          # K 20 -> 24
    Cp = fb.padded_cout(Cout)
    w2 = F.pad(w.w2[:, :80], (0, 0, 0, Cp - Cout))[:, PERM]
    out = torch.empty(B, Cout, TILE)
    for b in range(B):
        z = gemm_emulated(H[b], w1, bias=w.b1)                       # (TILE, 80)
        y = gemm_emulated(gelu(z)[:, PERM], w2)[:, :Cout] + w.b2      # (TILE, Cout)
        xt = xs[b, HALO:HALO + TILE]
        out[b] = _fma(w.w2[:, 80][:, None], xt[None], y.t())
    return out


def first_block_emulated(x: torch.Tensor, w: fb.FirstBlockWeights) -> torch.Tensor:
    """csrc/first_block.cu's sums on x (B, T) -> (B, Cout, T)."""
    T = x.shape[1]
    tiles = [_tile(x, w, t0, T) for t0 in range(0, T, TILE)]
    return torch.cat(tiles, -1)[..., :T]


def _float64(w: fb.FirstBlockWeights) -> fb.FirstBlockWeights:
    return fb.FirstBlockWeights(*(t.double() for t in w))


def _errors(x, w):
    """(model, fp32 plain) max abs errors against the float64 plain stem, and
    the model's and the float64 outputs. The plain version's error is taken
    as at least one fp32 ulp of the largest output: with few outputs (T = 1)
    it can fall below one rounding, which no fp32 sum can promise."""
    with torch.no_grad():
        exact = fb.first_block_plain(x.double(), _float64(w))
        plain = fb.first_block(x, w)
        got = first_block_emulated(x, w)
    assert got.shape == exact.shape and torch.isfinite(got).all()
    ulp = 2.0 ** -23 * exact.abs().max().item()
    return ((got.double() - exact).abs().max().item(),
            max(ulp, (plain.double() - exact).abs().max().item()), got, exact)


@pytest.mark.parametrize("B,T,Cout,scale", [
    (2, 2 * TILE + HALO, 24, 1.0), (1, 3 * TILE + 5, 24, 50.0), (2, 300, 8, 50.0),
    (1, 1, 24, 1.0), (2, 30, 12, 50.0), (1, TILE - 1, 64, 1.0), (1, TILE + 1, 1, 50.0)])
def test_stem_sums_are_as_accurate_as_fp32(B, T, Cout, scale):
    rng = np.random.default_rng([B, T, Cout, int(scale)])
    w = _weights(rng, Cout, scale)
    x = _t(rng, (B, T), 0.5)
    e_model, e_plain, _, exact = _errors(x, w)
    assert e_model <= 3 * e_plain, (e_model, e_plain)
    assert e_model <= TOL * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize("T", [2 * TILE + HALO, 4 * TILE - 2])
def test_stem_tile_boundaries_and_edges(T):
    """The columns on each side of every tile boundary and the first and last
    three, at weights x50: a halo short of 47 samples, or a pooled signal not
    zeroed outside [0, T), would leave them by a share of the output."""
    rng = np.random.default_rng(T)
    w = _weights(rng, 24, 50.0)
    x = _t(rng, (2, T), 0.5)
    e_model, e_plain, got, exact = _errors(x, w)
    cols = [0, 1, 2, T - 3, T - 2, T - 1]
    cols += [c for t0 in range(TILE, T, TILE) for c in (t0 - 2, t0 - 1, t0, t0 + 1)]
    err = (got[..., cols].double() - exact[..., cols]).abs().max().item()
    assert err <= 3 * e_plain, (err, e_plain)
    assert exact.abs().max().item() > 50


def test_the_model_matches_the_jax_stem():
    """The model against the JAX package's jnp stem at weights x50, T = 300
    (three tiles), within 1e-6 of the output scale, as the plain stem is held
    in tests/test_torch_kernels.py."""
    jp = jax.tree.map(lambda a: a * 50.0, jt.init_first_block(jax.random.PRNGKey(1), 24))
    x = _t(np.random.default_rng(9), (2, 300, 1))
    want = np.asarray(jt.first_block_apply(jp, jnp.asarray(x.numpy())))         # (B, T, C)
    m = FirstBlock(24)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in weights.convert_subtree(jp).items()})
    with torch.no_grad():
        got = first_block_emulated(x[..., 0], m.kernel_weights()).transpose(1, 2).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


def _unpack(p: torch.Tensor, Cout: int):
    """pack's buffer back to (W1 (80, 24), W2 (Cp, 80), the hi parts, the
    vectors), un-permuted and hi + lo summed in float64."""
    Cp = fb.padded_cout(Cout)
    shapes = fb.sections(Cout)
    parts = dict(zip(shapes, p.split([int(np.prod(s)) for s in shapes.values()])))
    parts = {k: v.view(shapes[k]) for k, v in parts.items()}
    f1, f2 = parts.pop("w1").double(), parts.pop("w2").double()
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    w1 = torch.zeros(80, 24, dtype=torch.float64)
    for j in range(10):
        for ks in range(3):
            w1[8 * j + g, 8 * ks + t] = f1[j, ks, :, 0] + f1[j, ks, :, 2]
            w1[8 * j + g, 8 * ks + t + 4] = f1[j, ks, :, 1] + f1[j, ks, :, 3]
    w2 = torch.zeros(Cp, 80, dtype=torch.float64)
    for j in range(10):
        for nt in range(Cp // 8):
            w2[8 * nt + g, 8 * j + 2 * t] = f2[j, nt, :, 0] + f2[j, nt, :, 2]
            w2[8 * nt + g, 8 * j + 2 * t + 1] = f2[j, nt, :, 1] + f2[j, nt, :, 3]
    his = torch.cat([f1.reshape(-1, 4)[:, :2], f2.reshape(-1, 4)[:, :2]]).float()
    return w1, w2, his, parts


@pytest.mark.parametrize("Cout", [8, 12, 24])
def test_pack_holds_the_weights_in_fragment_order(Cout):
    w = _weights(np.random.default_rng(Cout), Cout, 3.0)
    p = fb.pack(w)
    assert p.shape == (fb.packed_floats(Cout),) and p.is_contiguous()
    w1, w2, his, vecs = _unpack(p, Cout)
    assert torch.equal(his, tf32_rna(his))                  # the hi parts are TF32 values
    for got, want in ((w1[:, :20], w.w1), (w2[:Cout], w.w2[:, :80])):
        np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=2.0 ** -21, atol=0)
    assert not w1[:, 20:].any() and not w2[Cout:].any()     # K and Cout pads are zero
    Cp = fb.padded_cout(Cout)
    assert torch.equal(vecs["b1"], w.b1)
    assert torch.equal(vecs["b2"], F.pad(w.b2, (0, Cp - Cout)))
    assert torch.equal(vecs["wx"], F.pad(w.w2[:, 80], (0, Cp - Cout)))
    assert torch.equal(vecs["branch_w"], w.branch_w) and torch.equal(vecs["branch_b"], w.branch_b)


def test_pack_rejects_cout_above_64():
    """Above 64 output channels the pack pads Cout to whole tiles of 64 (the
    kernel's third grid axis walks them), at any Cout (ROADMAP C3: the cap of
    256 it raised above is gone); a bf16 stem above 256 channels packs its
    chunks of 256, each the pack of that chunk's stem. Weight shapes that do
    not match still raise."""
    assert fb.pack(_weights(np.random.default_rng(0), 65)).shape == (fb.packed_floats(65),)
    assert fb.padded_cout(65) == 128 and fb.padded_cout(64) == 64
    w = _weights(np.random.default_rng(0), 257)
    assert fb.pack(w).shape == (fb.packed_floats(257),)
    wb = fb.FirstBlockWeights(*(t.bfloat16() for t in _weights(np.random.default_rng(1), 600)))
    got = fb.pack(wb)
    parts = [fb.pack(wb._replace(w2=wb.w2[c0:c1], b2=wb.b2[c0:c1]))
             for c0, c1 in ((0, 256), (256, 512), (512, 600))]
    assert got.shape == (fb.packed_floats(600, True),) == (sum(p.numel() for p in parts),)
    assert torch.equal(got, torch.cat(parts))
    with pytest.raises(ValueError, match="weight shapes"):
        fb.pack(w._replace(b2=w.b2[:-1]))


def _stem(seed=0, Cout=24):
    stem = FirstBlock(Cout)
    stem.init_weights(torch.Generator().manual_seed(seed))
    return stem


def test_prepared_stem_is_pack_bit_for_bit_and_cached():
    stem = _stem()
    with torch.no_grad():
        p = stem.prepared()
        for got, want in zip(p.weights, stem.kernel_weights()):
            assert torch.equal(got, want)
        assert torch.equal(p.packed, fb.pack(stem.kernel_weights()))
        assert stem.prepared() is p
        w = _weights(np.random.default_rng(3), 12)
        packed = fb.prepared_stem(w)
        assert torch.equal(packed, fb.pack(w)) and fb.prepared_stem(w) is packed


def test_prepared_stem_follows_load_state_dict_and_in_place_changes():
    stem = _stem(0)
    with torch.no_grad():
        p = stem.prepared()
        stem.load_state_dict(_stem(7).state_dict())
        q = stem.prepared()
        assert q is not p and not torch.equal(q.packed, p.packed)
        assert torch.equal(q.packed, fb.pack(stem.kernel_weights()))
        stem.conv2.weight.mul_(2.0)
        r = stem.prepared()
        assert r is not q and torch.equal(r.packed, fb.pack(stem.kernel_weights()))
        stem.base.branches[3].bias.add_(0.5)
        assert stem.prepared() is not r


def test_prepared_stem_is_never_cached_for_inference_tensors():
    with torch.inference_mode():   # a stem built here holds inference tensors
        stem = _stem()
        assert stem.conv1.weight.is_inference()
        p, q = stem.prepared(), stem.prepared()
        assert p is not q and torch.equal(p.packed, q.packed)
        w = stem.kernel_weights()
        assert fb.prepared_stem(w) is not fb.prepared_stem(w)


def test_a_warm_forward_stacks_and_packs_no_stem_weight(monkeypatch):
    """On the kernel's route (taken here for CPU tensors, the launch replaced
    by a spy that runs the plain version on the weights it is handed)."""
    stem = _stem()
    params = list(stem.parameters())
    stacked, packs, launched = [], [], []
    stack, pack = torch.stack, fb.pack

    def spy_stack(ts, *a, **kw):
        stacked.extend(t for t in ts if any(t is p or t._base is p for p in params))
        return stack(ts, *a, **kw)

    def spy_pack(w):
        packs.append(w)
        return pack(w)

    def spy_launch(x, w):
        launched.append(w)
        return fb.first_block_plain(x, w.weights)

    x = _t(np.random.default_rng(0), (2, 200), 0.5)
    with torch.no_grad():
        want = fb.first_block_plain(x, stem.kernel_weights())
    monkeypatch.setattr(torch, "stack", spy_stack)
    monkeypatch.setattr(fb, "pack", spy_pack)
    import l3ac_tpu_torch.models.tconv as mtconv
    monkeypatch.setattr(mtconv, "pack", spy_pack)
    monkeypatch.setattr(fb.K, "route", lambda x, name: True)
    monkeypatch.setattr(fb, "_launch", spy_launch)
    with torch.no_grad():
        first = stem(x)
        assert stacked and len(packs) == 1       # built once, on the cold call
        stacked.clear()
        packs.clear()
        assert torch.equal(stem(x), first)
    assert not stacked and not packs
    assert len(launched) == 2 and launched[0] is launched[1] is stem.prepared()
    assert torch.equal(first, want)


def test_the_cpu_forward_is_the_plain_stem_on_the_live_parameters(monkeypatch):
    """On the CPU the stem runs the plain version on its parameters as they
    are, builds no pack, and its output carries gradients to every one."""
    import l3ac_tpu_torch.models.tconv as mtconv
    packs = []
    monkeypatch.setattr(mtconv, "pack", lambda w: packs.append(w))
    stem = _stem()
    x = _t(np.random.default_rng(1), (2, 200), 0.5)
    y = stem(x)
    assert not packs
    with torch.no_grad():
        assert torch.equal(y, fb.first_block_plain(x, stem.kernel_weights()))
    y.square().sum().backward()
    for name, p in stem.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_first_block_variants_tool_applies_to_the_kernel_and_needs_the_card():
    """tools/first_block_variants.py builds its variants by text substitution
    on the stem kernel's source: every substitution matches it exactly once;
    without CUDA the tool exits with a message, building nothing."""
    from l3ac_tpu_torch.tools import first_block_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    sources = {variant_source(tool.SOURCE, subs, "first_block_variants")
               for _, subs, _ in tool.VARIANTS}
    assert len(sources) == len(tool.VARIANTS)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])
