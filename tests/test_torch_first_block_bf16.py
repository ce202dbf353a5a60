"""The arithmetic of the bf16 stem kernel (``csrc/first_block_bf16.cu``)
modelled in PyTorch on the CPU.

- ``first_block_bf16_emulated`` computes as the kernel does, tile by tile
  from the tile's staged audio alone (128 columns and a 47-sample halo of
  bf16 samples in fp32, zero outside [0, T)): the max pools from running
  maxima over 4, 8 and 16 samples, the average pools summed in index order
  and divided by k, each pooled signal zero outside [0, T); the k7 branch
  convs as fp32 FMAs in tap order, rounded to bf16 into product 1's k slots
  (``first_block.k_slot``, the order of each lane's A fragments); product 1
  on bf16 operands with fp32 sums, b1 and the exact GELU in fp32, the 80
  activations rounded to bf16, product 2
  likewise, the raw sample's column and b2 in fp32, the output rounded to
  bf16. Held against ``first_block_plain_bf16`` within the bf16 kernels'
  tolerance (2^-6 x max(1, max |plain|)) across tile boundaries, at the
  sequence edges, at ragged T and at Cout above 64; and against the JAX
  package's jnp stem in bf16.
- ``pack``'s bf16 fragments read through ``k_slot`` unpack to W1 and W2.
- ``tools/first_block_variants.py --bf16``'s substitutions apply once.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_thread  # noqa: F401
from l3ac_tpu.models import tconv as jt
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.tconv import FirstBlock
from l3ac_tpu_torch.ops.activations import gelu
from l3ac_tpu_torch.ops.kernels import first_block as fb

pytestmark = pytest.mark.usefixtures("one_thread")

TILE, HALO = fb.TILE_BF16, fb.HALO
ALEN = TILE + 6
TOL = 2.0 ** -6      # chip_smoke.py: bf16 kernels within 2^-6 x max(1, max |plain|)


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, Cout, scale=1.0):
    w = fb.FirstBlockWeights(_t(rng, (5, 4, 7), 0.4 * scale), _t(rng, (5, 4), 0.1 * scale),
                             _t(rng, (80, 20), 20 ** -0.5 * scale), _t(rng, (80,), 0.1 * scale),
                             _t(rng, (Cout, 81), 81 ** -0.5 * scale),
                             _t(rng, (Cout,), 0.1 * scale))
    return fb.FirstBlockWeights(*(t.bfloat16() for t in w))


def _fma(a, b, c):
    """fp32 fmaf: the exact product and sum, rounded once (through float64)."""
    return (a.double() * b.double() + c.double()).float()


def _bf16(t):
    return t.bfloat16().float()


def _products(a, w):
    """bf16 operands, fp32 sums (exact in float64, rounded once): a (.., K) w (N, K)^T."""
    return (a.double() @ w.double().t()).float()


def _tile(x, w, t0, T):
    """One tile of the kernel: output columns t0 .. t0 + TILE of x (B, T) bf16."""
    B, Cout = x.shape[0], w.w2.shape[0]
    wf = fb.FirstBlockWeights(*(t.float() for t in w))
    lo, hi = t0 - HALO, t0 + TILE + HALO
    xs = F.pad(x.float()[:, max(lo, 0):min(hi, T)], (max(-lo, 0), max(hi - T, 0)))
    m4 = xs.abs().unfold(-1, 4, 1).amax(-1)
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
    H = torch.zeros(B, TILE, 32)                                  # product 1's K, bf16 values
    for br, a in enumerate(branches):
        for c in range(4):
            h = wf.branch_b[br, c].expand(B, TILE)
            for k in range(7):
                h = _fma(wf.branch_w[br, c, k].expand(B, TILE), a[:, k:k + TILE], h)
            H[:, :, fb.k_slot(br, c)] = _bf16(h)
    W1 = torch.zeros(80, 32)
    for br in range(5):
        for c in range(4):
            W1[:, fb.k_slot(br, c)] = wf.w1[:, 4 * br + c]
    z = _products(H, W1) + wf.b1                                  # (B, TILE, 80)
    g = _bf16(gelu(z))
    y = _products(g, wf.w2[:, :80]) + wf.b2                       # (B, TILE, Cout)
    xt = xs[:, HALO:HALO + TILE]
    return _fma(wf.w2[:, 80][None, :, None], xt[:, None, :], y.transpose(1, 2)).bfloat16()


def first_block_bf16_emulated(x: torch.Tensor, w: fb.FirstBlockWeights) -> torch.Tensor:
    """csrc/first_block_bf16.cu's sums on bf16 x (B, T) -> bf16 (B, Cout, T)."""
    T = x.shape[1]
    return torch.cat([_tile(x, w, t0, T) for t0 in range(0, T, TILE)], -1)[..., :T]


def _check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("B,T,Cout", [
    (2, 2 * TILE + HALO, 24), (1, 3 * TILE + 5, 24), (2, 1, 24), (1, 30, 12),
    (1, TILE - 1, 80), (1, TILE + 1, 136), (2, 2 * TILE, 1)])
def test_stem_bf16_sums_match_the_plain_bf16_stem(B, T, Cout):
    """Tile boundaries (every T above spans one or more), the first and last
    columns (where the pooled signals are zeroed outside [0, T)), a T below
    the halo, ragged last tiles, and Cout above 64 (the kernel walks 64
    channels at a time; pack pads to whole chunks)."""
    rng = np.random.default_rng([B, T, Cout])
    w = _weights(rng, Cout)
    x = _t(rng, (B, T), 0.3).bfloat16()
    with torch.no_grad():
        got, want = first_block_bf16_emulated(x, w), fb.first_block_plain(x, w)
    _check(got, want)
    _check(torch.cat([got[..., :8], got[..., -8:]], -1),
           torch.cat([want[..., :8], want[..., -8:]], -1))
    if T >= TILE:   # the columns on each side of every tile boundary
        cols = torch.tensor([c for t0 in range(TILE, T, TILE) for c in (t0 - 1, t0) if c < T])
        _check(got[..., cols], want[..., cols])


def test_stem_bf16_kernel_sums_match_jax_bf16_stem():
    """The emulated kernel and JAX's jnp stem in bf16 on the same seeded
    weights: relative L2 within two bf16 ulps (the tolerance of
    tests/test_torch_bf16.py)."""
    rng = np.random.default_rng(5)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
                      jt.init_first_block(jax.random.PRNGKey(2), 24))
    x = (rng.standard_normal((2, 700)) * 0.3).astype(np.float32)
    want = np.asarray(jt.first_block_apply(jp, jnp.asarray(x).astype(jnp.bfloat16)[..., None])
                      .astype(jnp.float32))                                       # (B, T, C)
    m = FirstBlock(24)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in weights.convert_subtree(jp).items()})
    m = m.to(torch.bfloat16)
    with torch.no_grad():
        got = first_block_bf16_emulated(torch.from_numpy(x).bfloat16(), m.kernel_weights())
    got = got.float().transpose(1, 2).numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= TOL


def _unpack_bf16(p, Cout):
    """pack's bf16 W1 / W2 fragments back to (80, 32) and (Cp, 80) fp32:
    lane (g, t) holds k = 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of its
    k16 step for row 8 j + g."""
    shapes = fb.sections(Cout, bf16=True)
    parts = dict(zip(shapes, p.split([int(np.prod(s)) for s in shapes.values()])))
    halves = lambda f: torch.stack([(f.view(torch.int32) << 16).view(torch.float32),
                                    (f.view(torch.int32) & -65536).view(torch.float32)], -1)
    f1 = halves(parts["w1"].view(shapes["w1"]))                  # (10, 2, 32, 2, 2)
    f2 = halves(parts["w2"].view(shapes["w2"]))                  # (5, Cp / 8, 32, 2, 2)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    W1 = torch.zeros(80, 32)
    for j in range(10):
        for s in range(2):
            for r in range(2):
                for i in range(2):
                    W1[8 * j + g, 16 * s + 8 * r + 2 * t + i] = f1[j, s, :, r, i]
    Cp = f2.shape[1] * 8
    W2 = torch.zeros(Cp, 80)
    for s in range(5):
        for nt in range(Cp // 8):
            for r in range(2):
                for i in range(2):
                    W2[8 * nt + g, 16 * s + 8 * r + 2 * t + i] = f2[s, nt, :, r, i]
    return W1, W2


@pytest.mark.parametrize("Cout", [24, 80])
def test_bf16_pack_read_through_k_slot_unpacks_to_the_weights(Cout):
    """The kernel stores branch br's channel c at k = k_slot(br, c) of product
    1's K: pack's W1 fragments hold W1[:, 4 br + c] there and zeros in the
    slots no branch fills; its W2 fragments hold W2's 80 columns in order,
    Cout padded to whole chunks of 64 above 64."""
    w = _weights(np.random.default_rng(Cout), Cout, 3.0)
    W1, W2 = _unpack_bf16(fb.pack(w), Cout)
    slots = [fb.k_slot(br, c) for br in range(5) for c in range(4)]
    assert sorted(slots) == sorted(set(slots)) and max(slots) < 32
    assert torch.equal(W1[:, slots], w.w1.float())
    assert not W1[:, [k for k in range(32) if k not in slots]].any()
    assert torch.equal(W2[:Cout], w.w2[:, :80].float()) and not W2[Cout:].any()
    assert W2.shape[0] == fb.padded_cout(Cout)


def test_first_block_variants_bf16_substitutions_apply_once():
    """The new kernel's and the former kernel's variants in the tool's --bf16
    mode: every substitution matches its source exactly once."""
    from l3ac_tpu_torch.tools import first_block_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    for source, variants in ((tool.SOURCE_BF16, tool.VARIANTS_BF16),
                             (tool.SOURCE_PREV, tool.VARIANTS_PREV)):
        sources = {variant_source(source, subs, "first_block_variants") for _, subs, _ in variants}
        assert len(sources) == len(variants)
