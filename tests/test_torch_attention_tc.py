"""The arithmetic of the tensor-core attention kernel (``csrc/local_attention.cu``)
modelled in PyTorch on the CPU, the position-bias table it reads, and the
model's way of calling it.

- ``attention_emulated`` sums as the kernel does: per window, key tiles of 64
  from the window's first valid key, S = (q * D^-0.5) K^T and O += P V as 3
  TF32 passes (``tc_gemm.gemm_emulated``: ``tf32_rna`` splits, mma steps that
  add toward zero, a fresh accumulator per K step of 32, so P V's 64 keys
  are two steps added into O one after the other), the bias from the (2n, H)
  Toeplitz table (or a full bias), the mask from the indices (window 0 and a
  ragged n included) and the online softmax (running max, 0 for a row with
  no valid key yet, rescaled sum and output). Held against the float64 plain
  attention within 3x the fp32 plain version's own error.
- ``dynamic_position_table`` expands to ``dynamic_position_bias`` bit for
  bit, and to JAX's ``dynamic_position_bias`` within 1e-6 of the bias's
  scale (its entries reach ~100 at n = 250).
- The CPU wrapper gives bit-identical output for the model's strided head
  views and for contiguous copies, and for the table and its expansion.
- ``Attention.forward`` hands the kernel views of its projection and the
  output projection a view of the kernel's output: no head copies.
- ``LocalTrans`` on ``debug``'s widths with the table path against JAX's jnp
  layer stack.
- ``tools/attention_variants.py``'s text substitutions apply to the kernel's source,
  and the tool needs the card.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l3ac_tpu.models import local_transformer as jlt
from l3ac_tpu.ops import attention as jattn
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models import local_transformer as tlt
from l3ac_tpu_torch.ops import attention as tattn
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.ops.kernels.tc_gemm import K_STEP, gemm_emulated
from _torch_threads import one_thread  # noqa: F401

TOL = 1e-4   # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
KEYS = 64    # keys per tile (csrc/local_attention.cu kKeys)


pytestmark = pytest.mark.usefixtures("one_thread")


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def attention_emulated(q, k, v, n, bias=None, table=None):
    """csrc/local_attention.cu's sums on q, k, v (B, H, T, D); bias (H, n, 2n)
    or table (2n, H). Tiles past a row's causal limit hold only masked keys,
    which leave its max, sum and output exactly as they were, so every row of
    a window walks the same tiles here."""
    B, H, T, D = q.shape
    out = torch.empty(B, H, T, D)
    i = torch.arange(n)[:, None]
    scale = D ** -0.5
    for b in range(B):
        for h in range(H):
            for w in range(T // n):
                qs = q[b, h, w * n:(w + 1) * n] * scale
                lo = max(0, (w - 1) * n)
                keys = k[b, h, lo:(w + 1) * n]
                vals = v[b, h, lo:(w + 1) * n]
                j_begin = n if w == 0 else 0
                if w == 0:   # the missing previous window: key j = n is row 0
                    keys = torch.cat([torch.zeros(n, D), keys])
                    vals = torch.cat([torch.zeros(n, D), vals])
                m = torch.full((n, 1), float("-inf"))
                l = torch.zeros(n, 1)
                o = torch.zeros(n, D)
                for j0 in range(j_begin, 2 * n, KEYS):
                    kt, vt = keys[j0:j0 + KEYS], vals[j0:j0 + KEYS]
                    j = torch.arange(j0, j0 + kt.shape[0])[None, :]
                    s = gemm_emulated(qs, kt)
                    if table is not None:
                        s = s + table[(n + i - j).clamp(0, 2 * n - 1), h]
                    elif bias is not None:
                        s = s + bias[h, :, j0:j0 + kt.shape[0]]
                    s = torch.where(j <= n + i, s, float("-inf"))
                    m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                    mu = torch.where(m_new == float("-inf"), 0.0, m_new)
                    c = torch.exp(m - mu)
                    p = torch.exp(s - mu)
                    m = m_new
                    l = l * c + p.sum(1, keepdim=True)
                    o = o * c
                    for k0 in range(0, kt.shape[0], K_STEP):
                        o = o + gemm_emulated(p[:, k0:k0 + K_STEP].contiguous(),
                                              vt[k0:k0 + K_STEP].t().contiguous())
                out[b, h, w * n:(w + 1) * n] = o / l
    return out


@pytest.mark.parametrize("n,B,H,W,D,mode", [
    (16, 2, 2, 3, 32, "table"), (16, 1, 2, 3, 8, "full"), (100, 1, 2, 2, 32, "table"),
    (250, 1, 1, 2, 32, "table"), (750, 1, 1, 2, 32, "table"), (750, 1, 2, 2, 32, "mlp")])
def test_attention_sums_are_as_accurate_as_fp32(n, B, H, W, D, mode):
    """``mlp``: the table of a position-bias MLP with chip_smoke.py's seeded
    weights, whose entries reach hundreds, so that the fp32 rounding of the
    scores themselves dominates both versions' error."""
    rng = np.random.default_rng([n, D])
    q, k, v = (_t(rng, (B, H, W * n, D)) for _ in range(3))
    table = _t(rng, (2 * n, H)) if mode == "table" else None
    if mode == "mlp":
        d = 64
        mlp = {"w0": _t(rng, (d, 1)), "b0": _t(rng, (d,), 0.5), "w1": _t(rng, (d, d), d ** -0.5),
               "b1": _t(rng, (d,), 0.1), "w2": _t(rng, (H, d), d ** -0.5), "b2": _t(rng, (H,), 0.1)}
        table = tattn.dynamic_position_table(mlp, n)
        assert table.abs().max() > 100
    bias = _t(rng, (H, n, 2 * n)) if mode == "full" else tattn.expand_position_table(table)
    with torch.no_grad():
        exact = tattn.local_attention(q.double(), k.double(), v.double(), window_size=n,
                                      bias=bias.double())
        plain = tattn.local_attention(q, k, v, window_size=n, bias=bias)
        got = attention_emulated(q, k, v, n, bias=bias if mode == "full" else None,
                                 table=table)
    e_model = (got.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    assert e_model <= 3 * e_plain, (e_model, e_plain)
    assert e_model <= TOL * max(1.0, exact.abs().max().item())


def _dyn_params(rng, dim, heads):
    d = dim // 2
    jp = {"w0": rng.standard_normal((1, d)), "b0": rng.standard_normal(d) * 0.5,
          "w1": rng.standard_normal((d, d)) * d ** -0.5, "b1": rng.standard_normal(d) * 0.1,
          "w2": rng.standard_normal((d, heads)) * d ** -0.5,
          "b2": rng.standard_normal(heads) * 0.1}
    jp = {key: val.astype(np.float32) for key, val in jp.items()}
    tp = {key: torch.from_numpy(val.T.copy() if val.ndim == 2 else val) for key, val in jp.items()}
    return {key: jnp.asarray(val) for key, val in jp.items()}, tp


@pytest.mark.parametrize("n", [16, 250])
def test_dynamic_position_table_expands_to_the_bias(n):
    jp, tp = _dyn_params(np.random.default_rng(n), 32, 6)
    table = tattn.dynamic_position_table(tp, n)
    assert table.shape == (2 * n, 6)
    bias = tattn.expand_position_table(table)
    assert torch.equal(bias, tattn.dynamic_position_bias(tp, n))
    want = np.asarray(jattn.dynamic_position_bias(jp, n))
    assert np.abs(bias.numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_cpu_wrapper_is_bit_identical_for_strided_views_and_the_table():
    B, T, H, D, n = 2, 48, 3, 8, 16
    rng = np.random.default_rng(7)
    qkv = _t(rng, (B, T, 3 * H * D))
    views = [c.view(B, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1)]
    copies = [t.contiguous() for t in views]
    assert not views[0].is_contiguous()
    table = _t(rng, (2 * n, H))
    bias = tattn.expand_position_table(table)
    got = la.local_attention(*views, window_size=n, bias_table=table)
    assert torch.equal(got, la.local_attention(*copies, window_size=n, bias_table=table))
    assert torch.equal(got, la.local_attention(*copies, window_size=n, bias=bias))
    with pytest.raises(ValueError, match="not both"):
        la.local_attention(*views, window_size=n, bias=bias, bias_table=table)


def test_attention_forward_makes_no_head_copies(monkeypatch):
    """The kernel gets q, k, v as views of the qkv projection's output, and
    the output projection gets a view of what the kernel returned."""
    tc = tlt.TransConfig(dim=32, depth=1, window_size=16)
    attn = tlt.Attention(tc)
    for lin in (attn.qkv, attn.out):
        torch.nn.init.normal_(lin.weight, std=0.2)
    seen = {}
    attn.qkv.register_forward_hook(lambda mod, inp, out: seen.update(qkv=out))
    attn.out.register_forward_pre_hook(lambda mod, inp: seen.update(merged=inp[0]))
    plain = tlt.local_attention

    def spy(q, k, v, **kw):
        seen["heads"] = (q, k, v)
        out = plain(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        seen["out"] = out.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        return seen["out"]   # (B, H, T, D) over a (B, T, H, D) tensor, as on the card

    monkeypatch.setattr(tlt, "local_attention", spy)
    x = _t(np.random.default_rng(0), (2, 32, 32))
    table = _t(np.random.default_rng(1), (32, tc.heads))
    with torch.no_grad():
        attn(x, table)
    base = seen["qkv"].untyped_storage().data_ptr()
    for t in seen["heads"]:
        assert t.untyped_storage().data_ptr() == base and not t.is_contiguous()
    assert seen["merged"].untyped_storage().data_ptr() == \
        seen["out"].untyped_storage().data_ptr()


def test_local_trans_table_path_matches_jax():
    """debug's transformer widths (dim 32, window 16, ragged T) with the bias
    cache holding the table, against JAX's jnp stack with its (H, n, 2n)
    cache."""
    jtc = jlt.TransConfig(dim=32, depth=2, window_size=16)
    p = jlt.attach_bias_cache(jlt.init_local_trans(jax.random.PRNGKey(5), jtc), jtc)
    trans = tlt.LocalTrans(tlt.TransConfig(dim=32, depth=2, window_size=16))
    sd = weights.convert_subtree({k: v for k, v in p.items() if k != "bias_cache"})
    trans.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    trans.attach_bias_cache()
    assert trans.bias_cache.shape == (32, 6)
    x = np.random.default_rng(5).standard_normal((2, 45, 32)).astype(np.float32)
    want = np.asarray(jlt.local_trans_apply(p, jnp.asarray(x), jtc))
    with torch.no_grad():
        got = trans(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_attention_variants_tool_applies_to_the_kernel_and_needs_the_card():
    """tools/attention_variants.py builds its variants by text substitution on the attention
    kernel's source: every substitution matches it exactly once; without CUDA
    the tool exits with a message, building nothing."""
    from l3ac_tpu_torch.tools import attention_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    sources = {variant_source(tool.SOURCE, subs, "attention_variants") for _, subs, _ in tool.VARIANTS}
    assert len(sources) == len(tool.VARIANTS)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])
