"""The general routes' tensor-core kernels (``csrc/general.cu``: the product
and the attention) and their route rules, on the CPU.

- The product's sums as the kernel forms them, emulated in torch: A
  gathered by the kernel's address rule (two-level rows, the (channel, tap)
  split of K with the im2col shift, zero at the time edges), fp32 as 3xTF32
  m16n8k8 steps (``tc_gemm.gemm_emulated``: a fresh accumulator per K step
  of 32, each mma step added in fp32 toward zero), bf16 as m16n8k16 steps
  with the same K steps, then the epilogue; held against the plain product
  (``F.conv1d`` / einsum) at ragged M, N, K in both A layouts, k7 taps at
  dilations 1, 3, 9 and every epilogue.
- The attention's sums in the kernel's order: key tiles of 64 from the
  window's first key, each row group's 32-key halves on two warps with
  their own online softmax, merged at the end (bf16: a first pass for each
  row's max and sum, then the normalized P rounded to bf16); S over D in
  chunks of 64 columns in one accumulator, O over each slab of columns
  (``local_attention.general_slabs``) with each half's P V in a fresh
  accumulator (fp32); held against the plain
  version at D 1, 10, 18, 192, 320 with the table, the full bias, ``kp``,
  ``prev_k`` / ``prev_v``, ``left_edge`` and ``head_offset``, and once
  against the JAX package's jnp attention.
- The route rules: the released widths keep their fast kernels, every
  former general width runs on the tensor cores (the unit's and the
  contiguous (B, T, C) up path's products on the fast GEMM cores, the rest
  on ``general.cu``'s product), and ``general_gemm`` calls the entry point
  of its route with the epilogue's code.
- The fp32 up path's TF32 hi / lo buffer is ``split_tf32`` of W bit for
  bit; the staged hi + lo carries W to 2^-22.
- The row passes' sums (``csrc/general_rows.cu``, emulated by
  ``tests/_torch_rows.py``; held against the port's plain versions in
  ``tests/test_torch_general_rows.py``) against the JAX package's jnp
  ChannelNorm and upsample at C3 widths: the unit at C = 1280, the up path
  to Co = 200 at s = 2.

The kernels themselves run on the card in ``chip_smoke.py`` phase 12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from l3ac_tpu.ops import attention as jattn
from l3ac_tpu.ops.norms import channel_norm as jax_channel_norm
from l3ac_tpu.ops.resample import upsample_linear as jax_upsample
from l3ac_tpu_torch.ops import attention as tattn
from l3ac_tpu_torch.ops.activations import gelu, snake
from l3ac_tpu_torch.ops.kernels import _build
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import gemm_sm90
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels import local_attention as la
from l3ac_tpu_torch.ops.kernels import up_fused as uf
from l3ac_tpu_torch.ops.kernels.tc_gemm import (K_STEP, MMA_K, _add_rz, gemm_emulated, split_tf32,
                                                tf32_rna)
from _torch_rows import dw_norm_emulated, up_blend_norm_emulated
from _torch_threads import one_thread  # noqa: F401

TOL = 1e-4          # chip_smoke.py: fp32 max abs error <= TOL * max(1, max |plain|)
BF16_TOL = 2 ** -6  # bf16: two bf16 ulps of the scale
KEYS = 64           # general.cu kAKeys: keys a tile

pytestmark = pytest.mark.usefixtures("one_thread")


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _held(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err
    return err


# ------------------------------------------------------------------ product

def gather_a(a: torch.Tensor, a_map: tuple, M: int, K: int, taps: int = 1,
             dil: int = 1) -> torch.Tensor:
    """A (M, K) as the kernel stages it from ``a``'s storage: row m = (b, t)
    at ``b sb + t st``, k = (c, tap) at ``c sk`` shifted by ``(tap - taps /
    2) dil`` rows, zero outside [0, rows)."""
    rows, sb, st, sk = a_map
    m, k = torch.arange(M)[:, None], torch.arange(K)[None, :]
    b, t = m // rows, m % rows
    c, tap = k // taps, k % taps
    tt = t + (tap - taps // 2) * dil
    ok = (tt >= 0) & (tt < rows)
    idx = b * sb + tt.clamp(0, rows - 1) * st + c * sk
    return torch.where(ok, a.reshape(-1)[idx].float(), 0.0)


def _bf16_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands (exact in float64): m16n8k16 steps added toward zero,
    a fresh accumulator per K step of 32."""
    total = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], K_STEP):
        acc = torch.zeros_like(total)
        for k in range(k0, min(a.shape[1], k0 + K_STEP), MMA_K["bf16"]):
            acc = _add_rz(acc, a[:, k:k + 16].double() @ b[:, k:k + 16].double().T)
        total = total + acc
    return total


def product_emulated(A: torch.Tensor, B: torch.Tensor, bf16: bool, bias, act: int, alpha,
                     res, round_mid: bool) -> torch.Tensor:
    """general.cu's product on the staged A (M, K) and B (N, K): its sums,
    then bias, activation, round_mid and the residual in fp32, one rounding
    to the output's dtype."""
    v = _bf16_sums(A, B) if bf16 else gemm_emulated(A, B)
    return _epilogue(v, bias, act, alpha, res, round_mid, bf16)


def _epilogue(v, bias, act, alpha, res, round_mid, bf16):
    if bias is not None:
        v = v + bias
    if act == cu.ACT_SNAKE:
        v = snake(v, alpha)
    elif act == cu.ACT_GELU:
        v = gelu(v)
    elif act == cu.ACT_TANH:
        v = torch.tanh(v)
    if res is not None:
        if round_mid:
            v = v.bfloat16().float()
        v = res.float() + v
    return v.bfloat16() if bf16 else v


# (M, N, C, A layout, taps, dilation, epilogue): K = C taps
PRODUCTS = [
    (1, 7, 100, "cl", 1, 1, "bias"),
    (7, 100, 1040, "ct", 1, 1, "snake"),
    (100, 1, 1280, "cl", 1, 1, "gelu"),
    (100, 1040, 7, "ct", 1, 1, "residual"),
    (1280, 7, 1, "ct", 1, 1, "tanh"),
    (100, 100, 15, "ct", 7, 1, "bias"),
    (100, 100, 14, "ct", 7, 3, "round_mid"),
    (1040, 1, 13, "ct", 7, 9, "tanh"),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("M,N,C,layout,taps,dil,epi", PRODUCTS)
def test_product_sums_match_the_plain_product(M, N, C, layout, taps, dil, epi, dtype):
    bf16 = dtype == "bf16"
    rng = np.random.default_rng([M, N, C, taps, dil])
    B = 1 if M < 100 else 2
    T = M // B
    K = C * taps
    x = _t(rng, (B, C, T) if layout == "ct" else (B, T, C))
    w = _t(rng, (N, K), K ** -0.5)
    bias, alpha = _t(rng, (N,), 0.3), 1.0 + _t(rng, (N,), 0.2).abs()
    res = _t(rng, (M, N)) if epi in ("residual", "round_mid") else None
    act = {"snake": cu.ACT_SNAKE, "gelu": cu.ACT_GELU, "tanh": cu.ACT_TANH}.get(epi, cu.ACT_NONE)
    if bf16:
        x, w, res = x.bfloat16(), w.bfloat16(), None if res is None else res.bfloat16()
    a_map = (T, C * T, 1, T) if layout == "ct" else (T, T * C, C, 1)
    A = gather_a(x, a_map, M, K, taps, dil)
    # the staging rule against the layout's own im2col: x (B, C, T) padded and unfolded
    xt = x.float() if layout == "ct" else x.float().transpose(1, 2)
    pad = (taps // 2) * dil
    cols = F.unfold(F.pad(xt, (pad, pad))[:, :, None], (1, taps), dilation=(1, dil))
    assert torch.equal(A, cols.transpose(1, 2).reshape(M, K))
    got = product_emulated(A, w.float(), bf16, bias, act, alpha, res, epi == "round_mid")
    plain = _epilogue(A.double() @ w.double().T, bias.double(), act, alpha.double(),
                      None if res is None else res.double(), epi == "round_mid", bf16)
    _held(got, plain, BF16_TOL if bf16 else TOL)


def test_up_split_buffer_is_split_tf32_and_carries_the_weight():
    rng = np.random.default_rng(5)
    w = uf.UpWeights(_t(rng, (600, 1280), 0.03), _t(rng, (600,)), None, None)
    hi, lo = uf.prepare_up(w, "general_split")
    want_hi, want_lo = split_tf32(w.w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert torch.equal(hi, tf32_rna(w.w))
    staged = hi + lo          # what the product stages; each fp32 sum is exact
    assert torch.equal(staged.double(), hi.double() + lo.double())
    assert ((staged.double() - w.w.double()).abs() <= w.w.double().abs() * 2.0 ** -22).all()


# ---------------------------------------------------------------- attention

def _s_chain(qs: torch.Tensor, kt: torch.Tensor, bf16: bool) -> torch.Tensor:
    """S of a key tile: one accumulator over D in k steps (8: 3 TF32
    passes; 16: one bf16 pass), each step added toward zero."""
    D = qs.shape[1]
    acc = torch.zeros(qs.shape[0], kt.shape[0])
    if bf16:
        for k in range(0, D, 16):
            acc = _add_rz(acc, qs[:, k:k + 16].double() @ kt[:, k:k + 16].double().T)
        return acc
    qh, ql = split_tf32(qs)
    kh, kl = split_tf32(kt)
    for k in range(0, D, 8):
        for x, y in ((ql, kh), (qh, kl), (qh, kh)):
            acc = _add_rz(acc, x[:, k:k + 8].double() @ y[:, k:k + 8].double().T)
    return acc


def _scores(qs, kt, i, j, h, n, bf16, table, bias, i0, rows):
    """A key tile's scores of rows i (column) against keys j (row): S, the
    bias or the table, the causal mask."""
    s = _s_chain(qs, kt, bf16)
    if table is not None:
        s = s + table[(n + i - j).clamp(0, 2 * n - 1), h].float()
    elif bias is not None:
        s = s + bias[h, i0:i0 + rows, j[0, 0]:j[0, -1] + 1].float()
    return torch.where(j <= n + i, s, float("-inf"))


def attention_emulated(q, k, v, n, *, bias=None, table=None, kp=None, prev_k=None,
                       prev_v=None, left_edge=0):
    """general.cu's attention on q, k, v (B, H, T, D) of one dtype: per
    (window, query tile of 64, slab of O's columns) the key tiles of 64 from
    the window's first key to the tile's last row's last key."""
    bf16 = q.dtype == torch.bfloat16
    B, H, T, D = q.shape
    W = T // n
    tiles, nslab = la.general_slabs(D)
    slab = 8 * tiles
    assert nslab * slab >= D > (nslab - 1) * slab and tiles <= la.GENERAL_MAX_TILES
    mask_first = prev_k is None or bool(left_edge)
    scale = la._bf16_scale(D) if bf16 else D ** -0.5
    kp = k if kp is None else kp
    out = torch.empty(B, H, T, D, dtype=q.dtype)
    for b in range(B):
        for h in range(H):
            for w in range(W):
                cur = slice(w * n, (w + 1) * n)
                if w > 0:
                    pk, pv = kp[b, h, (w - 1) * n:w * n], v[b, h, (w - 1) * n:w * n]
                elif prev_k is not None:
                    pk, pv = prev_k[b, h], prev_v[b, h]
                else:
                    pk = pv = torch.zeros(n, D, dtype=q.dtype)
                keys = torch.cat([pk, k[b, h, cur]]).float()
                vals = torch.cat([pv, v[b, h, cur]]).float()
                qw = q[b, h, cur].float() * scale
                if bf16:
                    qw = qw.bfloat16().float()   # q scaled in bf16, as the plain version
                j_begin = n if w == 0 and mask_first else 0
                for i0 in range(0, n, 64):
                    rows = min(64, n - i0)
                    i = torch.arange(i0, i0 + rows)[:, None]
                    for sl in range(nslab):
                        c0, c1 = sl * slab, min(D, (sl + 1) * slab)
                        # two warps per row group: keys 0-31 and 32-63 of
                        # every tile, each with its own softmax, merged at the
                        # end; bf16 first takes each row's max and sum over both
                        # halves, then P = exp(s - max) / sum rounded
                        if bf16:
                            stats = []
                            for kh in range(2):
                                m = torch.full((rows, 1), float("-inf"))
                                l = torch.zeros(rows, 1)
                                for t0 in range(j_begin, n + i0 + rows, KEYS):
                                    j0, j1 = t0 + 32 * kh, min(t0 + 32 * kh + 32, n + i0 + rows)
                                    if j0 >= j1:
                                        continue
                                    j = torch.arange(j0, j1)[None, :]
                                    s = _scores(qw[i0:i0 + rows], keys[j0:j1], i, j, h, n, bf16,
                                                table, bias, i0, rows)
                                    m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                                    mu = torch.where(m_new == float("-inf"), 0.0, m_new)
                                    l = l * torch.exp(m - mu) + torch.exp(s - mu).sum(1, keepdim=True)
                                    m = m_new
                                stats.append((m, l))
                            (m0, l0), (m1, l1) = stats
                            mx = torch.maximum(m0, m1)
                            mrow = torch.where(mx == float("-inf"), 0.0, mx)
                            lrow = l0 * torch.exp(m0 - mrow) + l1 * torch.exp(m1 - mrow)
                        parts = []
                        for kh in range(2):
                            m = torch.full((rows, 1), float("-inf"))
                            l = torch.zeros(rows, 1)
                            o = torch.zeros(rows, c1 - c0)
                            for t0 in range(j_begin, n + i0 + rows, KEYS):
                                j0 = t0 + 32 * kh
                                j1 = min(j0 + 32, n + i0 + rows)
                                if j0 >= j1:
                                    continue
                                j = torch.arange(j0, j1)[None, :]
                                s = _scores(qw[i0:i0 + rows], keys[j0:j1], i, j, h, n, bf16,
                                            table, bias, i0, rows)
                                vt = vals[j0:j1, c0:c1]
                                if bf16:
                                    pb = (torch.exp(s - mrow) / lrow).bfloat16().double()
                                    for k0 in range(0, j1 - j0, 16):
                                        o = _add_rz(o, pb[:, k0:k0 + 16] @ vt[k0:k0 + 16].double())
                                    continue
                                m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                                mu = torch.where(m_new == float("-inf"), 0.0, m_new)
                                c = torch.exp(m - mu)
                                p = torch.exp(s - mu)
                                m = m_new
                                l = l * c + p.sum(1, keepdim=True)
                                o = o * c + gemm_emulated(p.contiguous(), vt.t().contiguous())
                            parts.append((m, l, o))
                        (m0, l0, o0), (m1, l1, o1) = parts
                        if bf16:
                            o, l = o0 + o1, torch.ones(rows, 1)
                        else:
                            mx = torch.maximum(m0, m1)
                            mu = torch.where(mx == float("-inf"), 0.0, mx)
                            e0, e1 = torch.exp(m0 - mu), torch.exp(m1 - mu)
                            o, l = o0 * e0 + o1 * e1, l0 * e0 + l1 * e1
                        out[b, h, w * n + i0:w * n + i0 + rows, c0:c1] = (o / l).to(q.dtype)
    return out


# (D, n, operands): n 70 gives two query tiles, 2 n > 64 several key tiles
ATTENTION = [
    (1, 70, "table"),
    (10, 40, "bias"),
    (18, 40, "kp_prev"),
    (192, 24, "prev_edge"),
    (320, 24, "table"),
    (10, 40, "head_offset"),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("D,n,ops", ATTENTION)
def test_attention_sums_match_the_plain_attention(D, n, ops, dtype):
    bf16 = dtype == "bf16"
    rng = np.random.default_rng([D, n, len(ops)])
    B, H, W = 1, 2, 3 if D < 100 else 2
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (_t(rng, (B, H, W * n, D)).to(dt) for _ in range(3))
    kw = {}
    if ops in ("table", "head_offset"):
        table = _t(rng, (2 * n, 2 * H if ops == "head_offset" else H)).to(dt)
        kw["table"] = table[:, H:].contiguous() if ops == "head_offset" else table
    if ops == "bias":
        kw["bias"] = _t(rng, (H, n, 2 * n)).to(dt)
    if ops in ("kp_prev", "prev_edge"):
        kw["prev_k"], kw["prev_v"] = (_t(rng, (B, H, n, D)).to(dt) for _ in range(2))
        kw["left_edge"] = int(ops == "prev_edge")
    if ops == "kp_prev":
        kw["kp"] = _t(rng, (B, H, W * n, D)).to(dt)
    got = attention_emulated(q, k, v, n, **kw)
    pkw = {("bias_table" if key == "table" else key): val for key, val in kw.items()}
    if ops == "head_offset":   # the wrapper's TP mode reads these columns of the whole table
        with torch.no_grad():
            want = la.local_attention(q, k, v, window_size=n, bias_table=table, head_offset=H)
    else:
        want = tattn.local_attention(q, k, v, window_size=n, **pkw)
    _held(got, want, BF16_TOL if bf16 else TOL)


def test_attention_sums_match_the_jax_attention():
    """The fp32 emulation against JAX's jnp local attention (full bias)."""
    rng = np.random.default_rng(11)
    n, D = 40, 10
    q, k, v = (_t(rng, (1, 2, 3 * n, D)) for _ in range(3))
    bias = _t(rng, (2, n, 2 * n))
    with jax.default_device(jax.devices("cpu")[0]):
        want = jattn.local_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                     window_size=n, bias=jnp.asarray(bias.numpy()))
    _held(attention_emulated(q, k, v, n, bias=bias), torch.from_numpy(np.array(want)), TOL)


# ------------------------------------------------------------------- routes

def test_released_widths_keep_their_fast_routes():
    for dt in (torch.float32, torch.bfloat16):
        for C in (192, 256, 512):
            assert cu.route_for("conv_unit", C, dt) == "tc"
        for C in (24, 48, 96):
            assert cu.route_for("conv_unit_ct", C, dt) == "narrow"
    for D in (32, 64, 128):
        assert la.fast_takes(D, [3 * 6 * D * 750, D, 3 * 6 * D], [0], 4)
    assert uf.route_for(512, 256, True) == "tc"
    assert uf.route_for(512, 256, True, True, 0) == "wgmma"
    assert uf.route_for(96, 48, False) == "stream"
    assert lt.route_for(24) == "tc"


@pytest.mark.parametrize("D", [1, 10, 18, 192, 256, 320])
def test_former_general_head_dims_take_the_tensor_core_attention(D):
    assert not la.fast_takes(D, [0, 0, 3 * 6 * D], [0], 4)
    tiles, slabs = la.general_slabs(D)
    assert tiles in la.GENERAL_TILES and slabs == (2 if D > 256 else 1)
    assert 8 * tiles * slabs >= D


@pytest.mark.parametrize("C", [600, 1040, 1280])
def test_former_general_units_run_their_products_on_the_fast_cores(C):
    M, H = 2 * 1779, 4 * C
    flat = lambda width: (M, 0, width, 1)
    for dt, core in ((torch.float32, "tc_gemm"), (torch.bfloat16, "gemm_sm90")):
        assert cu.route_for("conv_unit", C, dt) == "general" or C == 600 and dt == torch.bfloat16
        split = dt == torch.float32
        assert cu.gemm_route(flat(C), dt, split, C, flat(H), H, M, dt,
                             act=cu.ACT_SNAKE) == core
        assert cu.gemm_route(flat(H), dt, split, H, flat(C), C, M, dt, res=True) == core
        # the TP share: fp32 out, the bias alone
        assert cu.gemm_route(flat(H // 2), dt, split, H // 2, flat(C), C, M,
                             torch.float32) == core


def test_up_and_tail_products_take_their_cores():
    T, M = 1779, 2 * 1779
    cl = (T, T * 1280, 1280, 1)
    z = (M, 0, 600, 1)
    assert cu.gemm_route(cl, torch.float32, True, 1280, z, 600, M, torch.float32) == "tc_gemm"
    assert cu.gemm_route(cl, torch.bfloat16, False, 1280, z, 600, M,
                         torch.float32) == "gemm_sm90"
    strided = (T, T * 1280 + 4, 1280, 1)   # a (B, T, C) view with a padded batch stride
    assert cu.gemm_route(strided, torch.float32, True, 1280, z, 600, M, torch.float32) == "mma"
    ct = (26685, 12 * 26685, 1, 26685)
    for dt in (torch.float32, torch.bfloat16):
        assert cu.gemm_route(ct, dt, dt == torch.float32, 12, (2 * 26685, 0, 200, 1), 200,
                             2 * 26685, torch.float32) == "mma"
    assert uf.route_for(1280, 600, True) == "general" and uf.route_for(12, 200, False) == "general"
    assert lt.route_for(96) == "general" and lt.GENERAL_PRODUCTS == 7
    # tanh and round_mid exist only on general.cu's product
    flat = (M, 0, 96, 1)
    assert cu.gemm_route(flat, torch.float32, True, 96, flat, 96, M, torch.float32,
                         act=cu.ACT_TANH) == "mma"
    assert cu.gemm_route(flat, torch.bfloat16, False, 96, flat, 96, M, torch.bfloat16,
                         res=True, round_mid=True) == "mma"


class _Entry:
    """A stand-in for a kernel entry point: records its arguments, returns 0."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_gemm_calls_the_entry_point_of_its_route(monkeypatch, dtype):
    calls = []
    monkeypatch.setattr(_build, "function", lambda name, argtypes: _Entry(calls, name))
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    bf16 = dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    M, C, N = 96, 40, 24
    a = _t(rng, (M, C)).to(dtype)
    b = _t(rng, (N, C)).to(dtype)
    b_lo = None if bf16 else torch.zeros(N, C)
    bias = torch.zeros(N)
    before = dict(cu.GEMM_ROUTES)
    # unit pw1 (snake), pw2 (residual), the TP share (fp32 out)
    h = torch.empty(M, N, dtype=dtype)
    cu.general_gemm(a, (M, 0, C, 1), b, b_lo, bias, h, (M, 0, N, 1), M, alpha=bias + 1,
                    act=cu.ACT_SNAKE)
    res = torch.zeros(M, N, dtype=dtype)
    cu.general_gemm(a, (M, 0, C, 1), b, b_lo, bias, h, (M, 0, N, 1), M, res=res)
    share = torch.empty(M, N)
    cu.general_gemm(a, (M, 0, C, 1), b, b_lo, bias, share, (M, 0, N, 1), M)
    # a channels-first A (the (B, C, T) up path): general.cu's product
    x = _t(rng, (2, C, M // 2)).to(dtype)
    cu.general_gemm(x, (M // 2, C * M // 2, 1, M // 2), b, b_lo, bias, share, (M, 0, N, 1), M)
    core = "l3ac_gemm_sm90_bf16" if bf16 else "l3ac_tc_gemm_fp32"
    entries = [n for n, _ in calls if n != "l3ac_sm90_weight_map"]
    assert entries == [core, core, core, "l3ac_general_gemm"]
    epis = [args[10] for n, args in calls if n == core]
    assert epis == ([cu.ACT_SNAKE, 3, 4] if bf16 else [cu.ACT_SNAKE, 3, 0])
    key = "gemm_sm90" if bf16 else "tc_gemm"
    assert cu.GEMM_ROUTES[key] == before[key] + 3
    assert cu.GEMM_ROUTES["mma"] == before["mma"] + 1
    if bf16:
        assert sum(gemm_sm90.ROUTES.values()) >= 3


@pytest.mark.parametrize("n,W,BH,D", [(250, 3, 12, 192), (70, 2, 3, 320), (40, 1, 2, 10)])
def test_attention_blocks_run_longest_first_and_cover_every_item(n, W, BH, D):
    """The general attention's block order: each (query tile, window, slab,
    batch * head) once, and no block has more key tiles than one before it."""
    slabs = la.general_slabs(D)[1]
    nq = -(-n // 64)
    items = [la.general_work_item(i, n, W, BH, slabs) for i in range(nq * W * slabs * BH)]
    assert sorted(items) == sorted((64 * qt, w, sl, bh) for qt in range(nq) for w in range(W)
                                   for sl in range(slabs) for bh in range(BH))
    tiles = [-(-(n + min(64, n - i0) + i0 - (n if w == 0 else 0)) // 64) for i0, w, _, _ in items]
    assert tiles == sorted(tiles, reverse=True)


def test_row_passes_match_the_jax_channel_norm():
    """The dw + norm pass at C = 1280 (the C override's unit) and the blend
    + norm pass at 12 -> 200, s = 2 (the D override's up path), as the
    kernels sum, against JAX's jnp ChannelNorm on the same conv and
    JAX's upsample (fp32, 1e-4 x max(1, max |JAX|))."""
    rng = np.random.default_rng(23)
    C = 1280
    x = _t(rng, (2, 9, C))
    dw, dw_b = _t(rng, (C, 7), 7 ** -0.5), _t(rng, (C,), 0.1)
    nw, nb = 1.0 + _t(rng, (C,), 0.1), _t(rng, (C,), 0.1)
    y = cu._depthwise(x.transpose(1, 2), dw[:, None, :], dw_b, 3, None, None).transpose(1, 2)
    want = np.array(jax_channel_norm(jnp.asarray(y.numpy()), jnp.asarray(nw.numpy()),
                                       jnp.asarray(nb.numpy())))
    _held(dw_norm_emulated(x, dw, dw_b, nw, nb, 3), torch.from_numpy(want), TOL)
    Co = 200
    z = _t(rng, (2, 9, Co))
    nw, nb = 1.0 + _t(rng, (Co,), 0.2), _t(rng, (Co,), 0.2)
    want = np.array(jax_channel_norm(jax_upsample(jnp.asarray(z.numpy()), 2),
                                       jnp.asarray(nw.numpy()), jnp.asarray(nb.numpy())))
    got = up_blend_norm_emulated(z, uf.phase_weights(2), nw, nb, "cl", torch.float32)
    _held(got, torch.from_numpy(want), TOL)
