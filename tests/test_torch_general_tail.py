"""The general tail (``legacy_tail`` at C > 64 or C % 4 != 0) on the CPU:
its launch plan and its order of operations.

- The launch plan: both entry points make exactly seven launches of the
  general product (``csrc/general_gemm.cu``, ``l3ac_general_gemm``) and no
  other: the three k7 convs at dilations 1, 3, 9 with a1[u]'s snake as their
  prologue, the three 1x1 convs with a2[u]'s, the residual read in place
  through the input's address map (the phase pair's too) on the first unit
  and from the residual stream after it, rounded first where bf16 rounds
  (``round_mid``), then the output conv with ao's snake and tanh.
- The plan's order of operations emulated in torch from its own arguments:
  each launch's A read through its address map (the phase pair
  interleaved), the prologue's snake at staging (rounded where bf16
  rounds), a k7 conv as seven row-shifted products of one zero-filled
  window, the epilogue. With the plain version's fp32 products the bf16
  emulation equals ``legacy_tail_plain_bf16`` bit for bit at every rounding
  point (each snake, each conv's output, each 1x1's rounded product, the
  residual stream, the audio); with the kernel's sums (per tap, K steps of
  32 channels: fp32 3xTF32 with a fresh accumulator each, bf16 one
  accumulator of k16 steps; ``tc_gemm.gemm_emulated`` /
  ``gemm_bf16_emulated``) it is held
  against ``legacy_tail_plain`` within 1e-5 and ``legacy_tail_plain_bf16``
  within 2^-6 (two bf16 ulps), each x max(1, max |plain|); fp32 also no
  farther from the float64 tail than 1e-5 or twice the plain fp32 tail.
  The weights are ``chip_smoke.py``'s tail rows' (5x the model's init scale
  in fp32, 2.5x in bf16).
- Widths C in {1, 7, 22, 96, 130}, T not a multiple of the product's row
  tile (64 fp32, 128 bf16).
- How the product stages A (``conv_unit.gemm_staging``): the tail's
  buffers, the phase pair and the (B, C, T) up path by their contiguous
  time axis, channels-last rows by theirs, a view with neither by element
  loads; and ``tools/general_tail_variants.py``'s substitutions apply once.

No JAX here: the tail's JAX parity is ``tests/test_torch_kernels.py`` and
``tests/test_torch_widths.py``. The kernels run on the card in
``chip_smoke.py`` phase 12.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_thread  # noqa: F401
from l3ac_tpu_torch.ops.activations import snake
from l3ac_tpu_torch.ops.kernels import _build
from l3ac_tpu_torch.ops.kernels import conv_unit as cu
from l3ac_tpu_torch.ops.kernels import legacy_tail as lt
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_bf16_emulated, gemm_emulated
from l3ac_tpu_torch.ops.resample import interleave

TOL, BF16_TOL = 1e-5, 2.0 ** -6
KC = 32         # general_gemm.cu kKs: a K step (fp32: a fresh accumulator each)
CW = 256        # ... the widest chunk of channels a window holds
WIDTHS = (1, 7, 22, 96, 130)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

pytestmark = pytest.mark.usefixtures("one_thread")


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, C, dtype, std24=0.1):
    """chip_smoke.py's tail weights: std24 at C = 24, scaled by sqrt(24 / C)
    (fp32 5x the model's init scale, bf16 2.5x: a bf16 tail well above init
    scale is chaotic, one-ulp flips moving the audio as far as bf16 does)."""
    s = std24 * (24 / C) ** 0.5
    pos = lambda shape: 1.0 + _t(rng, shape, 0.3).abs()
    return lt.TailWeights(*(x.to(dtype) for x in (
        pos((3, C)), _t(rng, (3, C, C, 7), s), _t(rng, (3, C), 0.1), pos((3, C)),
        _t(rng, (3, C, C), s), _t(rng, (3, C), 0.1), pos((C,)), _t(rng, (1, C, 7), s),
        _t(rng, (1,), 0.05))))


def _inputs(C, T, dtype, seed=0):
    rng = np.random.default_rng([C, T, seed])
    w = _weights(rng, C, dtype, 0.05 if dtype == torch.bfloat16 else 0.1)
    x = _t(rng, (2, C, T)).to(dtype)
    return w, x


def _held(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


# ------------------------------------------------------------- launch plan

class _Entry:
    """A stand-in for the kernel entry point: records its arguments, returns 0."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls.append((self.name, dict(zip(cu.GEMM_ARGS, args))))
        return 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pair", [False, True], ids=["interleaved", "phase_pair"])
def test_both_entry_points_make_seven_products_and_no_elementwise_pass(monkeypatch, dtype, pair):
    calls = []
    monkeypatch.setattr(_build, "function", lambda name, argtypes: _Entry(calls, name))
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    C, T = 96, 150
    bf16 = DTYPES[dtype] == torch.bfloat16
    w, x = _inputs(C, T, DTYPES[dtype])
    x0, x1 = (x[..., 0::2].contiguous(), x[..., 1::2].contiguous()) if pair else (x, None)
    routes, staging = dict(cu.GEMM_ROUTES), dict(cu.GEMM_STAGING)
    name = "legacy_tail_poly_ct" if pair else "legacy_tail_ct"
    out = lt._launch(x0, x1, w, T, name)
    assert out.shape == (2, T)
    assert [n for n, _ in calls] == ["l3ac_general_gemm"] * lt.GENERAL_PRODUCTS
    assert cu.GEMM_ROUTES["mma"] == routes["mma"] + 7
    assert cu.GEMM_STAGING["window"] == staging["window"] + 7
    assert cu.GEMM_STAGING["element"] == staging["element"]
    args = [a for _, a in calls]
    _, _, _, vec = lt.prepared_general(w)
    a1, _, a2, _ = vec[:12 * C].view(4, 3, C)
    ao = vec[12 * C:13 * C]
    assert [a["pro"] for a in args] == [a1[0].data_ptr(), a2[0].data_ptr(), a1[1].data_ptr(),
                                        a2[1].data_ptr(), a1[2].data_ptr(), a2[2].data_ptr(),
                                        ao.data_ptr()]
    assert [a["taps"] for a in args] == [7, 1, 7, 1, 7, 1, 7]
    assert [a["dil"] for a in args] == [1, 1, 3, 1, 9, 1, 1]
    assert [a["N"] for a in args] == [C] * 6 + [1]
    assert [a["act"] for a in args] == [cu.ACT_NONE] * 6 + [cu.ACT_TANH]
    assert [a["round_mid"] for a in args] == [0, int(bf16)] * 3 + [0]
    assert all(a["stage"] == cu.STAGE_TIME and a["a_bf"] == int(bf16) for a in args)
    # the first unit reads the input in place: its k7 conv's A and its 1x1's residual
    in_map = (T, x0.stride(0), x0.stride(2), x0.stride(1))
    for a, key, key1 in ((args[0], "a", "a1"), (args[1], "res", "res1")):
        assert a[key] == x0.data_ptr() and a[key1] == (x1.data_ptr() if pair else None)
    assert (args[0]["a_rows"], args[0]["a_sb"], args[0]["a_st"], args[0]["a_sk"]) == in_map
    assert (args[1]["o_rows"], args[1]["r_sb"], args[1]["r_st"], args[1]["r_sn"]) == in_map
    # then the residual stream: xbuf in and out of each 1x1, read by the next k7
    xbuf, hbuf = args[1]["out"], args[0]["out"]
    for u in (1, 2):
        k7, pw = args[2 * u], args[2 * u + 1]
        assert k7["a"] == xbuf and k7["a1"] is None and k7["out"] == hbuf
        assert pw["a"] == hbuf and pw["res"] == pw["out"] == xbuf and pw["res1"] is None
    assert args[1]["a"] == hbuf and args[6]["a"] == xbuf and args[6]["out"] == out.data_ptr()
    ct = (C * T, 1, T)
    assert all((a["o_sb"], a["o_st"], a["o_sn"]) == ct for a in args[:6])
    assert (args[6]["o_rows"], args[6]["o_sb"], args[6]["o_st"], args[6]["o_sn"]) == (T, T, 1, 0)


def test_general_weights_are_tap_major_and_zero_past_c():
    rng = np.random.default_rng(4)
    for C in (1, 22, 96):
        w = _weights(rng, C, torch.float32)
        w1, w2, wo, vec = lt.prepared_general(w)
        ldb = lt.general_ldb(C)
        assert ldb % 8 == 0 and ldb >= C
        assert w1.shape == (3, 7, C, ldb) and w2.shape == (3, C, ldb) and wo.shape == (7, 1, ldb)
        assert torch.equal(w1[..., :C], w.w1.permute(0, 3, 1, 2))
        assert torch.equal(wo[..., :C], w.wo.permute(2, 0, 1)) and torch.equal(w2[..., :C], w.w2)
        assert not w1[..., C:].any() and not w2[..., C:].any() and not wo[..., C:].any()


# ------------------------------------------------------ order of operations

def _a_view(t, t1, m, B, C):
    """(B, C, rows) of the values an address map reads (the pair interleaved)."""
    rows, sb, st, sk = m
    if t1 is None:
        return t.as_strided((B, C, rows), (sb, sk, st))
    ph = [p.as_strided((B, C, rows // 2), (sb, sk, st)) for p in (t, t1)]
    return interleave(ph, 2)


def _plain_weight(b, C, taps):
    """The plain (N, C, taps) weight of a tap-major (taps, N, ldb) one."""
    return b.reshape(taps, -1, b.shape[-1])[..., :C].permute(1, 2, 0)


def _kernel_sums(win, b, taps, dil, bf16):
    """The product's sums on the zero-filled window (B, C, T): one window of
    up to CW channels (the kernel's widest chunk; it narrows the chunk only
    where shared memory runs short, which reorders the steps but not their
    grouping), per tap its K steps of KC channels, each step's A the
    window's rows shifted by (tap - taps // 2) dil."""
    B, C, T = win.shape
    wt = b.reshape(taps, -1, b.shape[-1])
    half = (taps // 2) * dil
    xp = F.pad(win.float(), (half, half))
    cols, ws = [], []
    for cw0 in range(0, C, CW):
        for k in range(taps):
            for c0 in range(cw0, min(cw0 + CW, C), KC):
                cn = min(KC, C - c0)
                cols.append(F.pad(xp[:, c0:c0 + cn, k * dil:k * dil + T], (0, 0, 0, KC - cn)))
                ws.append(F.pad(wt[k, :, c0:c0 + cn].float(), (0, KC - cn)))
    a = torch.cat(cols, 1).permute(0, 2, 1).reshape(B * T, -1)
    bm = torch.cat(ws, 1)
    s = gemm_bf16_emulated(a.bfloat16(), bm.bfloat16()) if bf16 else gemm_emulated(a, bm)
    return s.reshape(B, T, -1).permute(0, 2, 1)


def _plain_sums(win, b, bias, taps, dil, N):
    """The plain version's fp32 products (+ bias) on the window."""
    w = _plain_weight(b, win.shape[1], taps).float()
    if taps == 1:
        return torch.einsum("oc,bct->bot", w[..., 0], win.float()) + bias[:, None]
    if N == 1:
        return F.conv1d(win.float(), w, bias, padding=3 * dil, dilation=dil)
    return lt._conv_taps(win.float(), w, bias, dil)


def emulate(p: dict, sums: str, trace: list) -> None:
    """One launch of the plan, ``window_gemm``'s arguments ``p``, in the
    kernel's order of operations; writes its output in place and appends
    (window, mid, out) to ``trace``."""
    a, C, N, M = p["a"], p["C"], p["N"], p["M"]
    rows = p["a_map"][0]
    B = M // rows
    taps, dil = p.get("taps", 1), p.get("dil", 1)
    win = _a_view(a, p.get("a1"), p["a_map"], B, C)
    if p.get("pro") is not None:
        win = snake(win, p["pro"][:, None])   # fp32, rounded where A is bf16
    bf16 = a.dtype == torch.bfloat16
    if sums == "kernel":
        v = _kernel_sums(win, p["b"], taps, dil, bf16) + p["bias"][:, None]
    else:
        v = _plain_sums(win, p["b"], p["bias"], taps, dil, N)
    if p.get("act") == cu.ACT_TANH:
        v = torch.tanh(v)
    mid = None
    if p.get("res") is not None:
        if p.get("round_mid"):
            v = mid = v.bfloat16()
        v = _a_view(p["res"], p.get("res1"), p["r_map"], B, N) + v
    out = p["out"]
    o_rows, o_sb, o_st, o_sn = p["o_map"]
    view = out.as_strided((B, N, o_rows), (o_sb, o_sn, o_st))
    view.copy_(v.to(out.dtype))
    trace.append((win, mid, view.clone()))


def _emulated_tail(x, w, pair: bool, sums: str):
    B, C, T = x.shape
    x0, x1 = (x[..., 0::2].contiguous(), x[..., 1::2].contiguous()) if pair else (x, None)
    xbuf, hbuf = torch.empty_like(x), torch.empty_like(x)
    out = torch.empty(B, T, dtype=x.dtype)
    trace = []
    for p in lt.general_plan(x0, x1, w, T, xbuf, hbuf, out):
        emulate(p, sums, trace)
    return out, trace


def _plain_bf16_trace(x, w):
    """``legacy_tail_plain_bf16``'s steps with each rounding point kept, in
    the plan's order: per unit (snake a1, k7 conv, None, snake a2, 1x1
    conv, the residual stream), then (snake ao, the audio)."""
    bf, f = x.dtype, lambda t: t.float()
    trace = []
    for u, d in enumerate(lt.DILATIONS):
        s1 = snake(x, w.a1[u][:, None])
        h = lt._conv_taps(f(s1), f(w.w1[u]), f(w.b1[u]), d).to(bf)
        s2 = snake(h, w.a2[u][:, None])
        h2 = (torch.einsum("oc,bct->bot", f(w.w2[u]), f(s2)) + f(w.b2[u])[:, None]).to(bf)
        x = x + h2
        trace += [(s1, None, h), (s2, h2, x)]
    so = snake(x, w.ao[:, None])
    y = torch.tanh(F.conv1d(f(so), f(w.wo), f(w.bo), padding=3)).to(bf)
    return y[:, 0], trace + [(so, None, y)]


@pytest.mark.parametrize("pair", [False, True], ids=["interleaved", "phase_pair"])
@pytest.mark.parametrize("C", WIDTHS)
def test_bf16_order_of_operations_is_the_plain_versions_at_every_rounding_point(C, pair):
    T = 150
    w, x = _inputs(C, T, torch.bfloat16)
    want, ref = _plain_bf16_trace(x, w)
    assert torch.equal(want, lt.legacy_tail_plain_bf16(x, w))   # the trace is the plain tail
    got, trace = _emulated_tail(x, w, pair, "plain")
    assert len(trace) == len(ref) == lt.GENERAL_PRODUCTS
    for i, ((win, mid, out), (r_win, r_mid, r_out)) in enumerate(zip(trace, ref)):
        assert win.dtype == torch.bfloat16 and torch.equal(win, r_win), i
        assert (mid is None) == (r_mid is None) and (mid is None or torch.equal(mid, r_mid)), i
        assert torch.equal(out, r_out), i
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", WIDTHS)
def test_kernel_sums_in_the_plans_order_match_the_plain_tail(C, dtype):
    dt = DTYPES[dtype]
    T = 150   # not a multiple of the row tile (64 fp32, 128 bf16)
    w, x = _inputs(C, T, dt, seed=1)
    pair = C % 2 == 0
    got, _ = _emulated_tail(x, w, pair, "kernel")
    if dt == torch.bfloat16:
        _held(got, lt.legacy_tail_plain_bf16(x, w), BF16_TOL)
        return
    plain = lt.legacy_tail_plain(x, w)
    _held(got, plain, TOL)
    # and as accurate as the plain fp32 tail, against the float64 one
    exact = lt.legacy_tail_plain(x.double(), lt.TailWeights(*(t.double() for t in w)))
    dist = lambda y: (y.double() - exact).abs().max().item()
    assert dist(got) <= max(TOL, 2 * dist(plain)), (dist(got), dist(plain))


# ----------------------------------------------------------------- staging

def test_staging_follows_the_contiguous_axis():
    T, C = 16000, 96
    ct = (T, C * T, 1, T)
    assert cu.gemm_staging(ct) == cu.gemm_staging(ct, pair=True) == cu.STAGE_TIME
    # the (B, C, T) up path at an odd T: rows at odd element offsets still
    # stage by 16-byte blocks from the boundary below each row's start
    assert cu.gemm_staging((26685, 12 * 26685, 1, 26685)) == cu.STAGE_TIME
    assert cu.gemm_staging((2 * 1779, 0, 1280, 1)) == cu.STAGE_CHANNEL
    strided = (101, 101 * 24, 24, 2)   # x[..., ::2] of a (B, T, 24) tensor
    assert cu.gemm_staging(strided) == cu.STAGE_ELEMENT
    assert cu.gemm_staging((101, 0, 24, 1), pair=True) == cu.STAGE_ELEMENT


def test_window_gemm_counts_its_staging(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "function", lambda name, argtypes: _Entry(calls, name))
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    B, Ci, Co, T = 2, 12, 20, 33
    x = torch.zeros(B, T, 2 * Ci)[..., ::2]
    b = torch.zeros(Co, Ci)
    out = torch.empty(B * T, Co)
    before = dict(cu.GEMM_STAGING)
    cu.window_gemm(x, (T, x.stride(0), x.stride(1), x.stride(2)), Ci, b, out, (B * T, 0, Co, 1),
                   B * T, Co)
    xt = torch.zeros(B, Ci, T)
    cu.general_gemm(xt, (T, Ci * T, 1, T), b, torch.zeros_like(b), None, out, (B * T, 0, Co, 1),
                    B * T)
    assert cu.GEMM_STAGING["element"] == before["element"] + 1
    assert cu.GEMM_STAGING["window"] == before["window"] + 1
    assert [a["stage"] for _, a in calls] == [cu.STAGE_ELEMENT, cu.STAGE_TIME]
    assert calls[1][1]["ldb"] == Ci and calls[1][1]["b_lo"] is not None
    with pytest.raises(ValueError):
        cu.window_gemm(xt, (T, Ci * T, 1, T), Ci, b, out, (B * T, 0, Co, 1), B * T, Co, taps=7)


def test_tail_variants_substitutions_apply_once():
    from l3ac_tpu_torch.tools import general_tail_variants as gv
    from l3ac_tpu_torch.tools import variant_source
    for _, subs in gv.VARIANTS:
        variant_source(gv.SOURCE, subs, "general_tail_variants")
    with pytest.raises(SystemExit):
        gv.main([])
