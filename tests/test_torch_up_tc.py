"""The arithmetic of the up-path kernels (``csrc/up_fused_tc.cu``,
``csrc/up_fused.cu``) modelled in PyTorch on the CPU, and their weights,
prepared once.

- ``up_tc_emulated`` sums as the tensor-core kernel does: the rows of x in
  tiles of 64 (62 owned rows and a halo row on each side, clamped into
  [0, T)), the 1x1 conv as ``tc_gemm.gemm_emulated`` (3 TF32 passes,
  ``tf32_rna`` splits, a fresh accumulator per K step of 32), per z row its
  mean, its sum of squares about it and its cross sum with the next row
  (the lanes' partial sums over their float4 channel slots, the butterfly
  over 32 lanes), then per owned row and phase the blend as the kernel's
  fma, its mean and sum of squares from the two rows' statistics, one
  reciprocal of the standard deviation, and the affine as an fma. Held
  against the float64 up path within 3x the fp32 plain version's own error
  at the wide widths and scales, with T ragged against the 62-row tile (1,
  tile - 1, tile + 1, 2 tile + 3; the edge rows repeat the edge frame), and
  against JAX's jnp up path at one shape.
- ``up_wgmma_emulated`` sums as the bf16 (B, T, C) kernel
  (``csrc/up_fused_tc_bf16.cu``) does: the same 64-row tiles, z from bf16
  operands with fp32 sums plus the bias, the halo row before t = 0 and the
  one past T - 1 copies of the edge rows, the statistics as above, the
  blend and the norm folded into two fmas of per-(row, phase) coefficients
  (w_c sd^-1, w_o sd^-1, -mean sd^-1) and the affine as a third, the output
  rounded to bf16. Held against
  ``up_fused_plain_bf16`` within the bf16 kernels' tolerance at the 1kbps
  widths, at Co = 160 (wgmma chunks of 64 and 16) and 32, at ragged T and
  on the edge frames, and against JAX's jnp up path in bf16; the ``"tc"``
  buffer it reads is W itself.
- ``up_stream_emulated`` sums as the streaming kernel does (the conv on the
  same 3xTF32 scheme, the column statistics as sequential sums over Co);
  held the same way at the narrow widths.
- ``prepare_up`` lays the weights out as each kernel reads them;
  ``Stage.up_prepared`` and ``prepared_up`` cache them, rebuild them after
  ``load_state_dict`` and an in-place ``mul_``, never cache them for
  inference tensors, and a warm decode transposes no up weight.
- ``route_for`` is a shape rule (and of the dtype: bf16 (B, T, C) at Ci % 8
  == 0 and Co a multiple of 32 up to 256 takes ``"wgmma"``);
  ``tools/up_variants.py``'s substitutions apply to every kernel's source,
  and the tool needs the card.

The kernels themselves are held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from l3ac_tpu.models import decoder as jdec
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.decoder import Decoder
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops.kernels import up_fused as uf
from l3ac_tpu_torch.ops.kernels.tc_gemm import gemm_emulated
from l3ac_tpu_torch.ops.resample import phase_weights

TOL = 1e-4   # chip_smoke.py: max abs error <= TOL * max(1, max |plain|)
EPS = 1e-8   # ChannelNorm
TILE = uf.TC_OWN_ROWS


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _weights(rng, Ci, Co, norm=True):
    """As chip_smoke.py: the conv at ~1 / sqrt(Ci), a non-trivial norm."""
    return uf.UpWeights(_t(rng, (Co, Ci), Ci ** -0.5), _t(rng, (Co,), 0.3),
                        (1.0 + _t(rng, (Co,), 0.2)) if norm else None,
                        _t(rng, (Co,), 0.2) if norm else None)


def _fma(a, b, c):
    """fp32 fma: the product exact in float64, one rounding of the sum."""
    return (a.double() * b + c.double()).float()


def _taps(scale):
    return [tuple(float(np.float32(v)) for v in tap) for tap in phase_weights(scale)]


def _blend(zc, zo, wc, wo):
    """The kernels' blend of a phase: fma(z[t], w_cur, z[t -+ 1] * w_other)."""
    return _fma(zc, wc, zo * wo)


def _butterfly(v):
    """Lanes (.., 32) -> their sum, as the shuffles xor 16, 8, 4, 2, 1 add."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lanes(v, Co):
    """(.., Co) -> (.., slots, 32, 4): lane l holds channels 4 l + 128 k ..
    + 3 of slot k (zero past Co)."""
    slots = -(-Co // 128)
    return F.pad(v, (0, 128 * slots - Co)).reshape(*v.shape[:-1], slots, 32, 4)


def _slot_sum(q):
    """(.., slots, 32) -> (.., 32): the lane's slots added in order."""
    s = torch.zeros(q.shape[:-2] + (32,))
    for k in range(q.shape[-2]):
        s = s + q[..., k, :]
    return s


def _row_sum(v, Co):
    """up_fused_tc.cu's row_sum and butterfly: ((x + y) + z) + w per slot."""
    q = _lanes(v, Co)
    return _butterfly(_slot_sum(((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]))


def _row_dot(u, w, Co):
    """row_dot: fma(u.w, w.w, fma(u.z, w.z, fma(u.y, w.y, u.x w.x))) per slot."""
    a, b = _lanes(u, Co), _lanes(w, Co)
    q = a[..., 0] * b[..., 0]
    for i in (1, 2, 3):
        q = _fma(a[..., i], b[..., i], q)
    return _butterfly(_slot_sum(q))


def up_tc_emulated(x: torch.Tensor, w: uf.UpWeights, scale: int) -> torch.Tensor:
    """csrc/up_fused_tc.cu's sums: x (B, T, Ci) -> (B, T scale, Co)."""
    B, T, Ci = x.shape
    Co = w.w.shape[0]
    out = torch.empty(B, T, scale, Co)
    taps = _taps(scale)
    for b in range(B):
        for t0 in range(0, T, TILE):
            rows = torch.arange(t0 - 1, t0 + TILE + 1).clamp(0, T - 1)
            z = gemm_emulated(x[b, rows].contiguous(), w.w, bias=w.b)   # (64, Co)
            if w.norm_w is not None:   # per z row: mean, sum of squares, cross sum with the next
                m = _row_sum(z, Co) / Co
                u = z - m[:, None]
                d = _row_dot(u, u, Co)
                c = _row_dot(u[:-1], u[1:], Co)
            n = min(TILE, T - t0)
            i = torch.arange(1, n + 1)
            for p, (wp, wc, wn) in enumerate(taps):
                prev = wp != 0.0
                wo = wp if prev else wn
                io = i - 1 if prev else i + 1
                v = _blend(z[i], z[io], wc, wo)
                if w.norm_w is not None:
                    mu, rsd = _moments(m, d, c[i - 1 if prev else i], io, i, wo, wc, Co)
                    v = _fma((v - mu[:, None]) * rsd[:, None], w.norm_w, w.norm_b)
                out[b, t0:t0 + n, p] = v
    return out.reshape(B, T * scale, Co)


def _quads(v, Co):
    """(rows, Co) -> (rows, warpgroup, j, t4, e): column Co / 2 cw + 8 j + 2 t4
    + e, as wgmma's accumulators hold a row of each warpgroup's half."""
    return v.reshape(v.shape[0], 2, Co // 16, 4, 2)


def _quad_reduce(q):
    """(.., t4) -> their sum as the shuffles xor 1, then xor 2 add, per
    warpgroup; then the two warpgroups' partial sums added."""
    q = q[..., 0::2] + q[..., 1::2]
    q = q[..., 0] + q[..., 1]
    return q[:, 0] + q[:, 1]


def _wgmma_row_sum(z, Co):
    """up_fused_tc_bf16.cu's row_stats sums: per lane, (z_e0 + z_e1) added
    over j in order, then the quad and the warpgroups."""
    q = _quads(z, Co)
    s = torch.zeros(q.shape[:2] + q.shape[3:4])
    for j in range(q.shape[2]):
        s = s + (q[:, :, j, :, 0] + q[:, :, j, :, 1])
    return _quad_reduce(s)


def _wgmma_row_dot(u, w, Co):
    """row_stats' D and C: per lane fma(u_e1, w_e1, fma(u_e0, w_e0, acc)) over
    j in order, then the quad and the warpgroups."""
    a, b = _quads(u, Co), _quads(w, Co)
    s = torch.zeros(a.shape[:2] + a.shape[3:4])
    for j in range(a.shape[2]):
        s = _fma(a[:, :, j, :, 1], b[:, :, j, :, 1], _fma(a[:, :, j, :, 0], b[:, :, j, :, 0], s))
    return _quad_reduce(s)


def up_wgmma_emulated(x: torch.Tensor, w: uf.UpWeights, scale: int) -> torch.Tensor:
    """csrc/up_fused_tc_bf16.cu's sums: bf16 x (B, T, Ci) -> bf16 (B, T scale,
    Co). x rows outside [0, T) arrive as zeros (TMA), so their z is the bias;
    the kernel then copies z row 0 into the halo row before it and z row T -
    1 into the one after it, and gives those rows the edge rows' statistics
    (the values the copies' statistics have: the same sums in the same
    order)."""
    B, T, Ci = x.shape
    wf = uf.UpWeights(*(None if t is None else t.float() for t in w))
    Co = wf.w.shape[0]
    out = torch.empty(B, T, scale, Co)
    taps = _taps(scale)
    for b in range(B):
        for t0 in range(0, T, TILE):
            rows = torch.arange(t0 - 1, t0 + TILE + 1)
            ok = (rows >= 0) & (rows < T)
            xt = torch.where(ok[:, None], x[b, rows.clamp(0, T - 1)].float(), 0.0)
            z = (xt.double() @ wf.w.double().t()).float() + wf.b           # (64, Co)
            if t0 == 0:
                z[0] = z[1]
            if T - t0 < TILE + 1:
                z[T - t0 + 1] = z[T - t0]
            if wf.norm_w is not None:
                m = _wgmma_row_sum(z, Co) / Co
                u = z - m[:, None]
                d = _wgmma_row_dot(u, u, Co)
                c = _wgmma_row_dot(u[:-1], u[1:], Co)
            n = min(TILE, T - t0)
            i = torch.arange(1, n + 1)
            for p, (wp, wc, wn) in enumerate(taps):
                prev = wp != 0.0
                wo = wp if prev else wn
                io = i - 1 if prev else i + 1
                v = _blend(z[i], z[io], wc, wo)
                if wf.norm_w is not None:   # the blend and the norm as two fmas
                    mu, rsd = _moments(m, d, c[i - 1 if prev else i], io, i, wo, wc, Co)
                    ca, cb, cc = (wc * rsd)[:, None], (wo * rsd)[:, None], (-mu * rsd)[:, None]
                    v = _fma(_fma(z[i], ca, _fma(z[io], cb, cc)), wf.norm_w, wf.norm_b)
                out[b, t0:t0 + n, p] = v
    return out.reshape(B, T * scale, Co).bfloat16()


def _moments(m, d, c, a, b, wo, wc, Co):
    """The mean and the reciprocal standard deviation of the blend
    fma(z_b, w_cur, z_a w_other) from the statistics of a (the other) and b
    (the current) and their cross sum c, in the kernels' order."""
    wo, wc = torch.tensor(wo), torch.tensor(wc)
    q = _fma(wo * wo, d[a], _fma(wc * wc, d[b], 2.0 * wo * wc * c))
    mu = _fma(m[b], wc, m[a] * wo)
    return mu, 1.0 / torch.sqrt(q.clamp(min=0.0) / Co + EPS)


def up_stream_emulated(x: torch.Tensor, w: uf.UpWeights, scale: int) -> torch.Tensor:
    """csrc/up_fused.cu's sums on (B, Ci, T) -> (B, Co, T scale): the conv as
    ``gemm_emulated`` with time as the rows, the column statistics as
    sequential sums over Co (fma for the squares and the cross sum). Its
    tiles do not change a sum: each halo column is computed as every other."""
    B, Ci, T = x.shape
    Co = w.w.shape[0]
    out = torch.empty(B, Co, T, scale)
    for b in range(B):
        idx = torch.arange(-1, T + 1).clamp(0, T - 1)
        z = gemm_emulated(x[b].t()[idx].contiguous(), w.w, bias=w.b)   # (T + 2, Co)
        if w.norm_w is not None:
            su = torch.zeros(T + 2)
            for o in range(Co):
                su = su + z[:, o]
            m = su / Co
            u = z - m[:, None]
            d, c = torch.zeros(T + 2), torch.zeros(T + 1)
            for o in range(Co):
                d = _fma(u[:, o], u[:, o], d)
                c = _fma(u[:-1, o], u[1:, o], c)
        i = torch.arange(1, T + 1)
        for p, (wp, wc, wn) in enumerate(_taps(scale)):
            prev = wp != 0.0
            wo = wp if prev else wn
            io = i - 1 if prev else i + 1
            v = _blend(z[i], z[io], wc, wo)
            if w.norm_w is not None:
                mu, rsd = _moments(m, d, c[i - 1 if prev else i], io, i, wo, wc, Co)
                v = _fma((v - mu[:, None]) * rsd[:, None], w.norm_w, w.norm_b)
            out[b, :, :, p] = v.t()
    return out.reshape(B, Co, T * scale)


def _float64(w: uf.UpWeights) -> uf.UpWeights:
    return uf.UpWeights(*(None if t is None else t.double() for t in w))


def _errors(model, x, w, scale, channel_dim):
    with torch.no_grad():
        exact = uf.up_fused_plain(x.double(), _float64(w), scale=scale, channel_dim=channel_dim)
        plain = uf.up_fused_plain(x, w, scale=scale, channel_dim=channel_dim)
        got = model(x, w, scale)
    assert got.shape == exact.shape
    return ((got.double() - exact).abs().max().item(),
            (plain.double() - exact).abs().max().item(), exact.abs().max().item())


@pytest.mark.parametrize("Ci,Co,scale", [(512, 256, 5), (256, 96, 3), (512, 256, 4),
                                         (256, 96, 4)])
def test_tensor_core_sums_are_as_accurate_as_fp32(Ci, Co, scale):
    """T ragged against the 62-row tile; the errors over the four T taken
    together (at T = 1 both are a few ulp of a few hundred values)."""
    rng = np.random.default_rng([Ci, Co, scale])
    w = _weights(rng, Ci, Co)
    e_model = e_plain = 0.0
    for T in (1, TILE - 1, TILE + 1, 2 * TILE + 3):
        em, ep, peak = _errors(up_tc_emulated, _t(rng, (1, T, Ci)), w, scale, 2)
        assert em <= TOL * max(1.0, peak), (T, em)
        e_model, e_plain = max(e_model, em), max(e_plain, ep)
    assert e_model <= 3 * e_plain, (e_model, e_plain)


@pytest.mark.parametrize("T", [1, TILE - 1, TILE + 1, 2 * TILE + 3])
def test_tensor_core_tiles_repeat_the_edge_frame(T):
    """The tiled model without a norm at scale 2 equals the upsample of its
    own untiled conv: every tile's halo rows are the neighbours' rows, and
    at the ends of the sequence the edge frame itself."""
    rng = np.random.default_rng(T)
    w = _weights(rng, 64, 32, norm=False)
    x = _t(rng, (1, T, 64))
    with torch.no_grad():
        z = gemm_emulated(x[0], w.w, bias=w.b)
        zp, zn = torch.cat([z[:1], z[:-1]]), torch.cat([z[1:], z[-1:]])
        (wp0, wc0, _), (_, wc1, wn1) = _taps(2)
        want = torch.stack([_blend(z, zp, wc0, wp0), _blend(z, zn, wc1, wn1)], 1)
        got = up_tc_emulated(x, w, 2)[0].reshape(T, 2, 32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("Ci,Co,scale", [(96, 48, 3), (48, 24, 2), (16, 12, 5)])
def test_streaming_sums_are_as_accurate_as_fp32(Ci, Co, scale):
    rng = np.random.default_rng([Ci, Co, scale, 1])
    w = _weights(rng, Ci, Co)
    e_model = e_plain = 0.0
    for T in (1, 127, 129, 259):
        em, ep, peak = _errors(up_stream_emulated, _t(rng, (2, Ci, T)), w, scale, 1)
        assert em <= TOL * max(1.0, peak), (T, em)
        e_model, e_plain = max(e_model, em), max(e_plain, ep)
    assert e_model <= 3 * e_plain, (e_model, e_plain)


def test_the_models_match_the_jax_up_path():
    """Both models against ``l3ac_tpu/models/decoder.py:_up_path`` (the jnp
    chain on the CPU) at one shape each."""
    rng = np.random.default_rng(8)
    for Ci, Co, T, scale, in_t, model in ((256, 96, 2 * TILE + 3, 3, False, up_tc_emulated),
                                          (48, 24, 300, 2, True, up_stream_emulated)):
        w = _weights(rng, Ci, Co)
        stage = {"up_conv": {"w": jnp.asarray(w.w.t()[None].numpy()),
                             "b": jnp.asarray(w.b.numpy())},
                 "up_norm": {"w": jnp.asarray(w.norm_w.numpy()),
                             "b": jnp.asarray(w.norm_b.numpy())}}
        x = _t(rng, (1, Ci, T) if in_t else (1, T, Ci))
        want = np.asarray(jdec._up_path(stage, jnp.asarray(x.numpy()), scale, in_t=in_t))
        with torch.no_grad():
            got = model(x, w, scale).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


def _bf16_weights(rng, Ci, Co, norm=True):
    return uf.UpWeights(*(None if t is None else t.bfloat16() for t in _weights(rng, Ci, Co, norm)))


def _check_bf16(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("Ci,Co,scale,norm", [(512, 256, 5, True), (256, 96, 3, True),
                                              (64, 160, 2, True), (24, 32, 4, False)])
def test_wgmma_bf16_sums_match_the_plain_bf16_up_path(Ci, Co, scale, norm):
    """T ragged against the 62-row tile (1, tile - 1, tile + 1, 2 tile + 3),
    the output and its first and last frames (the edge rows' copies)."""
    rng = np.random.default_rng([Ci, Co, scale, 16])
    w = _bf16_weights(rng, Ci, Co, norm)
    for T in (1, TILE - 1, TILE + 1, 2 * TILE + 3):
        x = _t(rng, (2, T, Ci)).bfloat16()
        with torch.no_grad():
            got = up_wgmma_emulated(x, w, scale)
            want = uf.up_fused_plain_bf16(x, w, scale=scale, channel_dim=2)
        _check_bf16(got, want)
        _check_bf16(torch.cat([got[:, :scale], got[:, -scale:]], 1),
                    torch.cat([want[:, :scale], want[:, -scale:]], 1))


def test_wgmma_bf16_sums_match_the_jax_bf16_up_path():
    """The emulated kernel against ``l3ac_tpu/models/decoder.py:_up_path`` in
    bf16 on the same seeded weights: relative L2 within two bf16 ulps."""
    rng = np.random.default_rng(9)
    Ci, Co, T, scale = 256, 96, 2 * TILE + 3, 3
    w = _bf16_weights(rng, Ci, Co)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    stage = {"up_conv": {"w": j(w.w.t()[None]), "b": j(w.b)},
             "up_norm": {"w": j(w.norm_w), "b": j(w.norm_b)}}
    x = _t(rng, (1, T, Ci)).bfloat16()
    want = np.asarray(jdec._up_path(stage, j(x), scale, in_t=False).astype(jnp.float32))
    with torch.no_grad():
        got = up_wgmma_emulated(x, w, scale).float().numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2.0 ** -6


def test_wgmma_route_reads_the_tc_buffer_as_w():
    """At the wgmma route's shapes the "tc" buffer is W (Co, Ci) unpadded,
    then b, norm_w, norm_b: the kernel's TMA map reads W in place."""
    w = _bf16_weights(np.random.default_rng(3), 256, 96)
    assert uf.route_for(256, 96, True, bf16=True) == "wgmma"
    assert uf.tc_padded_co(96) == 96 and uf.tc_row_elems(256, torch.bfloat16) == 256
    assert torch.equal(uf.prepare_up(w, "tc"),
                       torch.cat([w.w.reshape(-1), w.b, w.norm_w, w.norm_b]))


def test_bf16_route_is_a_shape_rule():
    """bf16 (B, T, C) with Ci % 8 == 0 up to 1024 and Co a multiple of 32 up
    to 256 takes the wgmma kernel; other bf16 (B, T, C) shapes the route
    they took before; fp32 and (B, C, T) are unchanged. The rule reads
    nothing but its arguments."""
    for Ci, Co in ((512, 256), (256, 96), (8, 32), (1024, 256), (768, 160)):
        assert uf.route_for(Ci, Co, True, bf16=True) == "wgmma"
        assert uf.route_for(Ci, Co, True) in ("tc", "stream")
    assert uf.route_for(36, 32, True, bf16=True) == "tc"            # Ci % 8 != 0
    assert uf.route_for(768, 320, True, bf16=True) == "tc"          # Co > 256
    assert uf.route_for(1024, 512, True, bf16=True) == "tc"
    assert uf.route_for(512, 100, True, bf16=True) == "tc"          # Co % 32 != 0
    assert uf.route_for(100, 20, True, bf16=True) == "stream"
    assert uf.route_for(256, 96, False, bf16=True) == "general"  # refused before C3 closed
    assert uf.route_for(96, 48, False, bf16=True) == "stream"
    assert [uf.route_for(512, 256, True, bf16=True) for _ in range(3)] == ["wgmma"] * 3


def test_bf16_route_sends_unaligned_x_to_tc():
    """The wgmma kernel's TMA reads x from a 16-byte aligned base: at its
    shapes an x at another address takes "tc" (which takes any x), by the
    rule alone; the other routes do not read the address."""
    for ptr in (0x1000, 0x7f0000000040):
        assert uf.route_for(512, 256, True, bf16=True, x_ptr=ptr) == "wgmma"
    for ptr in (0x1006, 0x100a, 0x1008):
        assert uf.route_for(512, 256, True, bf16=True, x_ptr=ptr) == "tc"
        assert uf.route_for(256, 96, True, bf16=True, x_ptr=ptr) == "tc"
        assert uf.route_for(512, 256, True, x_ptr=ptr) == "tc"
        assert uf.route_for(100, 20, True, bf16=True, x_ptr=ptr) == "stream"
        assert uf.route_for(96, 48, False, bf16=True, x_ptr=ptr) == "stream"


def test_route_is_a_shape_rule():
    assert uf.route_for(512, 256, True) == uf.route_for(256, 96, True) == "tc"
    assert uf.route_for(36, 32, True) == uf.route_for(512, 160, True) == "tc"
    # (B, C, T) never takes the tensor cores; past the stream it takes the
    # general route (it raised before ROADMAP C3 closed)
    assert uf.route_for(256, 96, False) == "general"
    assert uf.route_for(96, 48, False) == uf.route_for(48, 24, False) == "stream"
    assert uf.route_for(100, 20, True) == "stream"       # Co % 32 != 0
    assert uf.route_for(16, 12, False) == uf.route_for(8, 8, False) == "stream"
    assert uf.route_for(512, 100, True) == "tc"          # Ci > 128, Co % 32 != 0: Co padded
    assert uf.route_for(1025, 100, True) == uf.route_for(512, 513, True) == "general"
    assert uf.route_for(96, 61, False) == uf.route_for(128, 60, True) == "stream"
    # the streaming kernel takes (B, C, T) outputs up to 128 wide
    assert uf.route_for(96, 65, False) == uf.route_for(12, 80, False) == "stream"
    assert uf.route_for(128, 128, False) == "stream"
    assert uf.route_for(96, 129, False) == uf.route_for(129, 48, False) == "general"
    assert uf.route_for(0, 48, False) is None and uf.route_for(96, 0, True) is None


def test_prepare_up_lays_the_weights_out_as_the_kernels_read_them():
    rng = np.random.default_rng(2)
    w = _weights(rng, 42, 24)
    st = uf.prepare_up(w, "stream")                      # W as (32, 48 + 4), zero-padded
    wk = st[:32 * 52].view(32, 52)
    assert torch.equal(wk[:24, :42], w.w)
    assert not wk[24:].any() and not wk[:, 42:].any()
    assert torch.equal(st[32 * 52:], torch.cat([w.b, w.norm_w, w.norm_b]))
    w = _weights(rng, 64, 32, norm=False)
    assert torch.equal(uf.prepare_up(w, "tc"), torch.cat([w.w.reshape(-1), w.b]))


@pytest.mark.parametrize("Ci,Co", [(96, 48), (48, 24), (37, 113), (128, 128)])
def test_stream_bf16_buffer_unpacks_to_the_padded_weight(Ci, Co):
    """``prepare_up(w, "stream_bf16")`` read as a lane of up_fused_bf16.cu
    reads its A fragments (m16n8k16: register j of lane 4 g + t holds row
    g + 8 (j % 2), columns 2t + 8 (j // 2) and the next) gives W zero-padded
    to multiples of 16, then b, norm_w, norm_b zero-padded; all bf16."""
    rng = np.random.default_rng([Ci, Co])
    w = uf.UpWeights(*(t.bfloat16() for t in _weights(rng, Ci, Co)))
    buf = uf.prepare_up(w, "stream_bf16")
    Mp, Kp = -(-Co // 16) * 16, -(-Ci // 16) * 16
    assert buf.dtype == torch.bfloat16 and buf.numel() == Mp * Kp + 3 * Mp
    frag = buf[:Mp * Kp].view(Mp // 16, Kp // 16, 32, 4, 2)
    back = torch.zeros(Mp, Kp, dtype=torch.bfloat16)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            for e in range(2):
                back.view(Mp // 16, 16, Kp // 16, 16)[:, g + 8 * (j % 2), :, 2 * t + 8 * (j // 2) + e] = \
                    frag[:, :, lane, j, e]
    assert torch.equal(back, F.pad(w.w, (0, Kp - Ci, 0, Mp - Co)))
    vec = buf[Mp * Kp:].view(3, Mp)
    for got, want in zip(vec, (w.b, w.norm_w, w.norm_b)):
        assert torch.equal(got, F.pad(want, (0, Mp - Co)))


def test_stream_buffer_is_a_rule_of_dtype_and_layout():
    assert uf.stream_buffer(torch.bfloat16, False) == "stream_bf16"
    assert uf.stream_buffer(torch.bfloat16, True) == "stream"
    assert uf.stream_buffer(torch.float32, False) == "stream"
    assert uf.route_for(96, 48, False) == uf.route_for(20, 36, True) == "stream"


def test_up_variants_bf16_substitutions_apply_once_and_need_the_card():
    from l3ac_tpu_torch.tools import up_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    for source, variants in ((tool.SOURCE_BF16, tool.STREAM_VARIANTS_BF16),
                             (tool.STREAM_SOURCE, tool.STREAM_VARIANTS_PR12)):
        sources = {variant_source(source, subs, "up_variants") for _, subs, _ in variants}
        assert len(sources) == len(variants)
    for source, variants in ((tool.SOURCE_WGMMA, tool.TC_VARIANTS_WGMMA),
                             (tool.TC_SOURCE, tool.TC_VARIANTS_PREV)):
        sources = {variant_source(source, subs, "up_variants") for _, subs, _ in variants}
        assert len(sources) == len(variants)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main(["--bf16"])


def _decoder(seed=0):
    return get_model("debug", device="cpu", seed=seed).codec.decoder


def test_up_prepared_is_cached_and_built_per_route():
    dec = _decoder()
    st = dec.stages[0]
    p = st.up_prepared()
    assert st.up_prepared() is p and len(p) == 0     # nothing is built before a launch asks
    buf = p.buffer("stream", st.up_weights())
    assert st.up_prepared() is p and p.buffer("stream", st.up_weights()) is buf
    assert torch.equal(buf, uf.prepare_up(st.up_weights(), "stream"))


def test_up_prepared_follows_load_state_dict_and_in_place_changes():
    dec = _decoder(0)
    st = dec.stages[1]
    with torch.no_grad():
        p = st.up_prepared()
        p.buffer("stream", st.up_weights())
        dec.load_state_dict(_decoder(7).state_dict())
        q = st.up_prepared()
        assert q is not p
        assert torch.equal(q.buffer("stream", st.up_weights()),
                           uf.prepare_up(st.up_weights(), "stream"))
        st.up_conv.weight.mul_(2.0)
        r = st.up_prepared()
        assert r is not q
        assert torch.equal(r.buffer("stream", st.up_weights()),
                           uf.prepare_up(st.up_weights(), "stream"))
        st.up_norm.bias.add_(0.5)
        assert st.up_prepared() is not r


def test_up_prepared_is_never_cached_for_inference_tensors():
    with torch.inference_mode():   # a decoder built here holds inference tensors
        dec = Decoder(get_config("debug").network_config)
        dec.init_weights(torch.Generator().manual_seed(0))
        st = dec.stages[0]
        assert st.up_conv.weight.is_inference()
        assert st.up_prepared() is not st.up_prepared()
        w = st.up_weights()
        assert uf.prepared_up(w) is not uf.prepared_up(w)


def test_a_warm_decode_transposes_no_up_weight(monkeypatch):
    """The decoder hands each up path its stage's cached buffers: the up
    wrappers, standing in for their CUDA route, ask for the buffer of their
    shape's route; the cold decode prepares each once, a warm one nothing."""
    import l3ac_tpu_torch.models.decoder as mdec
    dec = _decoder()
    calls, seen = [], []
    prepare = uf.prepare_up
    monkeypatch.setattr(uf, "prepare_up", lambda w, route: calls.append(route) or
                        prepare(w, route))

    def launch_path(fn, channels_last):
        def wrapper(x, w, *, scale, prepared, **kw):
            Ci = x.shape[2] if channels_last else x.shape[1]
            seen.append(prepared)
            prepared.buffer(uf.route_for(Ci, w.w.shape[0], channels_last), w)
            return fn(x, w, scale=scale, **kw)
        return wrapper

    monkeypatch.setattr(mdec, "up_fused", launch_path(uf.up_fused, True))
    monkeypatch.setattr(mdec, "up_fused_ct", launch_path(uf.up_fused_ct, False))
    x = _t(np.random.default_rng(0), (1, 12, 32))
    with torch.no_grad():
        first = dec(x)
        assert calls == ["stream"] * len(dec.stages)
        calls.clear()
        assert torch.equal(dec(x), first)
    assert not calls
    n = len(dec.stages)
    assert all(a is b for a, b in zip(seen[:n], seen[n:]))


def test_up_variants_tool_applies_to_the_kernels_and_needs_the_card():
    """tools/up_variants.py builds its variants by text substitution on the two
    kernels' sources: every substitution matches exactly once; without CUDA
    the tool exits with a message, building nothing."""
    from l3ac_tpu_torch.tools import up_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    for source, variants in ((tool.TC_SOURCE, tool.TC_VARIANTS),
                             (tool.WGMMA_SOURCE, tool.WGMMA_VARIANTS),
                             (tool.STREAM_SOURCE, tool.STREAM_VARIANTS)):
        sources = {variant_source(source, subs, "up_variants") for _, subs, _ in variants}
        assert len(sources) == len(variants)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])
