"""The general routes' two row passes (``csrc/general_rows.cu``) emulated in
torch, in the kernels' order of operations, for the CPU tests.

- dw + norm: the depthwise conv as the kernel forms it from a tile's staged
  rows (zero outside [0, T)): ``dw_b``, then one fp32 fma a tap; each row
  on two warps of 32 lanes, lane l of warp h holding the 16-byte channel
  groups ``64 j + 32 h + l`` (V = 4 fp32 or 8 bf16 channels each); each
  half's sum in slot order, then the xor butterfly over its lanes, its mean,
  the fmas of the squared deviations, the butterfly again; the halves'
  (count, mean, M2) merged by Chan's formula, the chunks' likewise.
- blend + norm: z's rows clamped at the edges, each phase's products and
  sum rounded once; a channels-last row on one warp (lane l: 4-channel
  groups ``l + 32 j``), every other layout's row on half a warp (lane l of
  16: channels ``l + 16 i``); the same sums, merges and chunks.
- Both: den = sqrt(M2 / C + eps), 1 / den rounded, IEEE division's
  quotient by one Newton step on it, ``w q + b`` as one fma, one rounding
  to the output's dtype.

An fp32 fma is the exact product and sum in float64, rounded once to fp32.
"""

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8


def f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def fma(a, b, c) -> torch.Tensor:
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def lanes_sum(s: torch.Tensor) -> torch.Tensor:
    """The xor butterfly over the last axis (a row's lanes): every lane ends
    with the same fp32 sum; returns it."""
    G = s.shape[-1]
    idx = torch.arange(G)
    m = G // 2
    while m:
        s = s + s[..., idx ^ m]
        m //= 2
    return s[..., 0]


def moments(v: torch.Tensor, valid: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, M2) of rows whose lanes hold v (..., lanes, slots), zero where
    not ``valid``: each lane's sum in slot order, the butterfly, the mean;
    then each lane's fmas of the squared deviations, the butterfly."""
    s = torch.zeros(v.shape[:-1])
    for i in range(v.shape[-1]):
        s = s + v[..., i]
    mean = lanes_sum(s) / f32(n)
    q = torch.zeros(v.shape[:-1])
    for i in range(v.shape[-1]):
        d = v[..., i] - mean[..., None]
        q = torch.where(valid[..., i], fma(d, d, q), q)
    return mean, lanes_sum(q)


def chan_merge(a, na: int, b, nb: int):
    """(mean, M2) of na values merged with nb more, as the kernel merges."""
    if na == 0 or nb == 0:
        return b if na == 0 else a
    n = f32(na + nb)
    d = b[0] - a[0]
    mean = fma(d, f32(nb) / n, a[0])
    return mean, fma(d * d, f32(na) * f32(nb) / n, a[1] + b[1])


def normed(v, mean, m2, C: int, w, b) -> torch.Tensor:
    """w (v - mean) / den + b as the kernels compute it."""
    den = torch.sqrt(m2 / f32(C) + f32(EPS))
    rcp = f32(1.0) / den
    n = v - mean
    q0 = n * rcp
    return fma(w, fma(fma(-q0, den, n), rcp, q0), b)


def _row_moments(v: torch.Tensor, C: int, cw: int, slots) -> tuple:
    """The moments of rows v (rows, C) over chunks of cw channels: slots(cn)
    -> (index (parts, lanes, slots) of chunk channels, or -1), the parts
    (warps or half warps) a row's moments are merged from."""
    run, counted = None, 0
    for c0 in range(0, C, cw):
        cn = min(cw, C - c0)
        idx = slots(cn)
        valid = idx >= 0
        vals = torch.where(valid, v[:, c0 + idx.clamp(min=0)], torch.zeros(()))
        chunk, n_chunk = None, 0
        for part in range(idx.shape[0]):
            n = int(valid[part].sum())
            if n == 0:
                continue
            m = moments(vals[:, part], valid[part], n)
            chunk = m if chunk is None else chan_merge(chunk, n_chunk, m, n)
            n_chunk += n
        run = chunk if run is None else chan_merge(run, counted, chunk, cn)
        counted += cn
    return run


def dw_slots(cn: int, V: int) -> torch.Tensor:
    """dw + norm: chunk channel of (warp h, lane l, slot j V + e), -1 past cn."""
    nj = -(-(-(-cn // V)) // 64)
    h, l, j, e = np.meshgrid(np.arange(2), np.arange(32), np.arange(nj), np.arange(V),
                             indexing="ij")
    c = (l + 32 * (2 * j + h)) * V + e
    return torch.from_numpy(np.where(c < cn, c, -1).reshape(2, 32, nj * V))


def dw_norm_emulated(x: torch.Tensor, dw: torch.Tensor, dw_b: torch.Tensor,
                     nw: torch.Tensor | None, nb: torch.Tensor | None, dil: int,
                     cw: int | None = None) -> torch.Tensor:
    """The dw + norm pass on x (B, T, C) fp32 or bf16 (dw (C, K), vectors
    fp32), in chunks of cw channels (default: one chunk) -> (B, T, C) of x's
    dtype."""
    B, T, C = x.shape
    K = dw.shape[1]
    pad = (K - 1) * dil // 2
    V = 8 if x.dtype == torch.bfloat16 else 4
    xs = F.pad(x.float(), (0, 0, pad, pad))    # a tile's staged rows: zero outside [0, T)
    v = dw_b.expand(B, T, C).clone()
    for kk in range(K):
        v = fma(dw[:, kk], xs[:, kk * dil:kk * dil + T], v)
    v = v.reshape(B * T, C)
    if nw is not None:
        mean, m2 = _row_moments(v, C, cw or C, lambda cn: dw_slots(cn, V))
        v = normed(v, mean[:, None], m2[:, None], C, nw, nb)
    return v.reshape(B, T, C).to(x.dtype)


def up_slots(cn: int, tile: bool) -> torch.Tensor:
    """blend + norm: chunk channel of (part, lane, slot), -1 past cn; a row
    on one warp (4-channel groups) or, in the tile layouts, half a warp."""
    if tile:
        n = -(-cn // 16)
        l, i = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
        c = l + 16 * i
        return torch.from_numpy(np.where(c < cn, c, -1)[None])
    nj = -(-(-(-cn // 4)) // 32)
    l, j, e = np.meshgrid(np.arange(32), np.arange(nj), np.arange(4), indexing="ij")
    c = 4 * (l + 32 * j) + e
    return torch.from_numpy(np.where(c < cn, c, -1).reshape(1, 32, nj * 4))


def blend_phases(z: torch.Tensor, taps) -> list[torch.Tensor]:
    """Each phase of z (B, T, Co) from its clamped neighbours: cur wc + nbr
    wo, each product and the sum rounded once."""
    prev = torch.cat([z[:, :1], z[:, :-1]], 1)
    nxt = torch.cat([z[:, 1:], z[:, -1:]], 1)
    if len(taps) == 1:
        return [z]
    return [z * f32(wc) + (prev * f32(wp) if wp else nxt * f32(wn)) for wp, wc, wn in taps]


def up_blend_norm_emulated(z: torch.Tensor, taps, nw, nb, layout: str, dtype,
                           cw: int | None = None):
    """The blend + norm pass on z (B, T, Co) fp32 into ``layout`` ("cl" (B,
    T s, Co), "cf" (B, Co, T s), "ps" the phase tuple of (B, Co, T)), in
    chunks of cw channels (default: one chunk)."""
    B, T, Co = z.shape
    y = torch.stack(blend_phases(z, taps), 2).reshape(-1, Co)   # rows (b, t, p)
    if nw is not None:
        mean, m2 = _row_moments(y, Co, cw or Co, lambda cn: up_slots(cn, layout != "cl"))
        y = normed(y, mean[:, None], m2[:, None], Co, nw, nb)
    y = y.reshape(B, T * len(taps), Co).to(dtype)
    if layout == "cl":
        return y
    if layout == "cf":
        return y.transpose(1, 2)
    return tuple(y.reshape(B, T, len(taps), Co)[:, :, p].transpose(1, 2) for p in range(len(taps)))
