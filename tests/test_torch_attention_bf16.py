"""The host side of the bf16 attention kernel (``csrc/local_attention_bf16.cu``)
on the CPU: its prepared table, its route rule, its work list and the tile
classes its softmax relies on, modelled in PyTorch and Python; and its
softmax in base 2, emulated, against the bf16 plain version.

- ``prepare_table`` is the (2n, H) table as (H, 2n) fp32 times log2 e: under
  the kernel's index n + i - j it reproduces ``expand_position_table`` times
  log2 e for every kept pair, with one fp32 rounding.
- The staged table's zero pads cover every index a tile forms: tiles that
  no row of a warpgroup masks read indices in [0, 2n + 64), the others in
  [-128, 2n + 64).
- ``route_for`` is a pure rule of strides and addresses.
- ``work_item`` (the kernel's list, longest first) covers every (query
  tile, window, batch * head) once.
- The kernel's softmax (x = s log2 e + tab, P = 2^(x - m) rounded to bf16,
  the sum in fp32, O divided at the end) stays within the bf16 tolerance
  of the plain version on the debug widths.
- ``tools/attention_variants.py --bf16``'s substitutions apply to both bf16
  sources exactly once, and the tool needs the card.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from l3ac_tpu_torch.ops import attention as tattn
from l3ac_tpu_torch.ops.kernels import local_attention as la
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

KEYS = 64         # keys per tile (csrc/local_attention_bf16.cu kKeys)
TAB_LO, TAB_HI = 128, 64   # the staged table's zero pads (kTabLo, kTabHi)
BF16_TOL = 2.0 ** -6


def _t(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


@pytest.mark.parametrize("n,H", [(16, 2), (250, 6), (100, 3)])
def test_prepared_table_reproduces_the_bias_under_the_kernels_index(n, H):
    table = _t(np.random.default_rng(n), (2 * n, H), 10.0).bfloat16()
    prep = la.prepare_table(table)
    assert prep.shape == (H, 2 * n) and prep.dtype == torch.float32 and prep.is_contiguous()
    bias = tattn.expand_position_table(table).float()                 # (H, n, 2n)
    i = torch.arange(n)[:, None]
    j = torch.arange(2 * n)[None, :]
    kept = j <= n + i
    idx = (n + i - j).clamp(min=0)
    got = prep[:, idx]                                                 # (H, n, 2n)
    want = (bias * la.LOG2E).float()
    assert torch.equal(got[:, kept], want[:, kept])
    assert (n + i - j)[kept].min() >= 0 and (n + i - j)[kept].max() < 2 * n


def _items(n, W, BH, H):
    nq = -(-n // la.Q_ROWS)
    return [la.work_item(idx, n, W, BH, H) for idx in range(nq * W * BH)]


@pytest.mark.parametrize("n,W", [(16, 3), (100, 1), (250, 3), (750, 3)])
def test_the_table_pads_cover_every_index_a_tile_forms(n, W):
    """For each item and warpgroup (64 rows) and each key tile it computes
    (keys from j_begin up to the warpgroup's last stored row's last key),
    the index n + i - j over all its rows (rows past n included: they are
    computed, never stored) and keys."""
    for i0, w, _, _ in _items(n, W, 1, 1):
        rows = min(la.Q_ROWS, n - i0)
        j_begin = n if w == 0 else 0
        ntiles = -(-(n + i0 + rows - j_begin) // KEYS)
        for cw in range(2):
            i0w = i0 + 64 * cw
            if i0w >= n:
                continue
            r_hi = min(i0w + 63, n - 1)
            for t in range(ntiles):
                j0 = j_begin + t * KEYS
                if j0 > n + r_hi:
                    continue
                lo, hi = n + i0w - (j0 + KEYS - 1), n + i0w + 63 - j0
                if j0 + KEYS - 1 <= n + i0w:     # no row of the warpgroup masks a key
                    assert lo >= 0
                assert lo >= -TAB_LO and hi < 2 * n + TAB_HI


def test_route_rule_is_a_pure_rule_of_strides_and_addresses():
    aligned = [2250 * 576, 32, 576] * 3
    assert la.route_for(aligned, [0x1000, 0x1040, 0x1080]) == "tma"
    assert la.route_for(aligned, [0x1000, 0x1048, 0x1080]) == "cp_async"   # 8-byte aligned k
    assert la.route_for([300 * 60, 20, 60] * 3, [0x1000] * 3) == "cp_async"  # D = 20 head views
    assert la.route_for([0, 32, 576] * 3, [0x1000] * 3) == "tma"             # B = 1
    assert la.route_for(aligned[:8] + [4], [0x1000] * 3) == "cp_async"


@pytest.mark.parametrize("n,W,B,H", [(16, 3, 2, 3), (250, 3, 8, 6), (750, 1, 1, 2), (300, 2, 1, 1)])
def test_work_list_covers_every_item_once_longest_first(n, W, B, H):
    items = _items(n, W, B * H, H)
    nq = -(-n // la.Q_ROWS)
    assert sorted(items) == sorted((qt * la.Q_ROWS, w, b, h) for qt in range(nq)
                                   for w in range(W) for b in range(B) for h in range(H))
    costs = [-(-(n + i0 + min(la.Q_ROWS, n - i0) - (n if w == 0 else 0)) // KEYS)
             for i0, w, _, _ in items]
    later = [w == 0 for _, w, _, _ in items]
    assert later == sorted(later)                        # windows w >= 1 first
    for cls in (False, True):
        c = [x for x, z in zip(costs, later) if z == cls]
        assert c == sorted(c, reverse=True)


def attention_bf16_emulated(q, k, v, n, table):
    """The kernel's softmax on bf16 q, k, v (B, H, T, D) and a (2n, H) table:
    q scaled in bf16, x = s log2 e + tab (the prepared table), P = 2^(x - m)
    with the final m rounded to bf16, the fp32 sum of the unrounded P, O / sum
    rounded once (one tile: the online rescale is exact up to fp32)."""
    B, H, T, D = q.shape
    W = T // n
    scale = torch.tensor(D ** -0.5, dtype=torch.bfloat16)
    prep = la.prepare_table(table)
    i = torch.arange(n)[:, None]
    j = torch.arange(2 * n)[None, :]
    kept = (j <= n + i)
    tab = prep[:, (n + i - j).clamp(min=0)]                            # (H, n, 2n)
    out = torch.empty(B, H, T, D)
    for w in range(W):
        qs = (q[:, :, w * n:(w + 1) * n] * scale).float()
        lo = (w - 1) * n
        ks = torch.cat([torch.zeros(B, H, n, D), k[:, :, max(lo, 0):(w + 1) * n].float()], 2) \
            if w == 0 else k[:, :, lo:(w + 1) * n].float()
        vs = torch.cat([torch.zeros(B, H, n, D), v[:, :, max(lo, 0):(w + 1) * n].float()], 2) \
            if w == 0 else v[:, :, lo:(w + 1) * n].float()
        s = qs @ ks.transpose(-1, -2)
        x = torch.addcmul(tab[None], s, torch.tensor(la.LOG2E, dtype=torch.float32))
        mask = kept if w > 0 else kept & (j >= n)
        x = x.masked_fill(~mask, float("-inf"))
        m = x.amax(-1, keepdim=True)
        p = torch.exp2(x - m)
        o = p.bfloat16().float() @ vs
        out[:, :, w * n:(w + 1) * n] = o / p.sum(-1, keepdim=True)
    return out.bfloat16()


@pytest.mark.parametrize("n,D", [(16, 8), (16, 32), (40, 20)])
def test_base_two_softmax_is_within_the_bf16_tolerance(n, D):
    """debug's window (16) and head dims, and a ragged one."""
    rng = np.random.default_rng([n, D])
    B, H, T = 2, 3, 3 * n
    q, k, v = (_t(rng, (B, H, T, D)).bfloat16() for _ in range(3))
    table = _t(rng, (2 * n, H)).bfloat16()
    got = attention_bf16_emulated(q, k, v, n, table).float()
    want = la.local_attention_plain(q, k, v, window_size=n, bias_table=table).float()
    err = (got - want).abs().max().item()
    assert err <= BF16_TOL * max(1.0, want.abs().max().item()), err
    assert (got == want).float().mean().item() >= 0.5


def test_attention_variants_bf16_substitutions_apply_once_and_need_the_card():
    from l3ac_tpu_torch.tools import attention_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    for source, variants in ((tool.SOURCE_BF16, tool.VARIANTS_BF16),
                             (tool.SOURCE_PR12, tool.VARIANTS_PR12)):
        sources = {variant_source(source, subs, "attention_variants") for _, subs, _ in variants}
        assert len(sources) == len(variants)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main(["--bf16"])


def test_attention_variants_c4_substitutions_apply_once():
    """The head-dim 48-64 variants of ``--bf16`` (C4): every substitution
    matches the kernel's source exactly once, each variant is its own
    source, and the first is the source as the port builds it."""
    from l3ac_tpu_torch.tools import attention_variants as tool
    from l3ac_tpu_torch.tools import variant_source
    sources = [variant_source(tool.SOURCE_BF16, subs, "attention_variants")
               for _, subs in tool.C4_VARIANTS]
    assert len(set(sources)) == len(sources)
    assert sources[0] == tool.SOURCE_BF16.read_text()


@pytest.mark.parametrize("D,cols", [(4, 16), (16, 16), (20, 32), (32, 32), (36, 64), (48, 64),
                                    (64, 64), (68, 128), (128, 128)])
def test_instance_rule_names_the_instantiation_of_each_head_dim(D, cols):
    """``instance_for`` mirrors the kernel's dispatch: D zero-padded to 16,
    32, 64 or 128 (D = 33-64 on the 64-column instantiation since C4's fix);
    ``INSTANCES`` has a count for each."""
    assert la.instance_for(D) == cols and cols in la.INSTANCES
