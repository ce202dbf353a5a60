"""Each kernel family's gradient through its autograd Function against the
same gradient through its plain version, on seeded inputs.

For every entry point of the training path (``ops/kernels/autograd.py``),
:func:`case` builds inputs at a named shape (leaf tensors that require grad:
the activations, every weight and the attention's position table),
:func:`grads` takes ``torch.autograd.grad`` of ``(out * r).sum()`` with a
seeded ``r`` through the wrapper and through the plain version, and
:func:`distances` gives the forward's error and the relative L2 distance of
each input's two gradients. On the card the wrapper launches the kernel and
its backward is the plain version's VJP at the same saved inputs, so the
gradients agree up to the order of cuDNN's and cuBLAS's sums: the gradient
check tests the Function's wiring (argument order, inputs that need no
gradient), not the kernel; the kernel is tested by the forward's error.
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold both, and the CPU
tests run the same cases with a stand-in launch.

Shapes: ``"debug"`` (small, any device) and ``"1kbps"``, one full-width shape
of each family on a 2 x 3 s training batch (T = 47790 samples).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .ops.attention import local_attention as attention_plain
from .ops.kernels import conv_unit as cu
from .ops.kernels import first_block as fb
from .ops.kernels import legacy_tail as lt
from .ops.kernels import local_attention as la
from .ops.kernels import up_fused as uf
from .ops.resample import interleave

FAMILIES = ("first_block", "conv_unit_ct", "conv_unit", "local_attention", "up_fused_ct",
            "up_fused", "legacy_tail_poly_ct", "legacy_tail_ct")

# (family) -> shape parameters at each size
SHAPES = {
    "debug": {"first_block": (2, 157, 8), "conv_unit_ct": (2, 12, 96),
              "conv_unit": (2, 24, 16), "local_attention": (2, 6, 32, 8, 16),
              "up_fused_ct": (2, 12, 8, 24, 2), "up_fused": (2, 24, 16, 12, 3),
              "legacy_tail_poly_ct": (2, 8, 48), "legacy_tail_ct": (2, 8, 96)},
    # 1kbps on 2 x 3 s: the stem; the encoder's C = 48 stage; its last units
    # (C = 192 at 531 tokens of the conv hop); the down transformer's window
    # of 750 (D = 32); the last up path in phase-split form (48 -> 24, s 2)
    # and the first wide one (512 -> 256, s 5); the tail on the phase pair
    # and on the interleaved input
    "1kbps": {"first_block": (2, 47790, 24), "conv_unit_ct": (2, 48, 7965),
              "conv_unit": (2, 531, 192), "local_attention": (2, 6, 750, 32, 750),
              "up_fused_ct": (2, 48, 24, 7965, 2), "up_fused": (2, 177, 512, 256, 5),
              "legacy_tail_poly_ct": (2, 24, 23895), "legacy_tail_ct": (2, 24, 47790)},
}


# parameters whose gradient is zero in exact arithmetic, which therefore holds
# roundoff alone (and follows it anywhere): each EnhanceBlock branch's bias
# adds a constant over time that its instance norm removes, and the position
# MLP's last bias adds one constant to all of a head's scores, which the
# softmax removes
EXACT_ZERO = re.compile(r"(enhance\.base\.branches\.\d+\.bias|dyn_bias\.b2)$")


def exact_zero(name: str) -> bool:
    """True for a parameter (state-dict name) whose gradient is zero in exact
    arithmetic (:data:`EXACT_ZERO`)."""
    return EXACT_ZERO.search(name) is not None


def negligible(want: dict) -> set:
    """The leaves of a gradient ``want`` (name -> tensor) that hold roundoff
    alone: those zero in exact arithmetic, and those whose norm is at most
    1e-6 of the whole gradient's (at a given input a leaf's gradient can be
    that small, e.g. a position MLP whose whole table meets one masked
    window)."""
    scale = sum(w.double().norm().item() ** 2 for w in want.values()) ** 0.5
    return {n for n, w in want.items() if exact_zero(n) or w.norm().item() <= 1e-6 * scale}


def scale_of(want: dict) -> float:
    """The whole gradient's norm."""
    return sum(w.double().norm().item() ** 2 for w in want.values()) ** 0.5


def _t(rng, shape, std, device) -> torch.Tensor:
    t = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(device)
    return t.requires_grad_()


def _pos(rng, shape, device) -> torch.Tensor:
    t = 1.0 + torch.from_numpy(np.abs(rng.standard_normal(shape) * 0.3).astype(np.float32))
    return t.to(device).requires_grad_()


def _unit_weights(rng, C, device) -> cu.ConvUnitWeights:
    return cu.ConvUnitWeights(
        _t(rng, (C, 1, 7), 0.3, device), _t(rng, (C,), 0.1, device),
        _pos(rng, (C,), device), _t(rng, (C,), 0.1, device),
        _t(rng, (4 * C, C), C ** -0.5, device), _t(rng, (4 * C,), 0.1, device),
        _pos(rng, (4 * C,), device), _t(rng, (4 * C,), 0.2, device),
        _t(rng, (4 * C,), 0.2, device), _t(rng, (C, 4 * C), (4 * C) ** -0.5, device),
        _t(rng, (C,), 0.1, device))


def case(name: str, size: str, device, seed: int = 0):
    """(call, plain, inputs) of family ``name`` at ``SHAPES[size]``: ``call``
    runs the wrapper and ``plain`` the plain version on ``inputs``, each
    returning one tensor."""
    rng = np.random.default_rng([FAMILIES.index(name), seed])
    s = SHAPES[size][name]
    if name == "first_block":
        B, T, Cout = s
        w = fb.FirstBlockWeights(_t(rng, (5, 4, 7), 0.3, device), _t(rng, (5, 4), 0.1, device),
                                 _t(rng, (80, 20), 0.2, device), _t(rng, (80,), 0.1, device),
                                 _t(rng, (Cout, 81), 0.1, device), _t(rng, (Cout,), 0.1, device))
        x = _t(rng, (B, T), 0.3, device)
        return (lambda x, *ws: fb.first_block(x, fb.FirstBlockWeights(*ws)),
                lambda x, *ws: fb.first_block_plain(x, fb.FirstBlockWeights(*ws)), [x, *w])
    if name in ("conv_unit_ct", "conv_unit"):
        B, a, b = s
        C = a if name == "conv_unit_ct" else b
        w = _unit_weights(rng, C, device)
        x = _t(rng, (B, a, b), 1.0, device)
        wrapper, dim = (cu.conv_unit_ct, 1) if name == "conv_unit_ct" else (cu.conv_unit, 2)
        return (lambda x, *ws: wrapper(x, cu.ConvUnitWeights(*ws)),
                lambda x, *ws: cu.conv_unit_plain(x, cu.ConvUnitWeights(*ws), channel_dim=dim),
                [x, *w])
    if name == "local_attention":
        B, H, T, D, n = s
        qkv = _t(rng, (B, T, 3 * H * D), 1.0, device)
        table = _t(rng, (2 * n, H), 1.0, device)

        def heads(qkv):
            return [t.view(B, T, H, D).permute(0, 2, 1, 3) for t in qkv.chunk(3, dim=-1)]

        return (lambda qkv, tab: la.local_attention(*heads(qkv), window_size=n, bias_table=tab),
                lambda qkv, tab: attention_plain(*heads(qkv), window_size=n, bias_table=tab),
                [qkv, table])
    if name in ("up_fused_ct", "up_fused"):
        B, Ci, Co, T, scale = s if name == "up_fused_ct" else (s[0], s[2], s[3], s[1], s[4])
        w = uf.UpWeights(_t(rng, (Co, Ci), Ci ** -0.5, device), _t(rng, (Co,), 0.3, device),
                         _pos(rng, (Co,), device), _t(rng, (Co,), 0.2, device))
        if name == "up_fused":
            x = _t(rng, (B, T, Ci), 1.0, device)
            return (lambda x, *ws: uf.up_fused(x, uf.UpWeights(*ws), scale=scale),
                    lambda x, *ws: uf.up_fused_plain(x, uf.UpWeights(*ws), scale=scale,
                                                     channel_dim=2), [x, *w])
        x = _t(rng, (B, Ci, T), 1.0, device)
        return (lambda x, *ws: torch.stack(uf.up_fused_ct(x, uf.UpWeights(*ws), scale=scale,
                                                          phase_split=True)),
                lambda x, *ws: torch.stack(uf.up_fused_plain(x, uf.UpWeights(*ws), scale=scale,
                                                             channel_dim=1, phase_split=True)),
                [x, *w])
    B, C, T = s
    std = 0.1 * (24 / C) ** 0.5
    w = lt.TailWeights(_pos(rng, (3, C), device), _t(rng, (3, C, C, 7), std, device),
                       _t(rng, (3, C), 0.1, device), _pos(rng, (3, C), device),
                       _t(rng, (3, C, C), std, device), _t(rng, (3, C), 0.1, device),
                       _pos(rng, (C,), device), _t(rng, (1, C, 7), std, device),
                       _t(rng, (1,), 0.05, device))
    if name == "legacy_tail_poly_ct":
        x0, x1 = _t(rng, (B, C, T), 1.0, device), _t(rng, (B, C, T), 1.0, device)
        return (lambda x0, x1, *ws: lt.legacy_tail_poly_ct(x0, x1, lt.TailWeights(*ws)),
                lambda x0, x1, *ws: lt.legacy_tail_plain(interleave([x0, x1], 2),
                                                         lt.TailWeights(*ws)), [x0, x1, *w])
    x = _t(rng, (B, C, T), 1.0, device)
    return (lambda x, *ws: lt.legacy_tail_ct(x, lt.TailWeights(*ws)),
            lambda x, *ws: lt.legacy_tail_plain(x, lt.TailWeights(*ws)), [x, *w])


def grads(fn, inputs: list[torch.Tensor], seed: int = 1):
    """(output, gradients of ``(fn(*inputs) * r).sum()`` for every input), r
    seeded standard normal of the output's shape."""
    out = fn(*inputs)
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    g = torch.autograd.grad((out * r.to(out.device)).sum(), inputs)
    return out.detach(), g


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| (0 where both are 0)."""
    den = torch.linalg.vector_norm(want.double()).item()
    num = torch.linalg.vector_norm((got - want).double()).item()
    return num / den if den else num


def distances(name: str, size: str, device, seed: int = 0) -> tuple[float, list[float]]:
    """The forward's max abs error to the plain version's, over max(1, max
    |plain|), and the relative L2 distance of each input's gradient through
    the wrapper to its gradient through the plain version (input order of
    :func:`case`). The gradients check the Function's wiring only: its
    backward is the plain version's VJP."""
    call, plain, inputs = case(name, size, device, seed)
    out, got = grads(call, inputs)
    want_out, want = grads(plain, inputs)
    err = (out - want_out).abs().max().item() / max(1.0, want_out.abs().max().item())
    return err, [rel_l2(g, w) for g, w in zip(got, want)]
