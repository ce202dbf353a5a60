"""Stage-by-stage cost of a conv_unit_ct-like chain on bf16 (B, C, T): the
counterpart of the TPU probe ``tools/bisect_kernel.py``.

    python3 -m l3ac_tpu_torch.tools.bisect_kernel [--device cpu]

For each shape (the probe's: (8, 96, 26624), (8, 48, 79872), (8, 24, 159744))
and tile S (2048, 8192; a tile that does not divide T is skipped, as the
probe skips it, so S = 2048 at all three), runs ``conv_unit_stages`` in the
seven modes, copy, halo_only, dw, norm, mm, dw_mm and full, and prints the
probe's line: the time per call of each mode (CUDA events on the card).
Inputs come from a seeded ``torch.Generator`` with the probe's scales: x,
the depthwise weight and the two product weights normal, the products'
weights times 0.05, all bf16.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from . import describe, device, time_ms
from ..ops.kernels.conv_unit_stages import MODES, TAPS, conv_unit_stages

SHAPES = ((8, 96, 26624), (8, 48, 79872), (8, 24, 159744))
TILES = (2048, 8192)
ITERS = 30  # timed calls per mode


class StageInputs(NamedTuple):
    x: torch.Tensor    # (B, C, T)
    dww: torch.Tensor  # (C, 7)
    w1t: torch.Tensor  # (4C, C)
    w2t: torch.Tensor  # (C, 4C)


def cases() -> list[tuple[int, int, int, int]]:
    """(B, C, T, S) for each of SHAPES and each of TILES that divides T."""
    return [(B, C, T, S) for B, C, T in SHAPES for S in TILES if T % S == 0]


def make(B: int, C: int, T: int, dev="cpu") -> StageInputs:
    g = torch.Generator().manual_seed(0)

    def normal(*shape, scale=None):
        t = torch.randn(shape, generator=g).bfloat16()
        return (t if scale is None else t * scale).to(dev)

    return StageInputs(normal(B, C, T), normal(C, TAPS), normal(4 * C, C, scale=0.05),
                       normal(C, 4 * C, scale=0.05))


def run(inp: StageInputs, tile: int, modes=MODES) -> dict[str, torch.Tensor]:
    """Each mode once: one ``conv_unit_stages`` launch each on the card."""
    return {mode: conv_unit_stages(*inp, tile, mode) for mode in modes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = device(ap.parse_args(argv).device, "bisect_kernel")
    print(f"[{describe(dev)}] conv_unit_stages, bf16", flush=True)
    for B, C, T, S in cases():
        inp = make(B, C, T, dev=dev)
        line = f"B{B} C{C:3d} T{T} S{S}: "
        for mode in MODES:
            ms = time_ms(lambda: run(inp, S, (mode,)), dev, ITERS)
            line += f"{mode}={ms:.3f}ms "
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
