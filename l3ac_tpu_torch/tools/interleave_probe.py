"""Lane and sublane interleaved stores, ``out[..., t s + p] = x[..., t]``:
the counterpart of the TPU probe ``tools/test_interleave.py``.

    python3 -m l3ac_tpu_torch.tools.interleave_probe [--device cpu]

Makes a seeded bf16 x of the probe's shape (8, 24, 79920), and with s = 2
runs the ``interleave`` kernel in the probe's four strategies: A and B on
(B, C, T) -> (B, C, T s), C and D on its transpose (B, T, C) -> (B, T s, C);
A and D with strided stores, B and C with packed ones. Prints one line per
strategy as the probe does: OK when the output is bit-equal to
``interleave_plain``, and the time per call (CUDA events on the card). The
whole length is written; the probe leaves the columns past its last whole
tile of 3840 unwritten.
"""

from __future__ import annotations

import argparse

import torch

from . import describe, device, time_ms
from ..ops.kernels.interleave import interleave, interleave_plain

SHAPE = (8, 24, 79920)
SCALE = 2
ITERS = 45  # timed calls per strategy
# (tag, channels_last, packed), the probe's tags
STRATEGIES = (("A lane strided store", False, False), ("B lane stack+reshape", False, True),
              ("C subl stack+reshape", True, True), ("D subl strided store", True, False))


def make_input(shape=SHAPE, dev="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=g).bfloat16().to(dev)


def operands(x: torch.Tensor) -> dict[bool, torch.Tensor]:
    """The input of each layout: x as it is, and (B, T, C) for channels_last."""
    return {False: x, True: x.transpose(1, 2).contiguous()}


def run(ops: dict[bool, torch.Tensor], strategies=STRATEGIES) -> dict[str, torch.Tensor]:
    """Each strategy once: one ``interleave`` launch each on the card."""
    return {tag: interleave(ops[cl], SCALE, channels_last=cl, packed=pk)
            for tag, cl, pk in strategies}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = device(ap.parse_args(argv).device, "interleave_probe")
    print(f"[{describe(dev)}] x {SHAPE} bf16, s = {SCALE}", flush=True)
    ops = operands(make_input(SHAPE, dev=dev))
    ok_all = True
    outs = run(ops)
    for strategy in STRATEGIES:
        tag, cl, _ = strategy
        want = interleave_plain(ops[cl], SCALE, channels_last=cl)
        ok = torch.equal(outs[tag].view(torch.int16), want.view(torch.int16))
        ok_all &= ok
        ms = time_ms(lambda: run(ops, (strategy,)), dev, ITERS)
        print(f"{tag}: {'OK ' if ok else 'WRONG'}  {ms:6.3f} ms", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
