"""How far a tensor-parallel bf16 encode moves from the single-device one.

    python3 -m l3ac_tpu_torch.tools.tp_bf16_agreement [--device cpu] [--seeds 18 19]
        [--exact-bf16-gemm] [--model 1kbps] [--seconds 3]

For each seed: B = 2 clips of seeded noise (``chip_smoke.py`` phase 18's
input at seed 18), a bf16 model of random weights from seed 0, its
single-device ``Codec.encode`` and its tp = 2 ``encode_sp`` on two gloo ranks
(both on the one card, or on the CPU with ``--device cpu``, where every
wrapper runs its plain version). The two runs round at the same points; the
tensor-parallel one sums each split pair's shares in another fp32 order. The
tool prints, per seed:

- the FSQ indices that differ;
- the FSQ input z (bf16): its relative L2 between the two runs, the share of
  its elements that differ and the largest difference in bf16 steps (of
  each element, or of z's RMS where the element is smaller: a z near 0 is
  a sum that cancelled, whose error scales with its terms);
- for each differing index, how far the single-device run's pre-round
  value lay from the level the other run gave (from the rounding boundary
  next to that level), in the pre-round steps that one bf16 step of z makes
  there: a flip by roundoff lies within a few such steps, one by a fault
  need not;
- on the card, the same figures for the CPU's single-device bf16 encode of
  the same input against the card's (the class of difference that
  ``chip_smoke.py``'s card-vs-CPU bf16 floor covers).

``--exact-bf16-gemm`` turns off cuBLAS's reduced-precision split-K sums of
bf16 products (``allow_bf16_reduced_precision_reduction``) in every process.
"""

from __future__ import annotations

import argparse
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import describe, device

SR = 16000
RANKS = 2


def make_audio(seed: int, T: int, B: int = 2) -> torch.Tensor:
    """``chip_smoke.py`` phase 18's clips: seeded standard normal noise x 0.1."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((B, T)) * 0.1).astype(np.float32))


def encode_z(codec, call):
    """(indices, z): ``call()``'s FSQ indices and the bf16 FSQ input z that
    produced them (the quantizer's input, projected)."""
    got = {}
    hook = codec.quantizer.register_forward_pre_hook(lambda m, a: got.setdefault("x", a[0]))
    try:
        _, idx = call()
    finally:
        hook.remove()
    with torch.inference_mode():
        return idx.cpu(), codec.quantizer.project_in(got["x"]).cpu()


def bf16_step(z: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each element of z (its last-place
    unit), at least that at z's RMS."""
    z = z.float()
    a = z.abs().clamp_min(z.pow(2).mean().sqrt().item())
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(idx, z, idx_ref, z_ref, levels: tuple[int, ...]) -> dict:
    """The figures of the module docstring for (idx, z) against the
    reference run (idx_ref, z_ref)."""
    from ..ops import fsq
    zf, rf = z.float(), z_ref.float()
    step = bf16_step(z_ref)
    flips = (idx != idx_ref).nonzero().tolist()
    pre = fsq.pre_round(z_ref, levels)
    lv = torch.tensor(levels, dtype=torch.float32)
    # the pre-round change one bf16 step of z makes: d/dz of (tanh z + 1) / 2 (L - 1)
    slope = (1.0 - torch.tanh(rf) ** 2) / 2.0 * (lv - 1.0) * step
    margins = []
    for b, t in flips:
        li = fsq.quantize(z[b, t], levels)[2].float()
        li_ref = fsq.quantize(z_ref[b, t], levels)[2].float()
        edge = li - 0.5 * torch.sign(li - li_ref)  # the boundary next to the new level
        gap = (pre[b, t] - edge).abs() / slope[b, t]
        margins.append(float(gap[li != li_ref].max()))
    return {"indices": idx.numel(), "flips": len(flips),
            "z_rel_l2": float((zf - rf).norm() / rf.norm()),
            "z_differ": float((zf != rf).float().mean()),
            "z_max_steps": float(((zf - rf).abs() / step).max()),
            "flip_margin_steps": max(margins, default=0.0)}


def _rank(rank: int, port: int, dev_name: str, exact: bool, model: str, seeds, T: int,
          out: str) -> None:
    from ..models import codec as fc
    from ..models.zoo import get_model
    from ..parallel import distributed as pd, mesh as pm, tp
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = not exact
    torch.set_num_threads(max(1, torch.get_num_threads() // RANKS))
    dev = torch.device(dev_name)
    pd.initialize(f"tcp://localhost:{port}", RANKS, rank, backend="gloo")
    mesh = pm.make_mesh(1, 1, RANKS)
    m = get_model(model, device=dev, seed=0, dtype=torch.bfloat16)
    tp.shard_codec(m.codec, mesh)
    res = {}
    for seed in seeds:
        audio = make_audio(seed, T).to(dev, torch.bfloat16)
        res[seed] = encode_z(m.codec, lambda: fc.encode_sp(m, audio, mesh))
    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def run(dev: torch.device, seeds, exact: bool = False, model: str = "1kbps",
        seconds: float = 3.0) -> dict:
    """{seed: {"tp": compare(...), and on the card "cpu": compare(...)}}."""
    import torch.multiprocessing as mp
    from ..models.zoo import get_model
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = not exact
    m = get_model(model, device=dev, seed=0, dtype=torch.bfloat16)
    mc, levels = m.codec.mc, tuple(m.codec.quantizer.levels)
    T = int(seconds * SR) // mc.hop_length * mc.hop_length
    single = {}
    with torch.inference_mode():
        for seed in seeds:
            audio = make_audio(seed, T).to(dev, torch.bfloat16)
            single[seed] = encode_z(m.codec, lambda: m.codec.encode(audio))
        cpu = None
        if dev.type == "cuda":
            mcpu = get_model(model, device="cpu", seed=0, dtype=torch.bfloat16)
            cpu = {s: encode_z(mcpu.codec, lambda: mcpu.codec.encode(
                make_audio(s, T).bfloat16())) for s in seeds}
    del m
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="tp_bf16_") as tmp:
        mp.spawn(_rank, args=(port, str(dev), exact, model, list(seeds), T, tmp),
                 nprocs=RANKS, join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(RANKS)]
    out = {}
    for seed in seeds:
        idx, z = single[seed]
        if not all(torch.equal(r[seed][0], ranks[0][seed][0]) for r in ranks):
            raise AssertionError(f"seed {seed}: the tp ranks' indices differ")
        out[seed] = {"tp": compare(*ranks[0][seed], idx, z, levels)}
        if cpu is not None:
            out[seed]["cpu"] = compare(*cpu[seed], idx, z, levels)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[18, 19])
    ap.add_argument("--exact-bf16-gemm", action="store_true")
    ap.add_argument("--model", default="1kbps")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    dev = device(a.device, "tp_bf16_agreement")
    res = run(dev, a.seeds, a.exact_bf16_gemm, a.model, a.seconds)
    where = describe(dev)
    for seed, r in res.items():
        for what, c in r.items():
            label = ("tp 2 vs single-device" if what == "tp" else
                     "CPU single-device vs card single-device")
            print(f"seed {seed} {a.model} bf16 {label}: {c['flips']} of {c['indices']} "
                  f"indices differ ({1 - c['flips'] / c['indices']:.6f} equal); z relative L2 "
                  f"{c['z_rel_l2']:.3e}, {c['z_differ']:.4f} of z differs, at most "
                  f"{c['z_max_steps']:.0f} bf16 steps; flips within "
                  f"{c['flip_margin_steps']:.2f} steps of a boundary "
                  f"(exact bf16 gemm: {a.exact_bf16_gemm}) [{where}]", flush=True)


if __name__ == "__main__":
    main()
