"""The attention kernel (``csrc/local_attention.cu``) beside its measured
alternatives and ablations, at the two window shapes of one 1kbps 8 x 10 s
request, q / k / v as the model's strided head views and the bias as its
table.

    python3 -m l3ac_tpu_torch.tools.attention_variants [--bf16 [--c4] [--sass DIR]]

``--bf16`` times the bf16 kernels instead, on bf16 q / k / v and a bf16
table, held against the bf16 plain version within 2^-6 x max(1, max
|plain|): the kernel the port runs with its ablations, and the PR 12 kernel
(``tools/attention_bf16_mma.cu``, built only here) with its own. Then the
head dims 48 and 64 (``C4_VARIANTS``: the 64-column instantiation and its
alternatives, beside the 128-column one) at n = 16, 64, 250 and 750 with
the table, the full bias and no bias, on both routes, each case held
against the bf16 plain version; a case out of tolerance is printed with
the rows it got wrong, not raised. ``--c4`` runs that part alone;
``--sass DIR`` writes each C4 variant's SASS (``cuobjdump``) of its
instantiations at D = 64 and ptxas's warnings into DIR.

Card only. Each variant is the kernel's source with named text
substitutions (each must apply exactly once), built with the kernel
library's nvcc flags into its own library, called on the same seeded inputs
and timed with CUDA events. Variants that compute the attention are held
against the plain version (max abs error <= 1e-4 x max(1, max |plain|));
ablations drop a part of the work, are only timed, and say where the time
goes. Prints ptxas's registers and spills of each variant at D = 32 with the
table, its ms per shape and the sum per request (encode, decode). Variant 0
is what the port runs.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from . import build_variants, describe, ptxas_usage, time_ms
from ..ops.attention import expand_position_table
from ..ops.kernels import _build
from ..ops.kernels import local_attention as la

SOURCE = _build.CSRC_DIR / "local_attention.cu"
B, H, D = 8, 6, 32
# (n, T, launches per 8 x 10 s request (encode, decode)): chip_smoke.py phase 3
SHAPES = ((750, 2250, (1, 2)), (250, 750, (2, 3)))
TOL = 1e-4
TOL_BF16 = 2.0 ** -6
ITERS = 20
# the entry point of tools/attention_bf16_mma.cu: q, k, v, bias, table, out;
# B, H, T, n, D; the nine strides; scale; stream (the port's kernels also take
# kp, prev_k, prev_v, left_edge and kp's strides: _port_args below)
_ARGTYPES_MMA = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9 +
                  [ctypes.c_float, ctypes.c_void_p])


def _port_args(q, k, v, bias, table, out, B, H, T, n, D, strides):
    """The port kernels' arguments up to the scale, without the
    previous-window operands."""
    return (q, k, v, None, None, None, bias, table, out, B, H, T, n, D, 0, *strides, 0, 0, 0)

# (name, substitutions, computes the attention)
VARIANTS = (
    ("4 warps x 16 query rows, 64-key tiles, 2-stage ring", (), True),
    ("3-stage ring", (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),), True),
    ("8 warps x 16 query rows (128-query blocks)",
     (("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),), True),
    ("ablation: no exp in the softmax",
     (("const float p = expf(s[nt][e] - (e < 2 ? mu_a : mu_b));",
       "const float p = s[nt][e] - (e < 2 ? mu_a : mu_b);"),), False),
    ("ablation: one TF32 pass per product step (hi . hi)",
     (("  ptx::mma_tf32(d, al, bh);\n  ptx::mma_tf32(d, ah, bl);\n", ""),), False),
    ("ablation: no P V", (("for (int half = 0; half < 2; ++half) {",
                           "for (int half = 0; half < 0; ++half) {"),), False),
)


# the bf16 kernel the port runs (csrc/local_attention_bf16.cu, the TMA route),
# its alternatives and ablations
SOURCE_BF16 = _build.CSRC_DIR / "local_attention_bf16.cu"
_NO_TILE_BF16 = (("  return (p.n + it.i0 + rows - key_begin(p, it) + kKeys - 1) / kKeys;",
                  "  return 0 * rows;"),)
VARIANTS_BF16 = (
    ("TMA + wgmma, 2 consumer warpgroups on 128-row items, 4-stage ring, ex2 softmax", (), True),
    ("1 consumer warpgroup (64-row items)",
     (("constexpr int kConsumers = 2;", "constexpr int kConsumers = 1;"),), True),
    ("2-stage ring", (("kStages = kD16 <= 2 ? 4 : 3;", "kStages = 2;"),), True),
    ("ablation: no exp (p = x - m)",
     (("const float p0 = ptx::ex2(sc[4 * j] - mu_a), p1 = ptx::ex2(sc[4 * j + 1] - mu_a);",
       "const float p0 = sc[4 * j] - mu_a, p1 = sc[4 * j + 1] - mu_a;"),
      ("const float p2 = ptx::ex2(sc[4 * j + 2] - mu_b), p3 = ptx::ex2(sc[4 * j + 3] - mu_b);",
       "const float p2 = sc[4 * j + 2] - mu_b, p3 = sc[4 * j + 3] - mu_b;")), False),
    ("ablation: no mask and no bias",
     (("const bool diag = j0 + kKeys - 1 > n + i0w;", "const bool diag = false;"),
      ("sc[4 * j + e] = fmaf(sc[4 * j + e], kLog2e, tv[2 + 2 * j + e]);",
       "sc[4 * j + e] *= kLog2e;"),
      ("sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], kLog2e, tv[2 * j + e]);",
       "sc[4 * j + 2 + e] *= kLog2e;")), False),
    ("ablation: P V on one k16 step of four (its other products dropped)",
     (("for (int kk = 0; kk < 4; ++kk)\n#pragma unroll\n          for (int hf",
       "for (int kk = 0; kk < 1; ++kk)\n#pragma unroll\n          for (int hf"),), False),
    ("ablation: K / V loads only (no products, no softmax)",
     (("if (i0w < n && j0 <= n + r_hi) {", "if (false) {"),), False),
    ("ablation: no key tile (the prologue and the store alone)", _NO_TILE_BF16, False),
)

# the PR 12 bf16 kernel (one mma.sync m16n8k16 pass, 2-stage cp.async ring)
# and the ablations that say where its time went
SOURCE_PR12 = Path(__file__).with_name("attention_bf16_mma.cu")
VARIANTS_PR12 = (
    ("PR 12 kernel: 4 warps x 16 query rows, mma.sync m16n8k16, 2-stage cp.async ring", (), True),
    ("PR 12, ablation: no exp (p = s - m)",
     (("const float pe = expf(s[nt][e] - (e < 2 ? mu_a : mu_b));",
       "const float pe = s[nt][e] - (e < 2 ? mu_a : mu_b);"),), False),
    ("PR 12, ablation: no mask and no bias",
     (("const bool ok = i < n && j <= n + i;", "const bool ok = true;"),
      ("if (kBias == kTableBias) x += ok ? tab[n + i - j] : 0.0f;", "")), False),
    ("PR 12, ablation: no P V",
     (("for (int kk = 0; kk < 4; ++kk) {\n      const uint32_t pf[4]",
       "for (int kk = 0; kk < 0; ++kk) {\n      const uint32_t pf[4]"),), False),
    ("PR 12, ablation: K / V loads only (no products, no softmax)",
     (("if (!warp_live || j0 > n + i_last) continue;", "continue;"),), False),
    ("PR 12, ablation: no key tile (the prologue and the store alone)",
     (("const int ntiles = (j_end - j_begin + kKeys - 1) / kKeys;", "const int ntiles = 0;"),),
     False),
)


# head dims 33-64 (C4): the 64-column instantiation (kD16 = 4: one half of
# 128-byte rows) as the port builds it, its Q fragments loaded per key tile;
# the same with Q held in registers across the item, as it was first written (ptxas
# gives P's fragments Q's registers, and the unmasked branch reads the next
# tile's S from P: wrong), and two changes with which that allocation did not
# happen; the 128-column instantiation, zero-padded (the earlier route)
_Q_ONCE = (("static constexpr bool kQPerTile = kD16 == 4;",
            "static constexpr bool kQPerTile = false;"),)
C4_VARIANTS = (
    ("64 columns (kD16 = 4), Q fragments loaded per key tile", ()),
    ("64 columns, Q fragments held across the item (as first written)", _Q_ONCE),
    ("64 columns, Q held, every key tile through the masked branch",
     _Q_ONCE + (("const bool diag = j0 + kKeys - 1 > n + i0w;", "const bool diag = true;"),)),
    ("64 columns, Q held, as two halves of 64-byte rows (kSpan 32)",
     _Q_ONCE + (("static constexpr int kSpan = kDp < 64 ? kDp : 64;",
                 "static constexpr int kSpan = kDp < 64 ? kDp : kDp == 64 ? 32 : 64;"),
                ("const int d = hf * 64 + 8 * j + 2 * t4;",
                 "const int d = hf * G::kSpan + 8 * j + 2 * t4;"))),
    ("128 columns, zero-padded (the earlier route)",
     (("  return d16 <= 4 ? launch_route<4>(p, B, route, s) : launch_route<8>(p, B, route, s);",
       "  return launch_route<8>(p, B, route, s);"),)),
)
C4_NS, C4_DS = (16, 64, 250, 750), (48, 64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 kernels and their ablations")
    ap.add_argument("--c4", action="store_true", help="with --bf16: the head dims 48-64 alone")
    ap.add_argument("--sass", type=Path, default=None,
                    help="with --bf16: write the C4 variants' SASS and ptxas warnings here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: CUDA is not available (it times kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.bf16:
        if not args.c4:
            main_bf16(dev)
        return main_c4(dev, args.sass)
    libs = build_variants("attention_variants", SOURCE, [subs for _, subs, _ in VARIANTS],
                          "l3ac_local_attention", la._ARGTYPES)
    print(f"[{describe(dev)}] local_attention variants, ms per call (max abs error)", flush=True)
    for i, ((name, _, _), (_, log)) in enumerate(zip(VARIANTS, libs)):
        print(f"  [{i}] {name}: {ptxas_usage(log, 'attention_kernelILi4ELi2E')}", flush=True)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    sums = [[0.0, 0.0] for _ in VARIANTS]
    for n, T, per in SHAPES:
        qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)).to(dev)
        q, k, v = (c.view(B, T, H, D).permute(0, 2, 1, 3) for c in qkv.chunk(3, dim=-1))
        table = torch.from_numpy(rng.standard_normal((2 * n, H)).astype(np.float32)).to(dev)
        want = la.local_attention_plain(q, k, v, window_size=n, bias=expand_position_table(table))
        out = torch.empty(B, T, H, D, device=dev)
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        line = f"n={n} T={T}:"
        for i, ((name, _, exact), (lib, _)) in enumerate(zip(VARIANTS, libs)):
            def call(lib=lib):
                err = lib.l3ac_local_attention(
                    *_port_args(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, table.data_ptr(),
                                out.data_ptr(), B, H, T, n, D, strides), D ** -0.5, stream)
                if err:
                    raise RuntimeError(f"attention_variants [{i}]: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (out.permute(0, 2, 1, 3) - want).abs().max().item()
            if exact and not err <= TOL * max(1.0, want.abs().max().item()):
                raise AssertionError(f"attention_variants [{i}] n={n}: max abs error {err}")
            ms = time_ms(call, dev, ITERS)
            sums[i][0] += per[0] * ms
            sums[i][1] += per[1] * ms
            line += f" [{i}] {ms:.4f}" + (f" ({err:.1e})" if exact else "")
        print(line, flush=True)
    print("summed per 8 x 10 s request (encode, decode):")
    for i, (name, _, _) in enumerate(VARIANTS):
        print(f"  [{i}] {sums[i][0]:.3f} / {sums[i][1]:.3f} ms  {name}")
    return 0


def main_bf16(dev: torch.device) -> int:
    """The bf16 kernels and their ablations at the same shapes, bf16 inputs."""
    # (source, variants, C symbol, its argtypes, route code (None: the PR 12
    # kernel's signature), ptxas entry at D = 32 with the table)
    groups = [(SOURCE_BF16, VARIANTS_BF16, "l3ac_local_attention_bf16", la._ARGTYPES_BF16,
               la.ROUTE_CODE["tma"], "attention_bf16_kernelILi2ELi2ELi0E"),
              (SOURCE_PR12, VARIANTS_PR12, "l3ac_local_attention_bf16", _ARGTYPES_MMA, None,
               "attention_bf16_kernelILi2ELi2EEE")]
    names, libs = [], []
    for source, variants, symbol, argtypes, route, entry in groups:
        built = build_variants(f"attention_variants_{source.stem}", source,
                               [subs for _, subs, _ in variants], symbol, argtypes)
        names += [(name, exact, route) for name, _, exact in variants]
        libs += [(getattr(lib, symbol), ptxas_usage(log, entry)) for lib, log in built]
    print(f"[{describe(dev)}] bf16 local_attention variants, ms per call (max abs error)",
          flush=True)
    for i, ((name, _, _), (_, usage)) in enumerate(zip(names, libs)):
        print(f"  [{i}] {name}: {usage}", flush=True)
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    scale = float(torch.tensor(D ** -0.5, dtype=bf))
    sums = [[0.0, 0.0] for _ in names]
    for n, T, per in SHAPES:
        qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)).to(dev)
        q, k, v = (c.view(B, T, H, D).permute(0, 2, 1, 3) for c in qkv.to(bf).chunk(3, dim=-1))
        table = torch.from_numpy(rng.standard_normal((2 * n, H)).astype(np.float32)).to(dev).to(bf)
        prepared = la.prepare_table(table)
        want = la.local_attention_plain(q, k, v, window_size=n, bias_table=table).float()
        out = torch.empty(B, T, H, D, device=dev, dtype=bf)
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        line = f"n={n} T={T}:"
        for i, ((name, exact, route), (fn, _)) in enumerate(zip(names, libs)):
            extra = () if route is None else (route,)
            tab = table if route is None else prepared  # the PR 12 kernel reads the bf16 table

            def call(fn=fn, extra=extra, tab=tab):
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, tab.data_ptr(),
                        out.data_ptr(), B, H, T, n, D, strides)
                err = fn(*(_port_args(*args) if extra else args[:-1] + tuple(strides)), scale,
                         *extra, stream)
                if err:
                    raise RuntimeError(f"attention_variants bf16 [{i}]: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            err = (out.permute(0, 2, 1, 3).float() - want).abs().max().item()
            if exact and not err <= TOL_BF16 * max(1.0, want.abs().max().item()):
                raise AssertionError(f"attention_variants bf16 [{i}] n={n}: max abs error {err}")
            ms = time_ms(call, dev, ITERS)
            sums[i][0] += per[0] * ms
            sums[i][1] += per[1] * ms
            line += f" [{i}] {ms:.4f}" + (f" ({err:.1e})" if exact else "")
            print(f"  n={n} [{i}] {ms:.4f} ms", flush=True)  # a fault names its variant
        print(line, flush=True)
    print("summed per 8 x 10 s request (encode, decode):")
    for i, (name, _, _) in enumerate(names):
        print(f"  [{i}] {sums[i][0]:.3f} / {sums[i][1]:.3f} ms  {name}")
    return 0


def main_c4(dev: torch.device, sass_dir: Path | None) -> int:
    """The bf16 kernel at head dims 48 and 64 on the C4 variants: every case
    held against the bf16 plain version, the wrong rows of a failing case
    printed; then each variant that held timed at D = 64 at the request's
    two window shapes (H = 4: feature_dim 256). Returns 0 (a wrong variant is
    a finding, not a fault of the tool)."""
    import subprocess
    built = build_variants("attention_variants_c4", SOURCE_BF16,
                           [subs for _, subs in C4_VARIANTS], "l3ac_local_attention_bf16",
                           la._ARGTYPES_BF16)
    print(f"[{describe(dev)}] bf16 local_attention at D = 48 / 64 (C4)", flush=True)
    for i, ((name, _), (lib, log)) in enumerate(zip(C4_VARIANTS, built)):
        warn = sorted({ln.strip() for ln in log.splitlines() if "warn" in ln.lower()})
        print(f"  [{i}] {name}: kD16 = 4 {ptxas_usage(log, 'attention_bf16_kernelILi4ELi2ELi0E')}, "
              f"kD16 = 8 {ptxas_usage(log, 'attention_bf16_kernelILi8ELi2ELi0E')}; "
              f"{len(warn)} ptxas warnings", flush=True)
        for ln in warn:
            print(f"      {ln}", flush=True)
        if sass_dir is not None:
            sass_dir.mkdir(parents=True, exist_ok=True)
            (sass_dir / f"c4_v{i}_ptxas.txt").write_text(log)
            dump = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                                   lib._name], capture_output=True, text=True).stdout
            # the table-bias TMA instantiations at 64 and 128 columns
            keep = [f for f in dump.split("Function : ")[1:]
                    if "ILi4ELi2ELi0E" in f.split("\n")[0] or "ILi8ELi2ELi0E" in f.split("\n")[0]]
            (sass_dir / f"c4_v{i}.sass").write_text("".join("Function : " + f for f in keep))
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    Bc, Hc = 2, 3
    bad_variants = set()
    for n in C4_NS:
        T = 3 * n
        for D in C4_DS:
            scale = float(torch.tensor(D ** -0.5, dtype=bf))
            qkv = torch.from_numpy(rng.standard_normal((Bc, T, 3 * Hc * D)).astype(np.float32))
            q, k, v = (c.view(Bc, T, Hc, D).permute(0, 2, 1, 3)
                       for c in qkv.to(dev).to(bf).chunk(3, dim=-1))
            table = torch.from_numpy(rng.standard_normal((2 * n, Hc)).astype(np.float32)).to(dev).to(bf)
            full = torch.from_numpy(rng.standard_normal((Hc, n, 2 * n)).astype(np.float32)).to(dev).to(bf)
            strides = [s for t in (q, k, v) for s in t.stride()[:3]]
            for kind in ("table", "full", "none"):
                kw = {"table": {"bias_table": table}, "full": {"bias": full}, "none": {}}[kind]
                want = la.local_attention_plain(q, k, v, window_size=n, **kw).float()
                tol = TOL_BF16 * max(1.0, want.abs().max().item())
                tab = la.prepare_table(table) if kind == "table" else None
                bias = full if kind == "full" else None
                for route in ("tma", "cp_async"):
                    line = f"  n={n} D={D} {kind:5s} {route:8s}:"
                    for i, (lib, _) in enumerate(built):
                        out = torch.full((Bc, T, Hc, D), float("nan"), device=dev, dtype=bf)
                        err = lib.l3ac_local_attention_bf16(
                            *_port_args(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        None if bias is None else bias.data_ptr(),
                                        None if tab is None else tab.data_ptr(), out.data_ptr(),
                                        Bc, Hc, T, n, D, strides),
                            scale, la.ROUTE_CODE[route], stream)
                        if err:
                            raise RuntimeError(f"attention_variants c4 [{i}]: CUDA error {err}")
                        torch.cuda.synchronize()
                        diff = (out.permute(0, 2, 1, 3).float() - want).abs()
                        diff = torch.nan_to_num(diff, nan=float("inf"))
                        e = diff.max().item()
                        line += f" [{i}] {e:.1e}" + ("" if e <= tol else "*")
                        if e > tol and i not in bad_variants:
                            bad_variants.add(i)
                            rows = (diff.amax(dim=-1) > tol).nonzero().tolist()  # (b, h, t)
                            cols = (diff.amax(dim=(0, 1, 2)) > tol).nonzero().flatten().tolist()
                            ts = sorted({t for _, _, t in rows})
                            print(f"    [{i}] first failure (n={n}, D={D}, {kind}, {route}): "
                                  f"{len(rows)} of {Bc * Hc * T} rows wrong; times (w, i) "
                                  f"{[(t // n, t % n) for t in ts[:48]]}; by i % 64 // 16 "
                                  f"{np.bincount([t % n % 64 // 16 for t in ts], minlength=4).tolist()}"
                                  f"; by i % 8 {np.bincount([t % n % 8 for t in ts], minlength=8).tolist()}"
                                  f"; columns {cols[:8]}...({len(cols)})", flush=True)
                    print(line + f" (tol {tol:.1e})", flush=True)
    print("C4: variants with a case out of tolerance: "
          + (", ".join(f"[{i}] {C4_VARIANTS[i][0]}" for i in sorted(bad_variants)) or "none"),
          flush=True)
    Hc, D = 4, 64
    scale = float(torch.tensor(D ** -0.5, dtype=bf))
    for n, T, per in SHAPES:
        qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * Hc * D)).astype(np.float32))
        q, k, v = (c.view(B, T, Hc, D).permute(0, 2, 1, 3)
                   for c in qkv.to(dev).to(bf).chunk(3, dim=-1))
        tab = la.prepare_table(torch.from_numpy(rng.standard_normal((2 * n, Hc))
                                                .astype(np.float32)).to(dev).to(bf))
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        out = torch.empty(B, T, Hc, D, device=dev, dtype=bf)
        line = f"  D={D} H={Hc} n={n} T={T}, ms per call:"
        for i, (lib, _) in enumerate(built):
            if i in bad_variants:
                continue

            def call(lib=lib):
                err = lib.l3ac_local_attention_bf16(
                    *_port_args(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, tab.data_ptr(),
                                out.data_ptr(), B, Hc, T, n, D, strides),
                    scale, la.ROUTE_CODE["tma"], stream)
                if err:
                    raise RuntimeError(f"attention_variants c4 [{i}]: CUDA error {err}")
            line += f" [{i}] {time_ms(call, dev, ITERS):.4f}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
