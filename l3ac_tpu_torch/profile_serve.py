"""Where the time of a ``CodecServer`` drain goes, on a CUDA card.

    python3 -m l3ac_tpu_torch.profile_serve [--dtype bfloat16] [--runs 3]

Serves a mixed load on the released 1kbps and 3kbps together at full width
and depth (seed-0 weights), chunk 5 s, batch 8, the native framer: 12
encode streams of 1.3-23 s alternately on the two configs (two of them fed
in 0.5 s pieces with a ``step()`` after each, one arriving after the first
``step()``), 6 dec_idx streams and 2 dec_feat streams, then ``drain()``;
163.4 s of audio in all. ``chip_smoke.py`` phase 15 drives the same load
(:func:`serve_load`, :func:`run_serve_load`) and checks its results.

Per run it prints the wall, × realtime, the server's ``stats`` and, per
lane, its calls and the host milliseconds until a call returns. Then one
full-chunk call of the 1kbps encode and dec_idx lanes: when the call
returns and when the device is done. Then the same again with the FSQ level
tables built at every call (``ops.fsq._levels`` uncached, a synchronizing
copy each, as the port built them before they were cached), so that both
stand in one process.
Decode inputs are seeded random indices and features.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

SR = 16000
SERVE_CONFIGS = ("1kbps", "3kbps")
SERVE_CHUNK_SECONDS, SERVE_BATCH = 5, 8
# 12 encode streams, alternately on 1kbps and 3kbps; streams 4 and 9 are fed
# in 0.5 s pieces with a step() after each, stream 11 arrives after the
# first step()
SERVE_ENCODE_SECONDS = (1.3, 2.9, 4.4, 5.0, 6.1, 7.7, 9.5, 10.0, 12.4, 15.2, 19.0, 23.0)
SERVE_INCREMENTAL = (4, 9)
SERVE_LATE = 11
SERVE_DEC_IDX = (0, 1, 2, 3, 4, 5)      # dec_idx streams: the tokens of these encode streams
SERVE_DEC_FEAT = (6, 7)                 # dec_feat streams: the features of these


def serve_load(seed: int = 15) -> list:
    """The encode streams [(config, audio)], drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [(SERVE_CONFIGS[i % 2], (rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32))
            for i, s in enumerate(SERVE_ENCODE_SECONDS)]


def serve_seconds(enc: list) -> float:
    """Seconds of audio the load encodes and decodes."""
    return (sum(len(a) for _, a in enc)
            + sum(len(enc[i][1]) for i in SERVE_DEC_IDX + SERVE_DEC_FEAT)) / SR


def run_serve_load(server, enc: list, dec_tokens: list, features: dict) -> tuple[dict, float]:
    """Submit the whole load (two streams fed piecewise with steps between,
    one arriving after the first step), drain and collect. Returns the
    results by (kind, stream) and the wall seconds."""
    if any(lane.model.device.type == "cuda" for lane in server.lanes.values()):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = {}
    for i, (cfg, a) in enumerate(enc):
        if i in SERVE_INCREMENTAL:
            h["enc", i] = server.submit(cfg)
        elif i != SERVE_LATE:
            h["enc", i] = server.submit(cfg, a)
    for i in SERVE_DEC_IDX:
        h["dec_idx", i] = server.submit_decode(enc[i][0], indices=dec_tokens[i],
                                               length=len(enc[i][1]))
    for i in SERVE_DEC_FEAT:
        h["dec_feat", i] = server.submit_decode(enc[i][0], features=features[i])
    server.step()
    h["enc", SERVE_LATE] = server.submit(*enc[SERVE_LATE])
    piece = SR // 2
    for ofs in range(0, max(len(enc[i][1]) for i in SERVE_INCREMENTAL), piece):
        for i in SERVE_INCREMENTAL:
            if ofs < len(enc[i][1]):
                server.feed(h["enc", i], enc[i][1][ofs:ofs + piece])
        server.step()
    for i in SERVE_INCREMENTAL:
        server.finish(h["enc", i])
    server.drain()
    out = {k: server.tokens(v) if k[0] == "enc" else server.audio(v) for k, v in h.items()}
    return out, time.perf_counter() - t0


def timed_lanes(server) -> dict:
    """Wrap each lane's call to count it and sum the host seconds until it
    returns; returns {lane key: [calls, seconds]}, updated in place."""
    calls = {key: [0, 0.0] for key in server.lanes}
    for key, lane in server.lanes.items():
        def call(x, _run=lane.run, _key=key):
            t0 = time.perf_counter()
            out = _run(x)
            calls[_key][0] += 1
            calls[_key][1] += time.perf_counter() - t0
            return out
        lane.run = call
    return calls


def random_decode_inputs(models: dict, enc: list, seed: int = 16) -> tuple[list, dict]:
    """Seeded indices for every stream and features for the dec_feat ones,
    as many tokens as each stream's audio gives."""
    rng = np.random.default_rng(seed)
    tokens, features = [], {}
    for i, (cfg, a) in enumerate(enc):
        mc = models[cfg].mc
        n = -(-len(a) // mc.hop_length)
        tokens.append(rng.integers(0, mc.vq.codebook_size, n).astype(np.int32))
        if i in SERVE_DEC_FEAT:
            features[i] = (rng.standard_normal((n, mc.feature_dim)) * 0.3).astype(np.float32)
    return tokens, features


def profile(models: dict, runs: int, tag: str) -> None:
    from .runtime.scheduler import CodecServer
    enc = serve_load()
    tokens, features = random_decode_inputs(models, enc)
    server = CodecServer(models, chunk_seconds=SERVE_CHUNK_SECONDS, batch_size=SERVE_BATCH,
                         use_native=True)
    calls = timed_lanes(server)
    seconds = serve_seconds(enc)
    for run in range(runs):
        for c in calls.values():
            c[:] = [0, 0.0]
        server.stats.update({k: type(v)(0) for k, v in server.stats.items()})
        _, wall = run_serve_load(server, enc, tokens, features)
        st = server.stats
        print(f"{tag} run {run}: wall {wall * 1e3:.3f} ms, {seconds / wall:.1f}x realtime; "
              + ", ".join(f"{k} {st[k] * 1e3:.3f} ms" for k in st if k.startswith("t_"))
              + f", programs {st['programs']}, fetches {st['fetches']}; lanes (calls, host ms a call) "
              + str({k: (n, round(s * 1e3 / n, 3)) for k, (n, s) in calls.items() if n}), flush=True)
    for key in ("1kbps:enc", "1kbps:dec_idx"):
        lane = server.lanes[key]
        dev = lane.model.device
        if lane.kind == "enc":
            x = torch.zeros(SERVE_BATCH, lane.framer.chunk_len + lane.hop, device=dev)
        else:
            x = torch.from_numpy(np.resize(tokens[0], (SERVE_BATCH, lane.framer.chunk_len + 1))).to(dev)
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lane.run(x)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if best is None or t2 - t0 < best[1]:
                best = (t1 - t0, t2 - t0)
        print(f"{tag} one {key} call {tuple(x.shape)}: returns after {best[0] * 1e3:.3f} ms, "
              f"done after {best[1] * 1e3:.3f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available")
    from .models.zoo import get_model
    from .ops import fsq
    from .ops.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.library()
    dtype = getattr(torch, args.dtype)
    models = {c: get_model(c, device="cuda", seed=0, dtype=dtype) for c in SERVE_CONFIGS}
    profile(models, args.runs, f"{args.dtype}, FSQ tables cached")
    cached = fsq._levels
    fsq._levels = cached.__wrapped__
    try:
        profile(models, args.runs, f"{args.dtype}, FSQ tables per call")
    finally:
        fsq._levels = cached
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
