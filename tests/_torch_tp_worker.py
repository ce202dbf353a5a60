"""One gloo rank of the port's tensor-parallel and sharded-training CPU tests.

    python tests/_torch_tp_worker.py RANK WORLD PORT OUT_DIR CASES

Imports torch and the port only. ``CASES`` is a comma list of

- ``codec``: ``debug`` at seed 0 put onto its tp shards
  (``parallel.tp.shard_codec``), ``encode_sp`` / ``decode_sp`` /
  ``decode_indices_sp`` of the rank's (dp rows, sp block) of the audio on
  the meshes (1, 1, 4), (2, 1, 2) and (1, 2, 2);
- ``gather``: ``shard_state_dict`` / ``gather_state_dict`` of ``debug`` at
  tp 4 and 2;
- ``grads``: one sharded step (SGD at lr 0, the waveform loss) on the meshes
  (1, 2, 2), (2, 1, 2) and (2, 2, 1), the rank's gradients and metrics;
- ``noise``: one sharded step on (2, 2, 1) with drop-path and FSQ noise
  from one seed, its loss;
- ``adam``: six sharded Adam steps with the spectral loss on (1, 2, 2), a tone;
- ``trainer``: ``trainer.train`` on (1, 2, 2) uninterrupted and killed at
  step 2 and resumed, and its step-3 checkpoint loaded at tp 4 and whole;
- ``ckpt``: ``save_sharded`` of a tp 2 codec, loaded at tp 4 and whole;
- ``serve``: ``CodecServer`` over two ``debug`` models (seeds 0 and 1),
  mixed encode and decode streams, on one device and with ``mesh=`` dp 2.

Inputs come from fixed seeds here, so the test holds the same. Each rank
writes its results to ``OUT_DIR/rank<RANK>.pt``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from l3ac_tpu_torch import train as tr  # noqa: E402
from l3ac_tpu_torch.models import codec as fc  # noqa: E402
from l3ac_tpu_torch.models.zoo import get_model  # noqa: E402
from l3ac_tpu_torch.parallel import distributed as pd  # noqa: E402
from l3ac_tpu_torch.parallel import mesh as pm  # noqa: E402
from l3ac_tpu_torch.parallel import sharding, tp  # noqa: E402
from l3ac_tpu_torch.runtime import checkpoint  # noqa: E402
from l3ac_tpu_torch.runtime.scheduler import CodecServer  # noqa: E402
from l3ac_tpu_torch.trainer import build_codec, train  # noqa: E402

CODEC_B = 2
CODEC_MESHES = ((1, 1, 4), (2, 1, 2), (1, 2, 2))
GRAD_MESHES = ((1, 2, 2), (2, 1, 2), (2, 2, 1))
TRAIN_B = 2
NOISE_RATE, NOISE_SEED = 0.3, 5
STREAM_SAMPLES = (3000, 5000, 1234, 7000, 800)


def codec_audio(mc) -> np.ndarray:
    T = fc.sp_time_quantum(mc) * 4
    return (np.random.default_rng(7).standard_normal((CODEC_B, T)) * 0.3).astype(np.float32)


def train_audio(mc) -> np.ndarray:
    """A broadband (B, T) clip of two sp quanta."""
    T = fc.sp_time_quantum(mc) * 2
    return (np.random.default_rng(3).standard_normal((TRAIN_B, T)) * 0.3).astype(np.float32)


def streams() -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in STREAM_SAMPLES]


def _block(t: torch.Tensor, mesh, time_dim: int = 1) -> torch.Tensor:
    B, T = t.shape[0], t.shape[time_dim]
    dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    t = t.narrow(0, mesh.coords["dp"] * (B // dp), B // dp)
    return t.narrow(time_dim, mesh.coords["sp"] * (T // n_sp), T // n_sp).contiguous()


def run_codec(mesh) -> dict:
    m = get_model("debug", device="cpu", seed=0)
    tp.shard_codec(m.codec, mesh)
    a = _block(torch.from_numpy(codec_audio(m.mc)), mesh)
    batch_axis = "dp" if mesh.shape["dp"] > 1 else None
    q, idx = fc.encode_sp(m, a, mesh, batch_axis=batch_axis)
    return {"q": q, "idx": idx, "y": fc.decode_sp(m, q, mesh, batch_axis=batch_axis),
            "y_idx": fc.decode_indices_sp(m, idx, mesh, batch_axis=batch_axis),
            "coords": dict(mesh.coords), "shard": m.codec.tp_shard}


def run_gather() -> dict:
    out = {}
    m = get_model("debug", device="cpu", seed=0)
    full = m.codec.state_dict()
    for shape in ((1, 1, 4), (2, 1, 2)):
        mesh = pm.make_mesh(*shape)
        mine = sharding.shard_state_dict(full, m.mc, mesh)
        back = sharding.gather_state_dict(mine, m.mc, mesh)
        out[shape] = {"equal": all(torch.equal(back[k], v) for k, v in full.items()),
                      "split": sum(mine[k].shape != v.shape for k, v in full.items())}
    return out


def run_grads(mesh) -> dict:
    codec = build_codec("debug", "cpu", 0)
    step = tr.make_sharded_train_step(mesh, codec, lr=0.0)
    metrics = step(torch.from_numpy(train_audio(codec.mc)))
    return {"grads": {k: p.grad.clone() for k, p in codec.named_parameters()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "coords": dict(mesh.coords)}


def sine_audio(mc) -> np.ndarray:
    """A learnable target: a 330 Hz tone of two sp quanta (tests/test_parallel.py:256-283)."""
    t = np.arange(TRAIN_B * fc.sp_time_quantum(mc) * 2, dtype=np.float32).reshape(TRAIN_B, -1)
    return (0.4 * np.sin(2 * np.pi * 330 * t / 16000)).astype(np.float32)


def run_noise(mesh) -> float:
    """A sharded step's loss with drop-path and FSQ noise from one seed."""
    from l3ac_tpu_torch.ops.droppath import seeded
    codec = build_codec("debug", "cpu", 0)
    step = tr.make_sharded_train_step(mesh, codec, lr=0.0, drop_path_rate=NOISE_RATE)
    return float(step(torch.from_numpy(train_audio(codec.mc)), seeded(NOISE_SEED, "cpu"))["loss"])


def run_adam(mesh) -> list[float]:
    codec = build_codec("debug", "cpu", 0)
    tp.shard_codec(codec, mesh)
    opt = torch.optim.Adam(codec.parameters(), lr=3e-4)
    step = tr.make_sharded_train_step(mesh, codec, optimizer=opt, spectral=True)
    audio = torch.from_numpy(sine_audio(codec.mc))
    return [float(step(audio)["loss"]) for _ in range(6)]


def run_trainer(mesh, out: Path) -> dict:
    dp, n_sp, n_tp = (mesh.shape[a] for a in ("dp", "sp", "tp"))
    hop_tokens = fc.sp_time_quantum(get_model("debug", device="cpu").mc) * n_sp // 24
    kw = dict(steps=3, batch=2, tokens=hop_tokens, device="cpu", log=lambda *a: None,
              spectral=True, dp=dp, sp=n_sp, tp=n_tp, drop_path_rate=0.1)
    ck = out / "trainer_ckpt"
    full = train("debug", **kw)
    train("debug", ckpt_dir=str(ck), save_every=2, **{**kw, "steps": 2})
    resumed = train("debug", ckpt_dir=str(ck), save_every=2, resume=True, **kw)
    res = {"params_equal": all(torch.equal(a, b) for a, b in zip(
               full["codec"].parameters(), resumed["codec"].parameters())),
           "moments_equal": all(
               torch.equal(full["optimizer"].state[a][k], resumed["optimizer"].state[b][k])
               for a, b in zip(full["codec"].parameters(), resumed["codec"].parameters())
               for k in ("exp_avg", "exp_avg_sq")),
           "step": resumed["step"], "loss": resumed["metrics"]["loss"],
           "dirs": sorted(p.name for p in ck.iterdir())}
    whole = sharding.gather_state_dict(dict(resumed["codec"].named_parameters()),
                                       resumed["codec"].mc, mesh)
    res["whole"] = {k: v.detach().clone() for k, v in whole.items()}
    res["loaded_whole"] = checkpoint.load_sharded(ck / "step_00000003")
    # the CLI's mesh flags in the same world (initialize is then a no-op)
    from l3ac_tpu_torch.__main__ import main as cli
    res["cli"] = cli(["train", "--config", "debug", "--steps", "1", "--batch", "2", "--tokens",
                      str(hop_tokens), "--device", "cpu", "--dp", str(dp), "--sp", str(n_sp),
                      "--tp", str(n_tp), "--coordinator", "tcp://localhost:1",
                      "--num-processes", str(mesh.size), "--process-id", str(mesh.rank)])
    return res


def run_ckpt(out: Path) -> dict:
    """A tp 2 save (mesh (2, 1, 2)), then loads at tp 4 and whole."""
    codec = get_model("debug", device="cpu", seed=0).codec
    full = {k: v.clone() for k, v in codec.state_dict().items()}
    save_mesh = pm.make_mesh(2, 1, 2)
    tp.shard_codec(codec, save_mesh)
    path = checkpoint.save_sharded(out / "tp2_ckpt", codec.state_dict(), codec.mc, save_mesh,
                                   meta={"note": "tp2"})
    load_mesh = pm.make_mesh(1, 1, 4)
    at4 = checkpoint.load_sharded(path, codec.mc, mesh=load_mesh)
    want4 = sharding.shard_state_dict(full, codec.mc, load_mesh)
    at1 = checkpoint.load_sharded(path)
    return {"at4_equal": all(torch.equal(at4[k], want4[k]) for k in full),
            "at4_keys": set(at4) == set(full),
            "at1_equal": all(torch.equal(at1[k], v) for k, v in full.items()),
            "files": sorted(p.name for p in path.iterdir()),
            "full": full}


def run_serve(mesh) -> dict:
    models = {"a": get_model("debug", device="cpu", seed=0),
              "b": get_model("debug", device="cpu", seed=1)}
    aud = streams()

    def run(server):
        hs = [server.submit("a" if i % 2 else "b", a) for i, a in enumerate(aud)]
        server.drain()
        toks = [server.tokens(h) for h in hs]
        ds = [server.submit_decode("a" if i % 2 else "b", indices=t, length=len(aud[i]))
              for i, t in enumerate(toks)]
        with torch.no_grad():
            f0 = models["b"].codec.quantizer.indices_to_features(
                torch.from_numpy(toks[0][None]), torch.float32)[0].numpy()
        feats = [server.submit_decode("b", features=f0, length=len(aud[0]))]
        server.drain()
        blob = server.save_state()
        return toks, [server.audio(h) for h in ds + feats], blob

    single = run(CodecServer(models, chunk_seconds=0.1, batch_size=2))
    dp = run(CodecServer(models, chunk_seconds=0.1, batch_size=2, mesh=mesh))
    restored = CodecServer(models, chunk_seconds=0.1, batch_size=2, mesh=mesh)
    restored.restore_state(dp[2])
    return {"single": single[:2], "dp": dp[:2], "rows_per_step": restored.rows_per_step,
            "restored_tokens": [restored.tokens(h) for h in range(len(STREAM_SAMPLES))]}


def main() -> int:
    rank, world, port, out, cases = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                     Path(sys.argv[4]), sys.argv[5].split(","))
    torch.set_num_threads(1)
    pd.initialize(f"tcp://localhost:{port}", world, rank, backend="gloo")
    res = {}
    if "codec" in cases:
        res["codec"] = {s: run_codec(pm.make_mesh(*s)) for s in CODEC_MESHES}
    if "gather" in cases:
        res["gather"] = run_gather()
    if "grads" in cases:
        res["grads"] = {s: run_grads(pm.make_mesh(*s)) for s in GRAD_MESHES}
    if "noise" in cases:
        res["noise"] = run_noise(pm.make_mesh(2, 2, 1))
    if "adam" in cases:
        res["adam"] = run_adam(pm.make_mesh(1, 2, 2))
    if "trainer" in cases:
        res["trainer"] = run_trainer(pm.make_mesh(1, 2, 2), out)
    if "ckpt" in cases:
        res["ckpt"] = run_ckpt(out)
    if "serve" in cases:
        res["serve"] = run_serve(pm.make_mesh(2, 2, 1))
    torch.save(res, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
