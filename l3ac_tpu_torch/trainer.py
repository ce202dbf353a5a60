"""The training loop: ``python -m l3ac_tpu_torch train``
(``l3ac_tpu/trainer.py``), on one device.

Joins the train step (``train.make_train_step``), ``torch.optim.Adam`` with
optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8), the spectral losses and
the port's own training checkpoints into one restartable entry point. It runs
on the card unless ``device="cpu"``; the forward goes through the CUDA
kernels there (their backward is the plain versions' gradient,
``ops/kernels/autograd.py``) and through the plain versions on the CPU.

Restartability (JAX's contract, ``l3ac_tpu/trainer.py:9-14``): the data feed
and the per-step generator are pure functions of (seed, step), so a run
killed at step k and resumed from the step-k checkpoint replays exactly the
batches, the drop-path masks and the FSQ noise an uninterrupted run would
have seen, and its parameters and Adam moments match that run bit for bit on
the same device. To that end a run turns TF32 off and cuDNN's
nondeterministic and benchmarked algorithms off for its duration (and
restores them after): the plain backward's convolutions are cuDNN's.

Checkpoint layout (one directory per saved step under ``ckpt_dir``, named as
JAX names them)::

    ckpt_dir/step_00000012/params.npz  # JAX's flat .npz (runtime.checkpoint.save_params)
    ckpt_dir/step_00000012/opt.npz     # Adam: exp_avg/<name>, exp_avg_sq/<name>, step (int)

``params.npz`` loads in ``l3ac_tpu.runtime.checkpoint.load_params`` and in
the port's; ``opt.npz`` is read without JAX (orbax is not on the card). A
directory is written under a temporary name and renamed when complete, so a
run killed while saving leaves no partial ``step_*`` directory. ``latest()``
resolves the newest; ``resume`` restores params, moments and step, and
continues.

Not ported: the (dp, sp, tp) mesh (ROADMAP A11): anything but 1 raises.
"""

from __future__ import annotations

import contextlib
import re
import shutil
import time
from pathlib import Path

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Deterministic data feeds: batch(step) depends only on (seed, step), the
# same numpy arrays as the JAX package's (l3ac_tpu/trainer.py:40-90).
# ---------------------------------------------------------------------------


class SyntheticAudio:
    """Reproducible random audio batches (smoke / bench feed)."""

    def __init__(self, batch: int, samples: int, seed: int = 0):
        self.batch, self.samples, self.seed = batch, samples, seed

    def __call__(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return (rng.standard_normal((self.batch, self.samples)) * 0.3).astype(np.float32)


class WavDirAudio:
    """Deterministic batches of random crops from a directory of mono WAV
    files at the model's rate (the port's stdlib reader, as the CLI's)."""

    def __init__(self, wav_dir: str | Path, batch: int, samples: int, sample_rate: int,
                 seed: int = 0):
        from .utils.audio_io import read_wav
        self.files = sorted(Path(wav_dir).glob("*.wav"))
        if not self.files:
            raise FileNotFoundError(f"no .wav files under {wav_dir}")
        self.clips = [np.asarray(read_wav(f, expect_rate=sample_rate)[0], np.float32)
                      for f in self.files]
        self.batch, self.samples, self.seed = batch, samples, seed

    def __call__(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        out = np.zeros((self.batch, self.samples), np.float32)
        for b in range(self.batch):
            clip = self.clips[rng.integers(len(self.clips))]
            if len(clip) <= self.samples:
                out[b, :len(clip)] = clip
            else:
                start = rng.integers(len(clip) - self.samples + 1)
                out[b] = clip[start:start + self.samples]
        return out


# ---------------------------------------------------------------------------
# Checkpoints: one directory per saved step
# ---------------------------------------------------------------------------

_STEP_RE = re.compile(r"^step_(\d{8})$")


def latest(ckpt_dir: str | Path) -> tuple[int, Path] | None:
    """(step, directory) of the newest checkpoint under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best = None
    for d in ckpt_dir.iterdir():
        m = _STEP_RE.match(d.name)
        if m and d.is_dir():
            k = int(m.group(1))
            if best is None or k > best[0]:
                best = (k, d)
    return best


def _save(ckpt_dir: Path, step: int, codec, optimizer: torch.optim.Optimizer) -> Path:
    from .runtime.checkpoint import save_params
    target = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".{target.name}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    save_params(tmp / "params.npz", codec.state_dict(), codec.mc)
    moments = {}
    for name, p in codec.named_parameters():
        state = optimizer.state.get(p)
        if state:
            moments[f"exp_avg/{name}"] = state["exp_avg"].detach().cpu().numpy()
            moments[f"exp_avg_sq/{name}"] = state["exp_avg_sq"].detach().cpu().numpy()
    np.savez(tmp / "opt.npz", step=np.int64(step), **moments)
    shutil.rmtree(target, ignore_errors=True)
    tmp.rename(target)
    return target


def _restore(path: Path, codec, optimizer: torch.optim.Optimizer) -> int:
    """Load ``path``'s params into ``codec`` and its moments into
    ``optimizer`` (Adam); returns the stored step."""
    from .runtime.checkpoint import load_params
    codec.load_state_dict(load_params(path / "params.npz", codec.mc))
    with np.load(path / "opt.npz") as z:
        step = int(z["step"])
        state = {}
        for i, (name, p) in enumerate(codec.named_parameters()):
            if f"exp_avg/{name}" in z.files:
                state[i] = {"step": torch.tensor(float(step)),
                            "exp_avg": torch.from_numpy(z[f"exp_avg/{name}"]),
                            "exp_avg_sq": torch.from_numpy(z[f"exp_avg_sq/{name}"])}
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)
    return step


@contextlib.contextmanager
def _fp32_deterministic():
    """fp32 products (TF32 off) and deterministic cuDNN for the scope."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
             b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = False, False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``: a pure function of (seed, step), as
    JAX's ``fold_in(PRNGKey(seed + 1), step)``."""
    from .ops.droppath import derive_seed, seeded
    return seeded(derive_seed(seed + 1, step), device)


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def build_codec(config: str, device, seed: int = 0, state_dict: dict | None = None):
    """The codec as the trainer trains it: ``config``'s ``Codec`` on
    ``device`` with the weights ``get_model`` draws from ``seed`` (or
    ``state_dict``), no position-bias caches (the bias MLP trains), built
    outside inference mode."""
    from .config import get_config
    from .models.codec import Codec
    with torch.inference_mode(False):
        codec = Codec(get_config(config).network_config, device=device)
        codec.init_weights(torch.Generator().manual_seed(seed))
        if state_dict is not None:
            codec.load_state_dict(state_dict, strict=True)
    return codec.train()


def train(config: str = "debug", *, steps: int = 20, batch: int = 4,
          seconds: float | None = None, tokens: int = 8,
          dp: int = 1, sp: int = 1, tp: int = 1,
          lr: float = 1e-4, spectral: bool = False,
          drop_path_rate: float = 0.0, seed: int = 0,
          wav_dir: str | None = None, ckpt_dir: str | None = None,
          save_every: int = 0, resume: bool = False,
          log_every: int = 1, log=print, device=None,
          state_dict: dict | None = None) -> dict:
    """Run ``steps`` Adam train steps of ``config`` on one device; returns
    {"codec", "optimizer", "step", "metrics"} (the last step's metrics as
    floats).

    ``seconds`` or ``tokens`` sets the clip length (rounded down to a hop
    multiple, at least one hop). The initial weights are drawn from ``seed``
    as ``get_model`` draws them, with no position-bias caches (the bias MLP
    trains), unless ``state_dict`` (a ``Codec`` state dict, e.g.
    ``weights.from_jax_params`` of JAX's ``init_codec``) replaces them.
    ``drop_path_rate > 0`` enables stochastic depth and FSQ's noise, both
    from the step's generator (:func:`step_generator`). ``save_every > 0``
    writes a checkpoint every k steps into ``ckpt_dir``; ``resume`` restores
    the newest and continues with the same data and generators. ``device``:
    the card by default (raises without CUDA), ``"cpu"`` for the plain path.
    """
    if (dp, sp, tp) != (1, 1, 1):
        raise NotImplementedError(
            f"train: dp = {dp}, sp = {sp}, tp = {tp}: the port trains on one device; the "
            "(dp, sp, tp) mesh comes with parallelism (ROADMAP A11)")
    from .config import get_config
    from .models.zoo import _resolve_device
    from .train import make_train_step

    dev = _resolve_device(device)
    cfg = get_config(config)
    mc = cfg.network_config
    hop = mc.hop_length
    if seconds is not None:
        samples = max(hop, int(seconds * cfg.sample_rate) // hop * hop)
    else:
        samples = tokens * hop

    with torch.inference_mode(False), _fp32_deterministic():
        codec = build_codec(config, dev, seed, state_dict)
        # torch's defaults are optax.adam's: b1 0.9, b2 0.999, eps 1e-8
        optimizer = torch.optim.Adam(codec.parameters(), lr=lr)
        step_fn = make_train_step(codec, lr=lr, optimizer=optimizer,
                                  drop_path_rate=drop_path_rate, spectral=spectral)

        start = 0
        if resume:
            found = latest(ckpt_dir) if ckpt_dir else None
            if found is None:
                log(f"--resume: no checkpoint under {ckpt_dir}, starting fresh")
            else:
                start = _restore(found[1], codec, optimizer)
                log(f"resumed from {found[1]} at step {start}")

        data = (WavDirAudio(wav_dir, batch, samples, cfg.sample_rate, seed)
                if wav_dir else SyntheticAudio(batch, samples, seed))
        use_generator = drop_path_rate > 0.0

        metrics: dict = {}
        ckpt_path = Path(ckpt_dir) if ckpt_dir else None
        t0 = time.perf_counter()
        for step in range(start, steps):
            audio = torch.from_numpy(data(step)).to(dev)
            gen = step_generator(seed, step, dev) if use_generator else None
            metrics = step_fn(audio, gen)
            if log_every and (step + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                log(f"step {step + 1}/{steps}  loss {m['loss']:.5f}  "
                    f"wav_l2 {m['wav_l2']:.5f}  ({dt:.1f}s)")
            if ckpt_path and save_every and (step + 1) % save_every == 0:
                log(f"saved {_save(ckpt_path, step + 1, codec, optimizer)}")
        # final save only if the loop advanced past the last periodic save; a
        # resume whose checkpoint is already at or past `steps` writes nothing
        # and reports the real step (l3ac_tpu/trainer.py:246-253)
        final_step = max(start, steps)
        if ckpt_path and save_every and steps > start and steps % save_every:
            log(f"saved {_save(ckpt_path, steps, codec, optimizer)}")
    return {"codec": codec, "optimizer": optimizer, "step": final_step,
            "metrics": {k: float(v) for k, v in metrics.items()}}
