"""End-to-end demo, the port's copy of ``examples/demo.py``::

    python -m l3ac_tpu_torch.demo --random                 # seeded weights, on the card
    python -m l3ac_tpu_torch.demo --model-path DIR         # the reference's .pt files in DIR
    python -m l3ac_tpu_torch.demo --model debug --random --device cpu

Lists the models, builds the codec (``--model``, default 1kbps), prints
``get_model_info``, then encodes and decodes a synthetic speech-like chirp
(the fallback clip of ``examples/demo.py``: a wobbling pitch under an
envelope, 4 s) and prints the token shape, the bit rate, the token ids and
the MSE. Weights are seeded (``--random``, ``--seed``) or read from local
files (``--model-path``, through ``L3AC.load_pretrained``); with neither it
raises, since nothing is downloaded. The models run on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def synthetic_chirp(sample_rate: int, seconds: float = 4.0) -> np.ndarray:
    """(1, T) fp32: ``examples/demo.py``'s synthetic clip."""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    f = 120 + 80 * np.sin(2 * np.pi * 1.3 * t)          # wobbling pitch
    audio = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sample_rate)
    audio *= (0.5 + 0.5 * np.sin(2 * np.pi * 2.7 * t))  # envelope
    return audio[None].astype(np.float32)


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the token ids (numpy), the decoded audio's MSE
    and the model info."""
    ap = argparse.ArgumentParser(prog="python -m l3ac_tpu_torch.demo")
    ap.add_argument("--model", default="1kbps")
    ap.add_argument("--random", action="store_true", help="seeded random weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-path", default=None,
                    help="a directory holding the reference's five .pt files")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.random and args.model_path is None:
        raise SystemExit("l3ac_tpu_torch.demo: pass --random (seeded weights) or --model-path "
                         "DIR (the reference's .pt files); nothing is downloaded")

    from .config import list_models
    from .models.zoo import get_model, get_model_info

    print("models:", sorted(list_models()))
    model = get_model(args.model, device=args.device, seed=args.seed)
    if args.model_path is not None:
        model.load_pretrained(args.model_path)
    print(f"loaded codec {args.model} on {model.device}, sample rate: "
          f"{model.config.sample_rate}")
    info = get_model_info(model)
    print("model info:", json.dumps(info, default=str))

    audio = synthetic_chirp(model.config.sample_rate)
    print(f"audio shape: {audio.shape}")
    q_feature, indices = model.encode_audio(audio)
    tokens = indices.cpu().numpy()
    print(f"tokens: {tuple(tokens.shape)} ({model.config.bps:.1f} bps)")
    print("token ids:", json.dumps(tokens.tolist()))
    out = model.decode_audio(audio_feature=q_feature, audio_length=audio.shape[-1])
    mse = float(((audio - out.float().cpu().numpy()) ** 2).mean())
    print(f"MSE: {mse}")
    return {"tokens": tokens, "mse": mse, "info": info}


if __name__ == "__main__":
    main()
