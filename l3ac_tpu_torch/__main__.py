"""Command-line interface: ``python -m l3ac_tpu_torch <command>``
(``l3ac_tpu/__main__.py``)::

    python -m l3ac_tpu_torch list
    python -m l3ac_tpu_torch info   --model 1kbps
    python -m l3ac_tpu_torch encode in.wav tokens.npz --model 1kbps [--pretrained]
    python -m l3ac_tpu_torch decode tokens.npz out.wav
    python -m l3ac_tpu_torch train  --config debug --steps 20 [--ckpt-dir d --save-every k --resume]

Tokens are stored as an ``.npz`` with the FSQ indices, the model name and
the original sample count (so decode crops exactly), as the JAX CLI writes
them. WAV I/O is PCM16 mono at the model's sample rate.

The models run on the card; ``--device cpu`` runs the plain path. ``train``
runs ``trainer.train`` on one device (``--dp`` / ``--sp`` / ``--tp`` above 1
raise: ROADMAP A11).
``--pretrained`` reads the released checkpoints from ``config.model_path``
and raises when they are not there: nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_model(name: str, pretrained: bool, device: str):
    from .models.zoo import get_model

    return get_model(name, pretrained=pretrained, device=device)


def cmd_list(args) -> int:
    from .config import list_models

    for name in sorted(list_models()):
        print(name)
    return 0


def cmd_info(args) -> int:
    from .models.zoo import get_model_info

    model = _load_model(args.model, args.pretrained, args.device)
    print(json.dumps(get_model_info(model), indent=1, default=str))
    return 0


def cmd_encode(args) -> int:
    from .utils.audio_io import read_wav

    model = _load_model(args.model, args.pretrained, args.device)
    sr = model.config.sample_rate
    audio, _ = read_wav(args.input, expect_rate=sr)
    _, indices = model.encode_audio(audio[None])
    np.savez(args.output, indices=indices[0].cpu().numpy(), model=args.model,
             length=len(audio))
    bps = len(audio) and (indices.shape[-1] * np.ceil(np.log2(model.mc.vq.codebook_size))
                          / (len(audio) / sr))
    print(f"{args.input}: {len(audio)/sr:.2f}s -> {indices.shape[-1]} tokens "
          f"({bps:.0f} bps) -> {args.output}")
    return 0


def cmd_decode(args) -> int:
    from .utils.audio_io import write_wav

    with np.load(args.input, allow_pickle=False) as z:
        indices = z["indices"]
        model_name = str(z["model"])
        length = int(z["length"])
    model = _load_model(args.model or model_name, args.pretrained, args.device)
    audio = model.decode_audio(indices=indices[None], audio_length=length)
    write_wav(args.output, audio[0].float().cpu().numpy(), model.config.sample_rate)
    print(f"{args.input}: {indices.shape[-1]} tokens -> "
          f"{length/model.config.sample_rate:.2f}s -> {args.output}")
    return 0


def cmd_train(args) -> int:
    from .trainer import train

    train(args.config, steps=args.steps, batch=args.batch,
          seconds=args.seconds, tokens=args.tokens, dp=args.dp, sp=args.sp,
          tp=args.tp, lr=args.lr, spectral=args.spectral,
          drop_path_rate=args.drop_path, seed=args.seed, wav_dir=args.wav_dir,
          ckpt_dir=args.ckpt_dir, save_every=args.save_every,
          resume=args.resume, device=args.device)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m l3ac_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("list", help="list released model configs")

    def model_args(p, default_model: str | None = "1kbps", help_model: str | None = None):
        p.add_argument("--model", default=default_model, help=help_model)
        p.add_argument("--pretrained", action="store_true",
                       help="convert the released torch checkpoint found in the "
                            "config's model_path (never downloaded)")
        p.add_argument("--device", default="cuda",
                       help="cuda (default: the CUDA kernels) or cpu (the plain path)")

    model_args(sub.add_parser("info", help="model parameters / MACs / bitrate"))

    p = sub.add_parser("encode", help="WAV -> FSQ token .npz")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p)

    p = sub.add_parser("decode", help="FSQ token .npz -> WAV")
    p.add_argument("input")
    p.add_argument("output")
    model_args(p, None, "override the model recorded in the token file")

    p = sub.add_parser(
        "train", help="train on one device with Adam + spectral loss, "
                      "checkpoints and --resume restart")
    p.add_argument("--config", default="debug")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=None,
                   help="clip length (rounded down to a hop multiple); "
                        "default --tokens")
    p.add_argument("--tokens", type=int, default=8,
                   help="clip length in codec tokens (hop multiples)")
    p.add_argument("--dp", type=int, default=1, help="not ported: above 1 raises")
    p.add_argument("--sp", type=int, default=1, help="not ported: above 1 raises")
    p.add_argument("--tp", type=int, default=1, help="not ported: above 1 raises")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--spectral", action="store_true",
                   help="add multi-resolution STFT + log-mel losses")
    p.add_argument("--drop-path", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wav-dir", default=None,
                   help="train on random crops from *.wav here (synthetic "
                        "noise feed otherwise)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every K steps")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --ckpt-dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the CUDA kernels) or cpu (the plain path)")

    args = ap.parse_args(argv)
    return {"list": cmd_list, "info": cmd_info,
            "encode": cmd_encode, "decode": cmd_decode,
            "train": cmd_train}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
