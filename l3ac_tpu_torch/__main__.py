"""Command-line interface: ``python -m l3ac_tpu_torch <command>``
(``l3ac_tpu/__main__.py``)::

    python -m l3ac_tpu_torch list
    python -m l3ac_tpu_torch info   --model 1kbps
    python -m l3ac_tpu_torch encode in.wav tokens.npz --model 1kbps [--pretrained]
    python -m l3ac_tpu_torch decode tokens.npz out.wav

Tokens are stored as an ``.npz`` with the FSQ indices, the model name and
the original sample count (so decode crops exactly), as the JAX CLI writes
them. WAV I/O is PCM16 mono at the model's sample rate.

The models run on the card; ``--device cpu`` runs the plain path.
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

    args = ap.parse_args(argv)
    return {"list": cmd_list, "info": cmd_info,
            "encode": cmd_encode, "decode": cmd_decode}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
