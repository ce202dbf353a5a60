"""User-facing model zoo and codec facade (``l3ac_tpu/models/zoo.py``):
``get_model(name)`` and ``L3AC.encode_audio`` / ``decode_audio`` /
``roundtrip``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; there
the kernels' plain versions run. Without CUDA, the default raises rather
than run on the CPU unasked.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CodecConfig, get_config, list_models  # noqa: F401
from . import codec as fcodec


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


class L3AC:
    """Holds a config and the codec's modules on one device."""

    def __init__(self, config: CodecConfig, codec: fcodec.Codec):
        self.config = config
        self.mc = config.network_config
        self.codec = codec.eval()
        self.device = next(codec.parameters()).device
        self.codec.attach_bias_caches()

    def load_state_dict(self, state_dict: dict) -> L3AC:
        """Load weights strictly (e.g. from ``weights.from_jax_params``) and
        recompute the position-bias caches from them."""
        self.codec.load_state_dict(state_dict, strict=True)
        self.codec.attach_bias_caches()
        return self

    def preprocess(self, audio) -> tuple[torch.Tensor, int]:
        """(T,) or (B, T) audio (numpy or tensor) -> hop-padded (B, T') fp32 on
        the model's device, and the original length."""
        if isinstance(audio, np.ndarray):
            audio = torch.from_numpy(audio)
        audio = audio.to(self.device, torch.float32)
        if audio.dim() == 1:
            audio = audio[None]
        return fcodec.preprocess(audio, self.mc)

    @torch.inference_mode()
    def encode_audio(self, audio):
        """(B, T) audio -> (q_trans_feature (B, T'', C), indices (B, T''))."""
        padded, _ = self.preprocess(audio)
        return self.codec.encode(padded.contiguous())

    @torch.inference_mode()
    def decode_audio(self, audio_feature=None, indices=None,
                     audio_length: int | None = None) -> torch.Tensor:
        """Features (B, T'', C) or indices (B, T'') -> (B, T) audio, cropped
        to ``audio_length`` when given."""
        if audio_feature is not None:
            out = self.codec.decode(self._on_device(audio_feature).float().contiguous())
        else:
            out = self.codec.decode_indices(self._on_device(indices))
        return out if audio_length is None else out[..., :audio_length]

    @torch.inference_mode()
    def roundtrip(self, audio) -> torch.Tensor:
        """Encode then decode, cropped to the input length."""
        padded, length = self.preprocess(audio)
        q, _ = self.codec.encode(padded.contiguous())
        return self.codec.decode(q)[..., :length]

    def _on_device(self, t) -> torch.Tensor:
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.to(self.device)


def get_model(name: str, *, pretrained: bool = False, device=None, seed: int = 0,
              **overrides) -> L3AC:
    """Build a named model with weights drawn from ``seed``.

    ``device``: CUDA by default (raises without it); ``"cpu"`` runs the plain
    path. ``pretrained=True`` is not available: converting the released
    checkpoints is a later slice of the port (ROADMAP A7).
    """
    if pretrained:
        raise NotImplementedError(
            "pretrained weights need the checkpoint converter, which is not "
            "ported yet (ROADMAP A7); use pretrained=False, or load JAX "
            "params with l3ac_tpu_torch.weights.from_jax_params")
    dev = _resolve_device(device)
    cfg = get_config(name, **overrides)
    codec = fcodec.Codec(cfg.network_config, device=dev)
    codec.init_weights(torch.Generator().manual_seed(seed))
    return L3AC(cfg, codec)
