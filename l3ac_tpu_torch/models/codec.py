"""Codec assembly, encode half: encoder -> en_encoder -> FSQ
(``l3ac_tpu/models/codec.py:24-94``). The decode half comes with the decoder.

Audio is (B, T) float32; features are channels-last (B, T', C).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from . import local_transformer as lt
from .encoder import Encoder
from .quantizer import Quantizer


def preprocess(audio: torch.Tensor, mc: ModelConfig) -> tuple[torch.Tensor, int]:
    """Right-pad (B, T) audio with zeros to a hop multiple."""
    length = audio.shape[-1]
    pad = math.ceil(length / mc.hop_length) * mc.hop_length - length
    if pad:
        audio = F.pad(audio, (0, pad))
    return audio, length


class Codec(nn.Module):
    """The encode path's modules: ``encoder``, ``en_encoder``, ``quantizer``.
    Parameter names follow the JAX pytree paths (see ``weights``)."""

    def __init__(self, mc: ModelConfig, device=None):
        super().__init__()
        self.mc = mc
        self.encoder = Encoder(mc, device=device)
        self.quantizer = Quantizer(mc.feature_dim, mc.vq, device=device)
        if mc.uses_compressed_transformer:
            self.en_encoder = lt.CompressedEncoder(mc, device=device)
        else:
            self.en_encoder = lt.LocalTrans(lt.plain_encoder_config(mc), device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.encoder.init_weights(gen)
        self.quantizer.init_weights(gen)
        self.en_encoder.init_weights(gen)

    def attach_bias_caches(self) -> None:
        """Precompute every transformer stack's position bias (recomputed on
        every call)."""
        self.en_encoder.attach_bias_cache()

    def en_encoder_apply(self, feature: torch.Tensor) -> torch.Tensor:
        return self.en_encoder(feature)

    def encode(self, audio: torch.Tensor):
        """(B, T) hop-padded audio -> (q_trans_feature (B, T'', C), indices
        (B, T'') int32)."""
        feature = self.encoder(audio)
        trans_feature = self.en_encoder_apply(feature)
        q, indices, _ = self.quantizer(trans_feature)
        return q, indices
