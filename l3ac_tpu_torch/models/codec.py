"""Codec assembly: encoder -> en_encoder -> FSQ -> en_decoder -> decoder
(``l3ac_tpu/models/codec.py:24-112``).

Audio is (B, T) in the model's dtype (float32 or bfloat16); features are
channels-last (B, T', C).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.droppath import split
from . import local_transformer as lt
from .decoder import Decoder
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
    """The five modules ``encoder``, ``quantizer``, ``decoder``,
    ``en_encoder``, ``en_decoder``. Parameter names follow the JAX pytree
    paths (see ``weights``)."""

    def __init__(self, mc: ModelConfig, device=None):
        super().__init__()
        self.mc = mc
        self.encoder = Encoder(mc, device=device)
        self.quantizer = Quantizer(mc.feature_dim, mc.vq, device=device)
        self.decoder = Decoder(mc, device=device)
        if mc.uses_compressed_transformer:
            self.en_encoder = lt.CompressedEncoder(mc, device=device)
            self.en_decoder = lt.CompressedDecoder(mc, device=device)
        else:
            self.en_encoder = lt.LocalTrans(lt.plain_encoder_config(mc), device=device)
            self.en_decoder = lt.LocalTrans(lt.plain_decoder_config(mc), device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        """The encode half draws first, so its weights for a seed do not depend
        on the decode half."""
        self.encoder.init_weights(gen)
        self.quantizer.init_weights(gen)
        self.en_encoder.init_weights(gen)
        self.decoder.init_weights(gen)
        self.en_decoder.init_weights(gen)

    def attach_bias_caches(self) -> None:
        """Precompute every transformer stack's position bias (recomputed on
        every call)."""
        self.en_encoder.attach_bias_cache()
        self.en_decoder.attach_bias_cache()

    def en_encoder_apply(self, feature: torch.Tensor) -> torch.Tensor:
        return self.en_encoder(feature)

    def en_decoder_apply(self, feature: torch.Tensor) -> torch.Tensor:
        return self.en_decoder(feature)

    def encode(self, audio: torch.Tensor):
        """(B, T) hop-padded audio -> (q_trans_feature (B, T'', C), indices
        (B, T'') int32)."""
        feature = self.encoder(audio)
        trans_feature = self.en_encoder_apply(feature)
        q, indices, _ = self.quantizer(trans_feature)
        return q, indices

    def decode(self, q_trans_feature: torch.Tensor) -> torch.Tensor:
        """(B, T'', C) quantized features -> (B, T) audio."""
        return self.decoder(self.en_decoder_apply(q_trans_feature))

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, T'') indices -> (B, T) audio, features made in the decoder's dtype."""
        dtype = self.decoder.in_conv.weight.dtype
        return self.decode(self.quantizer.indices_to_features(indices, dtype))

    def forward(self, audio: torch.Tensor, *, training: bool = False,
                generator: torch.Generator | None = None,
                drop_path_rate: float = 0.0) -> dict:
        """The training-style round trip (``l3ac_tpu/models/codec.py:229-261``,
        the reference's ``EnCodec.forward``): (B, T) audio, padded here to a
        hop multiple, -> the reference's output dict, ``generated_audio``
        cropped to T. ``training``: FSQ's straight-through estimator.
        ``generator`` (on the audio's device) enables FSQ's noise and, with
        ``drop_path_rate > 0``, the conv units' stochastic depth; it is split
        into FSQ, encoder and decoder streams as JAX splits its key."""
        g_fsq, g_enc, g_dec = split(generator, 3)
        padded, length = preprocess(audio, self.mc)
        feature = self.encoder(padded.contiguous(), drop_path_rate=drop_path_rate,
                               generator=g_enc)
        trans_feature = self.en_encoder_apply(feature)
        q_trans, indices, _ = self.quantizer(trans_feature, training=training,
                                             generator=g_fsq)
        q_feature = self.en_decoder_apply(q_trans)
        y = self.decoder(q_feature, drop_path_rate=drop_path_rate, generator=g_dec)
        return {
            "generated_audio": y[..., :length],
            "embedded_audio": q_feature,
            "indices": indices,
            "commit_loss": torch.zeros((), dtype=audio.dtype, device=audio.device),
            "hidden_feature": {
                "encoded_feature": feature,
                "encoded_trans_feature": trans_feature,
                "quantized_trans_feature": q_trans,
                "quantized_feature": q_feature,
            },
        }
