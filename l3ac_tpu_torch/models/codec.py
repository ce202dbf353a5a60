"""Codec assembly: encoder -> en_encoder -> FSQ -> en_decoder -> decoder
(``l3ac_tpu/models/codec.py:24-112``).

Audio is (B, T) in the model's dtype (float32 or bfloat16); features are
channels-last (B, T', C).

Sequence parallelism (``l3ac_tpu/models/codec.py:130-226``): :func:`encode_sp`,
:func:`decode_sp` and :func:`decode_indices_sp` run one stream with its time
axis sharded over the ``sp`` ranks of a ``parallel.mesh`` mesh. Each rank
passes its own (batch, time) block, in order along the group, and gets its
own block back, as ``shard_map`` hands the blocks out in JAX; every op
exchanges exactly the halo it needs (``parallel.sp``), so the result equals
the single-device run to float tolerance and the FSQ indices exactly. The dp
axis (``batch_axis``) needs no exchange: each dp row of ranks runs its own
streams.

Tensor parallelism composes with both on the same mesh: a codec put onto
its shards (``parallel.tp.shard_codec(codec, mesh)``) runs its split pairs
inside ``parallel.tp.tensor_parallel``, which the three ``*_sp`` entry
points enter when the mesh's tp axis has more than one rank (with sp = 1
they are the tensor-parallel entry points: each rank passes the whole
stream).
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.droppath import split
from ..parallel import sp, tp
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

    def decode(self, q_trans_feature: torch.Tensor, *,
               tail_high_precision: bool = False) -> torch.Tensor:
        """(B, T'', C) quantized features -> (B, T) audio. ``tail_high_precision``:
        the decoder's tail in float64 (``Decoder.tail_apply``)."""
        return self.decoder(self.en_decoder_apply(q_trans_feature),
                            tail_high_precision=tail_high_precision)

    def decode_indices(self, indices: torch.Tensor, *,
                       tail_high_precision: bool = False) -> torch.Tensor:
        """(B, T'') indices -> (B, T) audio, features made in the decoder's dtype."""
        dtype = self.decoder.in_conv.weight.dtype
        return self.decode(self.quantizer.indices_to_features(indices, dtype),
                           tail_high_precision=tail_high_precision)

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


def sp_time_quantum(mc: ModelConfig) -> int:
    """Samples per sp shard must be a multiple of ``hop_length *
    en_coder_window_size``: whole hops keep every strided conv's grid inside
    a shard, whole windows keep the attention's window grid aligned across
    shards (every transformer stage's window divides this quantum at its own
    rate)."""
    return mc.hop_length * mc.en_coder_window_size


def _check_sp_len(T: int, mc: ModelConfig, n_sp: int, what: str, per_shard: int) -> None:
    if T % (per_shard * n_sp):
        raise ValueError(
            f"{what} length {T} must be a multiple of {per_shard * n_sp} "
            f"({n_sp} sp shards x quantum {per_shard}); pad/chunk the input "
            f"(see runtime.chunk) before the sp call")


def _sp_call(model, mesh, axis_name: str, batch_axis: str | None, local_len: int,
             what: str, per_shard: int, fn):
    codec = getattr(model, "codec", model)
    if axis_name not in mesh.shape:
        raise KeyError(f"mesh has no axis {axis_name!r}")
    if batch_axis is not None and (batch_axis not in mesh.shape or batch_axis == axis_name):
        raise KeyError(f"batch_axis {batch_axis!r} is not another axis of the mesh")
    if not codec.mc.en_coder_dynamic_pos:
        # JAX's SP entry points assert it at any sp size (its attention
        # under sequence_parallel); with tp alone, run inside
        # tp.tensor_parallel(mesh) instead
        raise NotImplementedError("rotary position embeddings are not supported under "
                                  "sequence parallelism (as in JAX)")
    n_sp = mesh.shape[axis_name]
    if n_sp > 1:  # one shard (tensor parallelism alone) takes any length the call takes
        _check_sp_len(local_len * n_sp, codec.mc, n_sp, what, per_shard)
    with torch.inference_mode(), sp_scope(mesh, axis_name), tp_scope(codec, mesh):
        return fn(codec)


def sp_scope(mesh, axis_name: str = "sp"):
    """``sp.sequence_parallel(mesh)`` where the axis has more than one rank
    (one rank runs the monolithic ops, any length)."""
    if mesh.shape[axis_name] == 1:
        return contextlib.nullcontext()
    return sp.sequence_parallel(mesh, axis_name)


def tp_scope(codec, mesh):
    """``tp.tensor_parallel(mesh)`` for a codec that holds tensor-parallel
    shards (a codec without them runs whole on every tp rank); raises when
    the codec's shards do not match the mesh."""
    shard = getattr(codec, "tp_shard", None)
    want = (mesh.coords[tp.AXIS], mesh.shape[tp.AXIS])
    if shard is not None and tuple(shard) != want:
        raise ValueError(f"the codec holds tp shard {shard}, the mesh gives {want}")
    return tp.tensor_parallel(mesh) if shard is not None else contextlib.nullcontext()


def encode_sp(model, audio: torch.Tensor, mesh, *, axis_name: str = "sp",
              batch_axis: str | None = None):
    """:meth:`Codec.encode` of this rank's block of a stream whose time axis
    is sharded over ``mesh[axis_name]``. ``model``: a Codec (or the zoo's
    L3AC). audio: this rank's (B, T / n_sp) block of hop-padded audio, T a
    multiple of ``sp_time_quantum(mc) * n_sp``. Returns this rank's
    (q_trans_feature, indices) block."""
    return _sp_call(model, mesh, axis_name, batch_axis, audio.shape[-1], "audio",
                    sp_time_quantum(getattr(model, "codec", model).mc),
                    lambda c: c.encode(audio))


def decode_sp(model, q_trans_feature: torch.Tensor, mesh, *, axis_name: str = "sp",
              batch_axis: str | None = None, tail_high_precision: bool = False) -> torch.Tensor:
    """:meth:`Codec.decode` of this rank's (B, T'' / n_sp, C) feature block,
    T'' a multiple of ``en_coder_window_size * n_sp``; returns this rank's
    audio block."""
    mc = getattr(model, "codec", model).mc
    return _sp_call(model, mesh, axis_name, batch_axis, q_trans_feature.shape[1], "token",
                    mc.en_coder_window_size,
                    lambda c: c.decode(q_trans_feature, tail_high_precision=tail_high_precision))


def decode_indices_sp(model, indices: torch.Tensor, mesh, *, axis_name: str = "sp",
                      batch_axis: str | None = None,
                      tail_high_precision: bool = False) -> torch.Tensor:
    """:meth:`Codec.decode_indices` of this rank's (B, T'' / n_sp) index
    block (FSQ's unpack is pointwise in time); returns its audio block."""
    mc = getattr(model, "codec", model).mc
    return _sp_call(model, mesh, axis_name, batch_axis, indices.shape[1], "token",
                    mc.en_coder_window_size,
                    lambda c: c.decode_indices(indices, tail_high_precision=tail_high_precision))
