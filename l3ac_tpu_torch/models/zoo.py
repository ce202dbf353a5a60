"""User-facing model zoo and codec facade (``l3ac_tpu/models/zoo.py``):
``get_model(name)``, ``get_model_info(model)``, and ``L3AC.encode_audio`` /
``decode_audio`` / ``roundtrip``, the chunked ``extract_unit`` /
``decode_unit`` and ``load_pretrained``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; there
the kernels' plain versions run. Without CUDA, the default raises rather
than run on the CPU unasked.

``get_model(..., dtype=torch.bfloat16)`` builds a bf16 model: the weights
are drawn in fp32 from the seed and then cast, as the JAX package's
``get_model(dtype=)`` casts its fp32 init. A bf16 model encodes and decodes
through every entry point (``encode_audio``, ``decode_audio``, ``roundtrip``,
``extract_unit`` / ``decode_unit``, ``runtime.streaming.StreamCodec``) on
the bf16 kernels, int8 weights too (``ops.quantized.quantize_params``):
tensors it returns are bf16, audio returned as numpy fp32.

Unlike the JAX package, nothing here downloads: ``load_pretrained`` reads
the reference's five ``.pt`` files from a local directory and raises,
naming the files and the URL they are published under, when any is missing.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..config import CodecConfig, get_config, list_models  # noqa: F401
from ..runtime import convert
from ..runtime.chunk import ChunkData
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
        self.dtype = next(codec.parameters()).dtype
        self.codec.attach_bias_caches()

    def load_state_dict(self, state_dict: dict) -> L3AC:
        """Load weights strictly (e.g. from ``weights.from_jax_params``) and
        recompute the position-bias caches from them."""
        self.codec.load_state_dict(state_dict, strict=True)
        self.codec.attach_bias_caches()
        return self

    def preprocess(self, audio) -> tuple[torch.Tensor, int]:
        """(T,) or (B, T) audio (numpy or tensor) -> hop-padded (B, T') in the
        model's dtype on its device, and the original length."""
        if isinstance(audio, np.ndarray):
            audio = torch.from_numpy(audio)
        audio = audio.to(self.device, self.dtype)
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
        """Features (B, T'', C), cast to the model's dtype, or indices (B, T'')
        -> (B, T) audio in the model's dtype, cropped to ``audio_length`` when
        given."""
        if audio_feature is not None:
            out = self.codec.decode(self._on_device(audio_feature).to(self.dtype).contiguous())
        else:
            out = self.codec.decode_indices(self._on_device(indices))
        return out if audio_length is None else out[..., :audio_length]

    @torch.inference_mode()
    def roundtrip(self, audio) -> torch.Tensor:
        """Encode then decode, cropped to the input length; audio in the
        model's dtype."""
        padded, length = self.preprocess(audio)
        q, _ = self.codec.encode(padded.contiguous())
        return self.codec.decode(q)[..., :length]

    def _on_device(self, t) -> torch.Tensor:
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.to(self.device)

    # -- weights ----------------------------------------------------------
    def load_pretrained(self, model_path: str | Path | None = None) -> L3AC:
        """Load and convert the reference's per-module ``.pt`` checkpoints
        from ``model_path`` (default ``config.model_path``), strictly against
        the config's key manifest. Never downloads: missing files raise
        ``FileNotFoundError`` naming each of them, the directory and the URL
        template the released files are published under."""
        path = Path(model_path) if model_path else self.config.model_path
        missing = [f"{m}.pt" for m in convert.MODULES if not (path / f"{m}.pt").is_file()]
        if missing:
            raise FileNotFoundError(
                f"missing checkpoint files {', '.join(missing)} in {path}; this package "
                "never downloads: place the reference's per-module .pt files there "
                f"(published as {self.config.resolved_weight_url})")
        return self.load_state_dict(convert.convert_model_dir(
            path, self.mc, config_name=self.config.model_name))

    # -- chunked streaming (reference extract_unit / decode_unit) ---------
    @torch.inference_mode()
    def extract_unit(self, audio, process_window: int = 5 * 16000):
        """Batch-1 chunked encode (reference ``l3ac/codec.py:124-147``): the
        hop-padded audio in windows of ``process_window`` (rounded down to
        the hop) with a one-hop prefix, each chunk encoded on the model's
        device. Returns (indices, features) as ``ChunkData`` of numpy
        chunks with a one-token prefix."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 2 or audio.shape[0] != 1:
            raise ValueError(f"extract_unit takes (1, T) audio, got {audio.shape}")
        hop = self.mc.hop_length
        padded = np.pad(audio[0], (0, math.ceil(audio.shape[-1] / hop) * hop - audio.shape[-1]))
        window = process_window // hop * hop

        chunk_audio = ChunkData(chunk_len=window, prefix_len=hop, original_data=padded)
        idx_chunks, feat_chunks = [], []
        for x in chunk_audio.chunk_data:
            audio_chunk = self._on_device(np.ascontiguousarray(x))[None].to(self.dtype)
            q, idx = self.codec.encode(audio_chunk)
            idx_chunks.append(idx[0].cpu().numpy())
            feat_chunks.append(q[0].float().cpu().numpy())
        return (ChunkData(chunk_len=window // hop, prefix_len=1, chunk_data=idx_chunks),
                ChunkData(chunk_len=window // hop, prefix_len=1, chunk_data=feat_chunks))

    @torch.inference_mode()
    def decode_unit(self, chunk_indices=None, chunk_q_feature=None) -> np.ndarray:
        """Batch-1 chunked decode (reference ``l3ac/codec.py:149-156``) of
        ``extract_unit``'s chunks, by features when given, else by indices;
        returns (1, T) numpy fp32 audio with each later chunk's one-hop
        prefix dropped. Features are cast to the model's dtype."""
        hop = self.mc.hop_length
        if chunk_q_feature is not None:
            chunks = [self.codec.decode(
                self._on_device(np.ascontiguousarray(x))[None].to(self.dtype))[0]
                for x in chunk_q_feature.chunk_data]
        else:
            chunks = [self.codec.decode_indices(self._on_device(np.ascontiguousarray(x))[None])[0]
                      for x in chunk_indices.chunk_data]
        out = ChunkData(chunk_len=len(chunks[0]), prefix_len=hop,
                        chunk_data=[c.float().cpu().numpy() for c in chunks])
        return out.data[None]


def get_model(name: str, *, pretrained: bool = False, device=None, seed: int = 0,
              dtype: torch.dtype = torch.float32, **overrides) -> L3AC:
    """Build a named model with weights drawn from ``seed``, or with the
    released weights when ``pretrained`` (``L3AC.load_pretrained`` from
    ``config.model_path``; raises when the files are not there, never
    downloads).

    ``device``: CUDA by default (raises without it); ``"cpu"`` runs the plain
    path. ``dtype``: fp32, or bf16 (the JAX package's serving dtype): the
    weights are drawn in fp32 and cast, and released weights are cast after
    conversion. The codec is built outside inference mode even when called inside
    it, so that its weights are ordinary tensors whose in-place changes are
    tracked (the kernels' prepared-weight cache relies on that).
    """
    dev = _resolve_device(device)
    cfg = get_config(name, **overrides)
    with torch.inference_mode(False):
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"get_model: dtype float32 or bfloat16, got {dtype}")
        codec = fcodec.Codec(cfg.network_config, device=dev)
        codec.init_weights(torch.Generator().manual_seed(seed))
        model = L3AC(cfg, codec.to(dtype))
        return model.load_pretrained() if pretrained else model


def get_model_info(model: L3AC, eval_flops_seconds: int = 10) -> dict:
    """Model-card numbers (reference ``get_model_info``,
    ``l3ac/__init__.py:28-51``), with the JAX package's keys.

    ``params`` counts the codec's weights (its state dict: parameters, and
    an int8 codec's ``w_q`` / ``w_scale`` buffers), not the position-bias
    caches. ``macs`` are counted by ``torch.utils.flop_counter`` over the
    plain path of a CPU copy for an encode and decode of
    ``eval_flops_seconds`` of audio (the CUDA kernels are invisible to the
    counter): products and convolutions only, where XLA's cost analysis,
    which the JAX package reports, also counts elementwise work.
    """
    from torch.utils.flop_counter import FlopCounterMode

    cfg, mc = model.config, model.mc
    state = model.codec.state_dict()
    info = {
        "params": sum(t.numel() for t in state.values()),
        "codebook_size": mc.vq.codebook_size,
        "frame_rate": cfg.frame_rate,
        "bps": cfg.bps,
        "receptive_field": cfg.receptive_field_seconds,
    }
    cpu = model
    if model.device.type != "cpu":
        with torch.inference_mode(False):
            cpu = L3AC(cfg, fcodec.Codec(mc, device="cpu"))
        if any(k.endswith(".w_q") for k in state):
            from ..ops.quantized import quantize_params
            quantize_params(cpu.codec)
        cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
    T = eval_flops_seconds * cfg.sample_rate // mc.hop_length * mc.hop_length
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        q, _ = cpu.codec.encode(torch.zeros(1, T))
        cpu.codec.decode(q)
    flops = counter.get_total_flops()
    info["macs"] = int(flops / 2)
    info["macs_per_audio_second"] = int(flops / 2 / eval_flops_seconds)
    return info
