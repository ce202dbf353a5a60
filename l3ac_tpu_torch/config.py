"""Configuration layer: TOML-named model zoo and typed model configs.

A standalone copy of ``l3ac_tpu/config.py`` (the port imports nothing of the
JAX package): TOML files at the lowest precedence, overridable by environment
variables and init kwargs. ``configs/*.toml`` are byte-identical copies of the
JAX package's files. Configs are frozen dataclasses.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tomllib
from functools import reduce
from pathlib import Path

CONFIG_DIR = Path(__file__).parent / "configs"


@dataclasses.dataclass(frozen=True)
class VQConfig:
    name: str = "super_fsq"
    levels: tuple[int, ...] = (7, 7, 7, 7, 7, 7)
    noise_rate: float = 0.5
    codebook_num: int = 1

    def __post_init__(self):
        if self.name != "super_fsq":
            raise ValueError(f"Unknown vq name: {self.name}")
        if self.codebook_num != 1:
            raise ValueError("super_fsq supports codebook_num == 1 only")

    @property
    def codebook_dim(self) -> int:
        return len(self.levels)

    @property
    def codebook_size(self) -> int:
        return math.prod(self.levels)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network geometry. Field names/validators match the reference ModelConfig
    (``l3ac/codec.py:13-36``) + EnCodec extension (``l3ac/en_codec.py:9-19``)."""

    feature_dim: int = 256
    compress_rates: tuple[int, ...] = (9, 5)
    encoder_dims: tuple[int, ...] = (24, 96, 192)
    encoder_depths: tuple[int, ...] = (1, 1, 2)
    decode_rates: tuple[int, ...] = (5, 3, 3)
    decoder_dims: tuple[int, ...] = (256, 128, 64, 32)
    decoder_depths: tuple[int, ...] = (3, 2, 1, 1)
    base_unit: str = "normal"
    use_norm: bool = True
    use_snake_act: bool = True
    decoder_last_layer: str | None = None
    vq: VQConfig = dataclasses.field(default_factory=VQConfig)
    # EnCodec (local transformer) extension
    en_coder_depth: int = 2
    en_coder_window_size: int = 500
    en_coder_dynamic_pos: bool = False
    en_coder_compress_rate: int = 1
    en_coder_cache_size: int = 0

    def __post_init__(self):
        assert self.base_unit == "normal"
        assert len(self.compress_rates) + 1 == len(self.encoder_dims) == len(self.encoder_depths)
        assert len(self.decode_rates) + 1 == len(self.decoder_dims) == len(self.decoder_depths)
        assert self.en_coder_cache_size == 0, "cache_size != 0 is dead code in the reference"

    @property
    def conv_hop_length(self) -> int:
        return reduce(lambda x, y: x * y, self.compress_rates)

    @property
    def hop_length(self) -> int:
        return self.conv_hop_length * self.en_coder_compress_rate

    @property
    def uses_compressed_transformer(self) -> bool:
        # reference branch at l3ac/en_codec.py:25-44
        return not (self.en_coder_compress_rate == 1 and self.en_coder_cache_size == 0)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Top-level named-model config (reference ``L3ACConfig``, ``l3ac/__init__.py:54-81``)."""

    model_name: str = "debug"
    sample_rate: int = 16000
    model_version: str = "v0.0"
    model_dir: str = str(Path.home() / ".cache" / "l3ac_tpu")
    weight_url: str | None = None
    network_config: ModelConfig = dataclasses.field(default_factory=ModelConfig)

    @property
    def model_tag(self) -> str:
        return f"{self.model_name}.{self.model_version}"

    @property
    def model_path(self) -> Path:
        return Path(self.model_dir) / self.model_tag

    @property
    def resolved_weight_url(self) -> str:
        # HF URL template matching the reference checkpoint distribution
        # (l3ac/__init__.py:78-80); per-module files {encoder,quantizer,decoder,
        # en_encoder,en_decoder}.pt
        if self.weight_url is not None:
            return self.weight_url
        return ("https://huggingface.co/zhai-lw/L3AC/resolve/main/weights/"
                f"{self.model_name}.{self.model_version}/" + "{}.pt")

    # ---- derived model-card numbers (reference get_model_info, __init__.py:28-51)
    @property
    def total_compress_rate(self) -> int:
        return self.network_config.hop_length

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.total_compress_rate

    @property
    def bps(self) -> float:
        return self.frame_rate * math.log2(self.network_config.vq.codebook_size)

    @property
    def receptive_field_seconds(self) -> float:
        return self.network_config.en_coder_window_size / self.frame_rate


def _env_override(fields: dict, prefix: str = "") -> dict:
    """Env vars (case-insensitive field names) override TOML values, mirroring
    the reference precedence: init kwargs > env > TOML (``xtract/config.py:16-31``)."""
    out = dict(fields)
    for key in list(out):
        for candidate in (key, key.upper(), prefix + key.upper()):
            if candidate in os.environ:
                raw = os.environ[candidate]
                cur = out[key]
                if isinstance(cur, bool):
                    out[key] = raw.lower() in ("1", "true", "yes")
                elif isinstance(cur, int):
                    out[key] = int(raw)
                elif isinstance(cur, float):
                    out[key] = float(raw)
                else:
                    out[key] = raw
                break
    return out


def _tupled(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def load_config(path: str | Path, **overrides) -> CodecConfig:
    """Load a CodecConfig from a TOML file (reference-format), with env-var and
    kwarg overrides."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    raw.pop("model_tag", None)  # stale key in the reference debug.toml
    raw.pop("weight_urls", None)

    net_raw = _tupled(raw.pop("network_config", {}))
    vq_raw = net_raw.pop("vq_config", None)
    vq = VQConfig(**{"levels": tuple(vq_raw["levels"]),
                     **{k: v for k, v in vq_raw.items() if k != "levels"}}) \
        if vq_raw else VQConfig()
    net_overrides = overrides.pop("network_config", {})
    net = ModelConfig(vq=vq, **{**net_raw, **net_overrides})

    top = _env_override(raw)
    top.update(overrides)
    return CodecConfig(network_config=net, **top)


def list_models() -> list[str]:
    return sorted(p.stem for p in CONFIG_DIR.rglob("*.toml"))


def get_config(name: str, **overrides) -> CodecConfig:
    return load_config(CONFIG_DIR / f"{name}.toml", **overrides)
