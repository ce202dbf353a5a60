"""Reference checkpoints -> the port's ``Codec`` state dict
(``l3ac_tpu/runtime/convert.py``).

Maps the reference's per-module ``.pt`` state dicts (``encoder.pt``,
``quantizer.pt``, ``decoder.pt``, ``en_encoder.pt``, ``en_decoder.pt``) onto
the port's parameter names, folding torch weight-norm parametrizations
(``parametrizations.weight.original0/1`` -> ``W = g * v / ||v||``) at
convert time, so the kernels see plain dense weights. The fold is computed
in float64 and cast back to the dtype of ``v`` with numpy, as the JAX
converter computes it, so the two packages' weights are bit-equal.

The port keeps torch's layouts (conv (Cout, Cin/g, K), linear (Cout, Cin)),
so nothing is transposed. Names follow the port's modules, which are named
after the JAX param tree (``weights``): ``encoder.stages.0.units.1.pw1.weight``.

Strict mode fails on any disagreement between a checkpoint and the layer
map: a missing key raises naming the module and the torch key, and keys the
converter never consumed are listed per module. ``convert_model_dir`` diffs
a directory's checkpoints against the shipped key manifest
(``configs/<name>.keys.json``, byte-identical copies of the JAX package's)
before converting.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from ..config import CONFIG_DIR, ModelConfig

MODULES = ("encoder", "quantizer", "decoder", "en_encoder", "en_decoder")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_torch_state_dict(path) -> dict:
    """A ``.pt`` state dict -> ``{key: np.ndarray}`` (weights only, on the CPU)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``g * v / ||v||`` over every axis but the first, the norm in float64,
    cast back to ``v``'s dtype (JAX ``convert._fold_wn``, bit for bit)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g.reshape(v.shape[0], *([1] * (v.ndim - 1))) * v / norm).astype(v.dtype)


def _weight(sd, prefix: str) -> np.ndarray:
    """The (folded) torch-layout weight at ``prefix``."""
    wn_key = f"{prefix}.parametrizations.weight.original0"
    if wn_key in sd:
        return fold_weight_norm(sd[wn_key], sd[f"{prefix}.parametrizations.weight.original1"])
    return sd[f"{prefix}.weight"]


def _conv(sd, prefix: str) -> dict:
    return {"weight": _weight(sd, prefix), "bias": sd[f"{prefix}.bias"]}


def _linear(sd, prefix: str, bias: bool = True) -> dict:
    p = {"weight": _weight(sd, prefix)}
    if bias:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _norm(sd, prefix: str) -> dict:
    return {"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _alpha(sd, key: str) -> np.ndarray:
    return sd[key].reshape(-1)                 # Snake alpha (1,C,1)/(1,1,C) -> (C,)


def _grn(sd, prefix: str) -> dict:
    return {"gamma": sd[f"{prefix}.gamma"].reshape(-1),
            "beta": sd[f"{prefix}.beta"].reshape(-1)}


def _conv_unit(sd, prefix: str) -> dict:
    p = {
        "dw": _conv(sd, f"{prefix}.dw_conv"),
        "pw1": _linear(sd, f"{prefix}.pw_conv1"),
        "grn": _grn(sd, f"{prefix}.grn"),
        "pw2": _linear(sd, f"{prefix}.pw_conv2"),
    }
    if f"{prefix}.norm.weight" in sd:
        p["norm"] = _norm(sd, f"{prefix}.norm")
    if f"{prefix}.act.alpha" in sd:
        p["alpha"] = _alpha(sd, f"{prefix}.act.alpha")
    return p


def _legacy_unit(sd, prefix: str) -> dict:
    # LegacyUnit.block = Sequential(Snake, Conv, Snake, Conv)
    return {
        "alpha1": _alpha(sd, f"{prefix}.block.0.alpha"),
        "conv1": _conv(sd, f"{prefix}.block.1"),
        "alpha2": _alpha(sd, f"{prefix}.block.2.alpha"),
        "conv2": _conv(sd, f"{prefix}.block.3"),
    }


def _base_block(sd, prefix: str, n_branches: int) -> dict:
    # each branch = Sequential(TrendPool, Conv1d) -> conv at index 1
    return {"branches": [_conv(sd, f"{prefix}.blocks.{i}.1") for i in range(n_branches)]}


def _first_block(sd, prefix: str) -> dict:
    return {
        "base": _base_block(sd, prefix, 5),
        "conv1": _conv(sd, f"{prefix}.conv_1"),
        "conv2": _conv(sd, f"{prefix}.conv_2"),
    }


def _enhance_block(sd, prefix: str) -> dict:
    return {
        "base": _base_block(sd, prefix, 4),
        "in_norm": _norm(sd, f"{prefix}.merge_layer.0"),
        "merge": _conv(sd, f"{prefix}.merge_layer.1"),
    }


def convert_encoder(sd, mc: ModelConfig) -> dict:
    """Reference Encoder.blocks layout: [FirstBlock, (stage, down)*,
    last_stage, out_conv] (``l3ac/modules.py:82-113``)."""
    p = {"first": _first_block(sd, "blocks.0")}
    stages = []
    idx = 1
    for s in range(len(mc.compress_rates)):
        stage = {"units": [_conv_unit(sd, f"blocks.{idx}.{j}.module")
                           for j in range(mc.encoder_depths[s])],
                 "down": _conv(sd, f"blocks.{idx + 1}.0")}
        if mc.use_norm:
            stage["down_norm"] = _norm(sd, f"blocks.{idx + 1}.1")
        stages.append(stage)
        idx += 2
    p["stages"] = stages
    p["last_units"] = [_conv_unit(sd, f"blocks.{idx}.{j}.module")
                       for j in range(mc.encoder_depths[-1])]
    p["out_conv"] = _conv(sd, f"blocks.{idx + 1}")
    return p


def convert_decoder(sd, mc: ModelConfig) -> dict:
    """Reference Decoder.blocks layout: [in_conv, (stage, EnhanceBlock,
    up_layer)*, LastBlock] (``l3ac/modules.py:146-198``)."""
    p = {"in_conv": _conv(sd, "blocks.0")}
    stages = []
    idx = 1
    for s in range(len(mc.decode_rates)):
        stage = {"units": [_conv_unit(sd, f"blocks.{idx}.{j}.module")
                           for j in range(mc.decoder_depths[s])],
                 "enhance": _enhance_block(sd, f"blocks.{idx + 1}"),
                 "up_conv": _conv(sd, f"blocks.{idx + 2}.0")}
        if mc.use_norm:
            stage["up_norm"] = _norm(sd, f"blocks.{idx + 2}.2")
        stages.append(stage)
        idx += 3
    p["stages"] = stages

    # LastBlock.block = Sequential(tail_seq, Snake, Conv, Tanh)
    tail = f"blocks.{idx}.block"
    if mc.decoder_last_layer == "legacy":
        p["tail_units"] = [_legacy_unit(sd, f"{tail}.0.{j}.module") for j in range(3)]
    else:
        n_units = 3 if mc.decoder_last_layer == "dilation" else 2
        p["tail_units"] = [_conv_unit(sd, f"{tail}.0.{j}.module") for j in range(n_units)]
    p["tail_alpha"] = _alpha(sd, f"{tail}.1.alpha")
    p["out_conv"] = _conv(sd, f"{tail}.2")
    return p


def convert_quantizer(sd, mc: ModelConfig) -> dict:
    if "project_in.weight" not in sd:  # identity projections
        return {}
    return {"proj_in": _linear(sd, "project_in"), "proj_out": _linear(sd, "project_out")}


def _local_trans(sd, prefix: str, depth: int) -> dict:
    pre = f"{prefix}." if prefix else ""
    p = {"layers": []}
    if f"{pre}dynamic_pos_bias.mlp.0.weight" in sd:
        mlp = f"{pre}dynamic_pos_bias.mlp"
        p["dyn_bias"] = {}
        for i, seq in enumerate((0, 2, 4)):
            lin = _linear(sd, f"{mlp}.{seq}")
            p["dyn_bias"][f"w{i}"] = lin["weight"]
            p["dyn_bias"][f"b{i}"] = lin["bias"]
    for layer in range(depth):
        attn_pre = f"{pre}layers.{layer}.0"
        ff_pre = f"{pre}layers.{layer}.1"
        p["layers"].append({
            "attn": {
                "norm": _norm(sd, f"{attn_pre}.norm"),
                "qkv": _linear(sd, f"{attn_pre}.to_qkv", bias=False),
                "out": _linear(sd, f"{attn_pre}.to_out", bias=False),
            },
            "ff": {
                "norm": _norm(sd, f"{ff_pre}.0"),
                "w1": _linear(sd, f"{ff_pre}.1", bias=False),
                "w2": _linear(sd, f"{ff_pre}.4", bias=False),
            },
        })
    return p


def convert_up_trans_v1(sd, depth: int, rate: int) -> dict:
    """Torch ``UpTransV1`` (``l3ac/local_trans.py:97-111``) state dict ->
    the port's ``models.local_transformer.UpTransV1`` tree (JAX
    ``convert_up_trans_v1``): ``compressed_tokens.{i}`` (rate - 1 learned
    (1, 1, C) tokens) stacked as ``tokens`` (rate - 1, C), and ``trans.*``."""
    tokens = np.stack([_np(sd[f"compressed_tokens.{i}"]).reshape(-1) for i in range(rate - 1)])
    return {"tokens": tokens, "trans": _local_trans(sd, "trans", depth)}


def convert_en_encoder(sd, mc: ModelConfig) -> dict:
    if not mc.uses_compressed_transformer:
        # plain LocalEncoder(depth=1) (l3ac/en_codec.py:27-29)
        return _local_trans(sd, "local_trans", 1)
    return {
        "down_trans": _local_trans(sd, "down_trans.trans", 1),
        "down_conv": _conv(sd, "down_trans.down_layer"),
        "post_trans": _local_trans(sd, "local_trans", 2),
    }


def convert_en_decoder(sd, mc: ModelConfig) -> dict:
    if not mc.uses_compressed_transformer:
        return _local_trans(sd, "local_trans", mc.en_coder_depth)
    return {
        "pre_trans": _local_trans(sd, "local_trans", mc.en_coder_depth - 2),
        "up_trans": _local_trans(sd, "up_trans.trans", 2),
    }


MODULE_CONVERTERS = {
    "encoder": convert_encoder,
    "quantizer": convert_quantizer,
    "decoder": convert_decoder,
    "en_encoder": convert_en_encoder,
    "en_decoder": convert_en_decoder,
}


class _TrackedStateDict:
    """Read-only state-dict view that records which keys the converter
    consumed, so strict mode can diff against the checkpoint's full key set.
    ``in`` checks do not count as consumption (they probe optional layers)."""

    def __init__(self, sd: dict):
        self._sd = sd
        self.consumed: set[str] = set()

    def __getitem__(self, key: str):
        value = _np(self._sd[key])     # KeyError propagates with the key name
        self.consumed.add(key)
        return value

    def __contains__(self, key: str) -> bool:
        return key in self._sd


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree


def convert_checkpoint(state_dicts: dict, mc: ModelConfig, *,
                       strict: bool = False) -> dict[str, torch.Tensor]:
    """``{module_name: torch_state_dict}`` -> the port's ``Codec`` state dict
    (fp32 CPU tensors, for ``L3AC.load_state_dict``).

    With ``strict=True`` keys present in a checkpoint but never consumed by
    the converter are an error, listed per module. A missing key always
    raises, naming the module and the torch key.
    """
    flat: dict = {}
    problems: list[str] = []
    for name, sd in state_dicts.items():
        tracked = _TrackedStateDict(sd)
        try:
            tree = MODULE_CONVERTERS[name](tracked, mc)
        except KeyError as e:
            raise KeyError(
                f"converter for module '{name}' expected state-dict key {e} "
                f"which is absent; checkpoint has {len(sd)} keys, e.g. "
                f"{sorted(sd)[:5]}") from e
        _flatten(tree, f"{name}.", flat)
        unconsumed = sorted(set(sd) - tracked.consumed)
        if unconsumed:
            problems.append(
                f"{name}: {len(unconsumed)}/{len(sd)} keys not consumed: "
                + ", ".join(unconsumed[:12])
                + (" ..." if len(unconsumed) > 12 else ""))
    if strict and problems:
        raise ValueError(
            "strict checkpoint conversion found unconsumed keys (the torch "
            "module tree and this converter disagree):\n  "
            + "\n  ".join(problems))
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in flat.items()}


def load_key_manifest(config_name: str) -> dict | None:
    """``configs/<name>.keys.json``: the per-module expected state-dict key /
    shape table of the reference modules. None if no manifest ships for the
    name."""
    path = CONFIG_DIR / f"{config_name}.keys.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def validate_manifest(state_dicts: dict, manifest: dict) -> list[str]:
    """Diff ``{module: {key: array}}`` against a key manifest. Returns a list
    of human-readable problems (missing keys, unexpected keys, shape
    mismatches), empty when the checkpoint matches the layout exactly."""
    problems: list[str] = []
    for mod, want in manifest.items():
        if mod not in state_dicts:
            problems.append(f"{mod}: module state dict missing")
            continue
        got = state_dicts[mod]
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing:
            problems.append(f"{mod}: missing keys: " + ", ".join(missing[:8])
                            + (" ..." if len(missing) > 8 else ""))
        if extra:
            problems.append(f"{mod}: unexpected keys: " + ", ".join(extra[:8])
                            + (" ..." if len(extra) > 8 else ""))
        for k in set(want) & set(got):
            if list(np.shape(got[k])) != list(want[k]):
                problems.append(
                    f"{mod}.{k}: shape {list(np.shape(got[k]))} != "
                    f"manifest {list(want[k])}")
    return problems


def convert_model_dir(model_path, mc: ModelConfig, *, strict: bool = True,
                      config_name: str | None = None) -> dict[str, torch.Tensor]:
    """Load the reference's five per-module ``.pt`` files from a directory
    and convert them.

    Strict by default: every key must be accounted for (weight-norm pairs
    fold into one dense weight each). When ``config_name`` names a shipped
    manifest, the checkpoints' key / shape sets are diffed against it first,
    so an architecture disagreement surfaces as a complete named diff rather
    than a converter KeyError.
    """
    model_path = Path(model_path)
    sds = {name: load_torch_state_dict(model_path / f"{name}.pt") for name in MODULES}
    if config_name is not None:
        manifest = load_key_manifest(config_name)
        if manifest is not None:
            problems = validate_manifest(sds, manifest)
            if strict and problems:
                raise ValueError(
                    f"checkpoint at {model_path} does not match the "
                    f"'{config_name}' key manifest:\n  " + "\n  ".join(problems))
    return convert_checkpoint(sds, mc, strict=strict)


def seeded_state_dicts(manifest: dict, seed: int = 0) -> dict[str, dict[str, torch.Tensor]]:
    """Reference-layout state dicts with every key and shape of a manifest
    and seeded values at init scale, for tests and smoke runs that have no
    released checkpoint: weight-norm directions N(0, 0.02) with gains of
    0.5-1.5 times their norm, plain weights U(+-1/sqrt(fan_in)), biases
    N(0, 0.02), norm weights 1 + N(0, 0.05), snake alphas 1 + |N(0, 0.1)|,
    GRN gamma / beta N(0, 0.05). fp32, in the manifest's key order."""
    rng = np.random.default_rng(seed)
    out = {}
    for mod, keys in manifest.items():
        sd = {}
        # each gain after its direction, whatever the manifest's order
        for key in sorted(keys, key=lambda k: k.endswith(".original0")):
            shape = tuple(keys[key])
            leaf = key.rsplit(".", 1)[-1]
            if leaf == "original1":
                a = rng.standard_normal(shape) * 0.02
            elif leaf == "original0":
                v = sd[key[:-1] + "1"].numpy().astype(np.float64)
                norm = np.sqrt((v ** 2).reshape(v.shape[0], -1).sum(1))
                a = (norm * rng.uniform(0.5, 1.5, v.shape[0])).reshape(shape)
            elif leaf == "weight" and len(shape) >= 2:
                bound = math.prod(shape[1:]) ** -0.5
                a = rng.uniform(-bound, bound, shape)
            elif leaf == "weight":
                a = 1.0 + rng.standard_normal(shape) * 0.05
            elif leaf == "alpha":
                a = 1.0 + np.abs(rng.standard_normal(shape)) * 0.1
            elif leaf in ("gamma", "beta"):
                a = rng.standard_normal(shape) * 0.05
            else:
                a = rng.standard_normal(shape) * 0.02
            sd[key] = torch.from_numpy(np.asarray(a, np.float32))
        out[mod] = {key: sd[key] for key in keys}
    return out


def write_state_dicts(state_dicts: dict, model_path) -> Path:
    """Write ``{module: state_dict}`` as the reference's per-module ``.pt``
    files (``torch.save``) under ``model_path``."""
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    for name, sd in state_dicts.items():
        torch.save(sd, model_path / f"{name}.pt")
    return model_path
