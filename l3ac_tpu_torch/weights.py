"""Weights carried across from the JAX package.

``load_npz`` reads the single-file checkpoint that
``l3ac_tpu/runtime/checkpoint.py:save_params`` writes (pytree paths flattened
to ``a/b/[i]/w`` keys). ``from_jax_params`` maps such a tree onto the port's
``Codec`` state dict:

- names: ``/`` -> ``.``, ``[i]`` -> ``i``, and the leaves ``w`` / ``b`` ->
  ``weight`` / ``bias`` (the port's modules are named after the JAX tree);
- layouts: 3-D conv weights (K, Cin/g, Cout) -> (Cout, Cin/g, K); 2-D linear
  weights (Cin, Cout) -> (Cout, Cin); vectors as they are;
- int8 leaves of a tree that JAX's ``quantize_params`` made: ``w_q`` stays
  int8 and goes (Cin, Cout) -> (Cout, Cin); ``w_scale`` (1, Cout) -> (Cout,).
  Every other leaf is cast to fp32.

It is strict: every parameter and buffer of the port's ``Codec`` (quantized
by ``ops.quantized.quantize_params`` when the tree holds int8 leaves, with
the default selection that JAX's ``quantize_params`` makes too) must be
present with its shape and dtype, and a key left
over in any of the five subtrees (``encoder``, ``quantizer``, ``decoder``,
``en_encoder``, ``en_decoder``) is an error.
``bias_cache`` leaves are dropped: the port recomputes them from the MLP
weights.

``to_jax_params`` is the inverse: the port's state dict -> the JAX tree, which
``runtime.checkpoint.save_params`` writes in JAX's ``.npz`` format.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .config import ModelConfig

SUBTREES = ("encoder", "quantizer", "decoder", "en_encoder", "en_decoder")
_LEAF_NAMES = {"w": "weight", "b": "bias"}
_JAX_LEAF_NAMES = {v: k for k, v in _LEAF_NAMES.items()}


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.startswith("[") and k.endswith("]") for k in node):
            return [node[f"[{i}]"] for i in range(len(node))]
        return node

    return listify(root)


def load_npz(path: str | Path) -> dict:
    """An ``.npz`` param checkpoint -> nested dict/list tree of numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "bias_cache":
                continue
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        parts = prefix[:-1].rsplit(".", 1)
        parts[-1] = _LEAF_NAMES.get(parts[-1], parts[-1])
        out[".".join(parts)] = np.asarray(tree)


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def _convert(name: str, a: np.ndarray) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_q":                      # kept as it is: a float here must fail
        return a.T if a.ndim == 2 else a
    if leaf == "w_scale":
        return np.asarray(a, np.float32).reshape(-1)
    return _to_torch_layout(np.asarray(a, np.float32))


def convert_subtree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX param (sub)tree -> {port name: torch-layout array} (fp32, int8
    for ``w_q``), with no check of which names the port expects."""
    flat: dict = {}
    _flatten(tree, prefix, flat)
    return {k: _convert(k, v) for k, v in flat.items()}


def up_trans_v1_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``init_up_trans_v1`` params -> the state dict of the port's
    ``models.local_transformer.UpTransV1``: ``tokens`` (rate - 1, C) as it
    is (its rows are tokens, not a linear's (Cin, Cout) weight), ``trans``
    through :func:`convert_subtree`."""
    flat = {"tokens": np.asarray(tree["tokens"], np.float32),
            **convert_subtree(tree["trans"], "trans.")}
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in flat.items()}


def _expected(mc: ModelConfig, quantized: bool) -> dict[str, torch.Tensor]:
    """The state dict (meta tensors) of the port's ``Codec`` for ``mc``,
    quantized by ``quantize_params`` when ``quantized``."""
    from .models.codec import Codec
    from .ops.quantized import quantize_params

    codec = Codec(mc, device="meta")
    if quantized:
        quantize_params(codec)
    return codec.state_dict()


def from_jax_params(tree: dict, mc: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX codec params (arrays or numpy) -> the port's ``Codec`` state dict
    (CPU tensors). A tree with int8 leaves maps onto a codec quantized by
    ``quantize_params(codec)``."""
    unknown = set(tree) - set(SUBTREES)
    if unknown:
        raise KeyError(f"unknown top-level param subtrees: {sorted(unknown)}")
    flat: dict = {}
    for sub in SUBTREES:
        if sub not in tree:
            raise KeyError(f"param subtree {sub!r} is missing")
        flat.update(convert_subtree(tree[sub], f"{sub}."))

    out = {}
    for name, ref in _expected(mc, any(k.endswith(".w_q") for k in flat)).items():
        if name not in flat:
            raise KeyError(f"JAX params lack {name!r}")
        a = flat.pop(name)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{name}: JAX shape gives {a.shape}, the port "
                             f"expects {tuple(ref.shape)}")
        t = torch.from_numpy(np.array(a, order="C"))
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: JAX dtype gives {t.dtype}, the port "
                            f"expects {ref.dtype}")
        out[name] = t
    if flat:
        raise KeyError(f"JAX params hold keys the port does not use: "
                       f"{sorted(flat)[:10]}")
    return out


def _to_jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()  # no bf16 in numpy: exact fp32
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_scale":
        return a.reshape(1, -1)
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def to_jax_params(state_dict: dict, mc: ModelConfig) -> dict:
    """The port's ``Codec`` state dict -> the JAX param tree (numpy, JAX
    layouts, no ``bias_cache`` leaves): the inverse of ``from_jax_params``.
    bf16 tensors come back as fp32 arrays of their values (numpy has no
    bf16), which ``astype(jnp.bfloat16)`` restores exactly.
    Strict: the state dict holds exactly the codec's keys (a quantized codec's
    when it holds ``w_q`` buffers) with their shapes."""
    expected = _expected(mc, any(k.endswith(".w_q") for k in state_dict))
    missing = sorted(set(expected) - set(state_dict))
    extra = sorted(set(state_dict) - set(expected))
    if missing or extra:
        raise KeyError(f"state dict does not match the codec: missing {missing[:10]}, "
                       f"unexpected {extra[:10]}")
    root: dict = {}
    for name, ref in expected.items():
        t = state_dict[name]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the codec has "
                             f"{tuple(ref.shape)}")
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[_JAX_LEAF_NAMES.get(leaf, leaf)] = _to_jax_layout(name, t)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
