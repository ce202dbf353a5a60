"""Weights carried across from the JAX package.

``load_npz`` reads the single-file checkpoint that
``l3ac_tpu/runtime/checkpoint.py:save_params`` writes (pytree paths flattened
to ``a/b/[i]/w`` keys). ``from_jax_params`` maps such a tree onto the port's
``Codec`` state dict:

- names: ``/`` -> ``.``, ``[i]`` -> ``i``, and the leaves ``w`` / ``b`` ->
  ``weight`` / ``bias`` (the port's modules are named after the JAX tree);
- layouts: 3-D conv weights (K, Cin/g, Cout) -> (Cout, Cin/g, K); 2-D linear
  weights (Cin, Cout) -> (Cout, Cin); vectors as they are.

It is strict: every parameter of the encode path must be present with its
shape, and a key left over in the encode subtrees (``encoder``,
``quantizer``, ``en_encoder``) is an error. ``decoder`` and ``en_decoder``
are skipped by name until the decode path is ported, and ``bias_cache``
leaves are dropped: the port recomputes them from the MLP weights.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .config import ModelConfig

ENCODE_SUBTREES = ("encoder", "quantizer", "en_encoder")
SKIPPED_SUBTREES = ("decoder", "en_decoder")
_LEAF_NAMES = {"w": "weight", "b": "bias"}


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


def convert_subtree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX param (sub)tree -> {port name: torch-layout fp32 array}, with no
    check of which names the port expects."""
    flat: dict = {}
    _flatten(tree, prefix, flat)
    return {k: _to_torch_layout(np.asarray(v, np.float32)) for k, v in flat.items()}


def from_jax_params(tree: dict, mc: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX codec params (arrays or numpy) -> the port's ``Codec`` state dict
    (fp32 CPU tensors)."""
    from .models.codec import Codec

    unknown = set(tree) - set(ENCODE_SUBTREES) - set(SKIPPED_SUBTREES)
    if unknown:
        raise KeyError(f"unknown top-level param subtrees: {sorted(unknown)}")
    flat: dict = {}
    for sub in ENCODE_SUBTREES:
        if sub not in tree:
            raise KeyError(f"param subtree {sub!r} is missing")
        flat.update(convert_subtree(tree[sub], f"{sub}."))

    expected = Codec(mc, device="meta").state_dict()
    out = {}
    for name, ref in expected.items():
        if name not in flat:
            raise KeyError(f"JAX params lack {name!r}")
        a = flat.pop(name)
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{name}: JAX shape gives {a.shape}, the port "
                             f"expects {tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(a, order="C"))
    if flat:
        raise KeyError(f"JAX params hold keys the encode path does not use: "
                       f"{sorted(flat)[:10]}")
    return out
