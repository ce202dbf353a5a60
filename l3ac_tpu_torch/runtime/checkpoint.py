"""Single-file ``.npz`` param checkpoints in the JAX package's format
(``l3ac_tpu/runtime/checkpoint.py``).

JAX param-tree paths flattened to ``a/b/[2]/w`` keys (list indices
bracketed), JAX layouts, no bias caches: a file either package writes loads
in the other. ``save_params`` writes the port's ``Codec`` state dict through
``weights.to_jax_params``; ``load_params`` reads it back through
``weights.load_npz`` and ``weights.from_jax_params``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import weights
from ..config import ModelConfig


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_params(path: str | Path, state_dict: dict, mc: ModelConfig) -> None:
    """Write a ``Codec`` state dict (``model.codec.state_dict()``) as JAX's
    ``.npz`` param checkpoint."""
    np.savez_compressed(path, **_flatten(weights.to_jax_params(state_dict, mc)))


def load_params(path: str | Path, mc: ModelConfig) -> dict[str, torch.Tensor]:
    """A JAX ``.npz`` param checkpoint -> the port's ``Codec`` state dict
    (CPU tensors, for ``L3AC.load_state_dict``)."""
    return weights.from_jax_params(weights.load_npz(path), mc)
