"""Param checkpoints: single-file ``.npz`` in the JAX package's format
(``l3ac_tpu/runtime/checkpoint.py``), and the port's sharded checkpoints.

JAX param-tree paths flattened to ``a/b/[2]/w`` keys (list indices
bracketed), JAX layouts, no bias caches: a file either package writes loads
in the other. ``save_params`` writes the port's ``Codec`` state dict through
``weights.to_jax_params``; ``load_params`` reads it back through
``weights.load_npz`` and ``weights.from_jax_params``.

Sharded checkpoints (``save_sharded`` / ``load_sharded``, JAX's at
``l3ac_tpu/runtime/checkpoint.py:74-111``). orbax is not on the card, so the
format is the port's own::

    path/index.json       every key: its global shape (JAX layout), dtype,
                          split axis there (or null) and groups; the tp size
                          it was written at; the model config; the caller's
                          meta
    path/shard_<i>.npz    tp shard i of every split key under JAX's flat key
                          names and layouts; replicated keys in shard_0 only

Each tp shard is written once, by the rank at dp = sp = 0 of its tp
coordinate; rank 0 writes the index after a barrier. The directory is
written under a temporary name and renamed when complete, so a save cut
short leaves no ``path``. ``load_sharded`` restores onto any tp: each rank
reads, key by key, only the source shards that overlap its slice (an
``.npz`` loads its arrays one at a time), as orbax's ``shardings=`` does.
Optimizer moments in the state dict's layout go into the same files under
``<moment>/`` prefixes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
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



FORMAT = "l3ac_tpu_torch.sharded/1"


def jax_key(name: str) -> str:
    """A port state-dict name -> JAX's flat key (``a/[0]/b/w``)."""
    *path, leaf = name.split(".")
    parts = [f"[{p}]" if p.isdigit() else p for p in path]
    return "/".join(parts + [weights._JAX_LEAF_NAMES.get(leaf, leaf)])


def port_key(key: str) -> str:
    """The inverse of :func:`jax_key`."""
    *path, leaf = key.split("/")
    parts = [p[1:-1] if p.startswith("[") else p for p in path]
    return ".".join(parts + [weights._LEAF_NAMES.get(leaf, leaf)])


def _jax_axis(spec, ndim: int) -> int | None:
    """A port-layout split axis in JAX's layout (2-D weights are transposed)."""
    if spec is None:
        return None
    return 1 - spec.axis if ndim == 2 else spec.axis


def _jax_shape(name: str, shape) -> list[int]:
    return list(weights._to_jax_layout(name, torch.empty(shape, dtype=torch.float32)).shape)


def _mc_from(d: dict) -> ModelConfig:
    from ..config import VQConfig
    tup = lambda x: {k: tuple(v) if isinstance(v, list) else v for k, v in x.items()}
    rest = {k: v for k, v in d.items() if k != "vq"}
    return ModelConfig(**tup(rest), vq=VQConfig(**tup(d["vq"])))


def save_sharded(path: str | Path, state_dict: dict, mc: ModelConfig, mesh=None, *,
                 moments: dict[str, dict] | None = None, meta: dict | None = None) -> Path:
    """Write this rank's shards of a (possibly tp-sharded) ``Codec`` state
    dict, and of ``moments`` ({"exp_avg": {name: tensor}, ...} in the state
    dict's layout), as a sharded checkpoint at ``path``. Every rank of the
    mesh calls it (one process: ``mesh`` None). ``meta``: JSON values kept
    in the index (the trainer's step)."""
    from ..parallel import distributed, sharding
    path = Path(path)
    tmp = path.with_name(f".{path.name}.partial")
    coords = mesh.coords if mesh is not None else {"dp": 0, "sp": 0, "tp": 0}
    size = mesh.shape["tp"] if mesh is not None else 1
    specs = sharding.full_specs(state_dict, mc, size)
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    distributed.barrier()
    if coords["dp"] == 0 and coords["sp"] == 0:
        arrays = {}
        for prefix, sd in [("", state_dict)] + [(f"{k}/", v) for k, v in (moments or {}).items()]:
            for name, t in sd.items():
                if specs[name] is not None or coords["tp"] == 0:
                    arrays[prefix + jax_key(name)] = weights._to_jax_layout(name, t)
        np.savez(tmp / f"shard_{coords['tp']}.npz", **arrays)
    distributed.barrier()
    if rank0:
        keys = {}
        for name, t in state_dict.items():
            spec = specs[name]
            keys[jax_key(name)] = {
                "shape": _jax_shape(name, sharding.global_shape(t.shape, spec, size)),
                "dtype": str(t.dtype).replace("torch.", ""),
                "axis": _jax_axis(spec, t.dim()),
                "groups": 1 if spec is None else spec.groups}
        index = {"format": FORMAT, "tp": size, "keys": keys, "mc": dataclasses.asdict(mc),
                 "moments": sorted(moments or {}), "meta": meta or {}}
        (tmp / "index.json").write_text(json.dumps(index, indent=1))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    distributed.barrier()
    return path


class _Reader:
    """The shards of a sharded checkpoint, opened lazily, and the pieces of
    a key's global range along its split axis."""

    def __init__(self, path: Path, index: dict):
        self.path, self.index, self.files = path, index, {}

    def _array(self, shard: int, key: str) -> np.ndarray:
        if shard not in self.files:
            self.files[shard] = np.load(self.path / f"shard_{shard}.npz")
        return self.files[shard][key]

    def range(self, key: str, info: dict, a: int, b: int, axis: int) -> np.ndarray:
        """Global positions [a, b) of ``key`` along ``axis`` (JAX layout)."""
        src_axis = info["axis"]
        if src_axis is None:
            return np.take(self._array(0, key), np.arange(a, b), axis=axis)
        n, groups = self.index["tp"], info["groups"]
        block = info["shape"][src_axis] // groups
        ws = block // n
        pieces = []
        for g in range(groups):
            for s in range(n):
                lo = g * block + s * ws
                x0, x1 = max(a, lo), min(b, lo + ws)
                if x0 < x1:
                    arr = self._array(s, key)
                    off = g * ws - lo
                    pieces.append((x0, np.take(arr, np.arange(x0 + off, x1 + off), axis=axis)))
        return np.concatenate([p for _, p in sorted(pieces, key=lambda t: t[0])], axis=axis)

    def close(self) -> None:
        for f in self.files.values():
            f.close()


def load_sharded(path: str | Path, mc: ModelConfig | None = None, *, mesh=None,
                 with_moments: bool = False):
    """A sharded checkpoint -> the port's ``Codec`` state dict (CPU tensors,
    fp32 values of the stored dtype's, JAX's ``load_params`` contract), whole
    with no ``mesh`` (the gathered dict), else this rank's tp slices at the
    mesh's tp size, whatever tp it was written at. ``mc``: the model config
    (default: the one the index holds). ``with_moments``: (state dict,
    {moment: state dict}, meta)."""
    from ..parallel import sharding
    path = Path(path)
    index = json.loads((path / "index.json").read_text())
    if index.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    mc = _mc_from(index["mc"]) if mc is None else mc
    size = mesh.shape["tp"] if mesh is not None else 1
    rank = mesh.coords["tp"] if mesh is not None else 0
    names = {port_key(k): k for k in index["keys"]}
    with torch.device("meta"):
        full = {n: torch.empty(_port_shape(n, index["keys"][k]["shape"])) for n, k in names.items()}
    specs = sharding.param_specs(full, mc, size)
    reader = _Reader(path, index)
    try:
        def slice_of(name: str, prefix: str = "") -> torch.Tensor:
            key, info = names[name], index["keys"][names[name]]
            spec = specs[name]
            ndim = len(info["shape"])
            if spec is None:
                ax = info["axis"] if info["axis"] is not None else 0
                arr = reader.range(prefix + key, info, 0, info["shape"][ax], ax)
            else:
                ax = _jax_axis(spec, ndim)
                block = info["shape"][ax] // spec.groups
                w = block // size
                arr = np.concatenate([reader.range(prefix + key, info, g * block + rank * w,
                                                   g * block + (rank + 1) * w, ax)
                                      for g in range(spec.groups)], axis=ax)
            return torch.from_numpy(np.array(weights._convert(name, arr), order="C"))

        sd = {n: slice_of(n) for n in names}
        if not with_moments:
            return sd
        moments = {m: {n: slice_of(n, f"{m}/") for n in names} for m in index["moments"]}
        return sd, moments, index["meta"]
    finally:
        reader.close()


def _port_shape(name: str, jax_shape: list[int]) -> tuple[int, ...]:
    s = list(jax_shape)
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_scale":
        return (s[-1],)
    return tuple(reversed(s)) if len(s) in (2, 3) else tuple(s)
