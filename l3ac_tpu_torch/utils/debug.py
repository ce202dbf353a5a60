"""Numerics debugging helpers (``l3ac_tpu/utils/debug.py``).

JAX's ``checkify`` float checks and ``jax_debug_nans`` become, in PyTorch: a
wrapper that checks a function's outputs for NaN / Inf and names the one
that is not finite (:func:`checked`), autograd's anomaly mode, which names
the forward operation whose backward made a NaN (:func:`nan_debug`), and a
host-side check over a state dict or any nested structure
(:func:`finite_or_raise`).
"""

from __future__ import annotations

import contextlib
import functools
from collections.abc import Callable, Iterator

import torch


def _leaves(tree, path: str = "") -> Iterator[tuple[str, object]]:
    """(path, leaf) of a nested dict / list / tuple, paths as ``[key]``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _is_finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    if isinstance(leaf, float):
        return leaf == leaf and abs(leaf) != float("inf")
    try:
        import numpy as np
        arr = np.asarray(leaf)
    except Exception:
        return True
    return arr.dtype.kind not in "fc" or bool(np.isfinite(arr).all())


def finite_or_raise(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (a
    tensor, a state dict, or nested dicts / lists / tuples of tensors,
    arrays or floats) that holds a NaN or an Inf."""
    for path, leaf in _leaves(tree):
        if not _is_finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a NaN or Inf in its output raises
    ``FloatingPointError`` naming the output (its position in the returned
    structure), instead of propagating silently. Same signature."""
    label = getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        finite_or_raise(out, f"{label} output")
        return out

    return wrapper


@contextlib.contextmanager
def nan_debug():
    """Autograd's anomaly mode for the scope (slow): a backward that makes a
    NaN raises, naming the forward operation it came from."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
