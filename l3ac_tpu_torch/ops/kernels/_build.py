"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded through ``ctypes``. The build runs at first use,
into ``l3ac_tpu_torch/_build/<hash>/``, where the hash covers the sources,
the headers and the flags, so a checkout with nothing built builds
everything on its first kernel call. Nothing is prebuilt or committed.

Exact math only: no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libl3ac_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process did: seconds and the compilers' output
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from l3ac_tpu_torch/csrc at first use")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; raise with the output of
    any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Build the library if this hash has not been built; return its path."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(seconds=0.0, cached=True, path=str(lib_path))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(s),
                         "-o", str(o)] for s, o in zip(_sources(), objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp_lib), *map(str, objs)]])
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(lib_path), log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.l3ac_error_string.argtypes = [ctypes.c_int]
            _lib.l3ac_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().l3ac_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
