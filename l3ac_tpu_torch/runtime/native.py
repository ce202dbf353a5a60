"""ctypes bindings for the C++ stream framer (``l3ac_tpu/runtime/native.py``).

Builds the port's own copy of the framer, ``l3ac_tpu_torch/native/framer.cpp``
(byte-identical to the JAX package's ``native/framer.cpp``), with g++ into
``l3ac_tpu_torch/_build/framer-<hash>/libframer.so`` at first use, under a
file lock, where the hash covers the source and the flags. :class:`NativeFramer`
is the host-side hot loop of the streaming runtime: per-stream buffering,
chunk assembly with the ``ChunkData`` overlap, zero-copy fixed-shape batch
filling, and its restartable state (``save_state`` / ``restore_state``).

``available()`` reports whether the framer builds and loads; constructing a
``NativeFramer`` raises, with the compiler's output, when it does not.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "framer.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Build the framer library if this hash has not been built; return its
    path. Concurrent builders wait on one lock file; the library appears by
    an atomic rename."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native framer source {SOURCE} not found")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"framer-{h}"
    lib_path = out_dir / "libframer.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            try:
                res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"native framer build failed:\n{res.stdout}{res.stderr}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.framer_create.restype = ctypes.c_void_p
        lib.framer_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.framer_destroy.argtypes = [ctypes.c_void_p]
        lib.framer_add_stream.restype = ctypes.c_int
        lib.framer_add_stream.argtypes = [ctypes.c_void_p]
        lib.framer_feed.restype = ctypes.c_int
        lib.framer_feed.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.framer_finish_stream.restype = ctypes.c_int
        lib.framer_finish_stream.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.framer_next_batch.restype = ctypes.c_int
        lib.framer_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.framer_pending.restype = ctypes.c_int
        lib.framer_pending.argtypes = [ctypes.c_void_p]
        lib.framer_state_size.restype = ctypes.c_int64
        lib.framer_state_size.argtypes = [ctypes.c_void_p]
        lib.framer_save_state.restype = ctypes.c_int64
        lib.framer_save_state.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_int64]
        lib.framer_restore_state.restype = ctypes.c_int
        lib.framer_restore_state.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                             ctypes.c_int64]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


class NativeFramer:
    """Continuous-batching chunk feeder backed by the C++ framer."""

    def __init__(self, chunk_len: int, prefix_len: int, batch: int):
        self._lib = _load()
        self._h = self._lib.framer_create(chunk_len, prefix_len, batch)
        if not self._h:
            raise ValueError("invalid framer parameters")
        self.chunk_len = chunk_len
        self.prefix_len = prefix_len
        self.batch = batch
        self.row_len = chunk_len + prefix_len

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.framer_destroy(self._h)
            self._h = None

    def add_stream(self) -> int:
        return self._lib.framer_add_stream(self._h)

    def feed(self, stream_id: int, samples: np.ndarray) -> None:
        samples = np.ascontiguousarray(samples, np.float32)
        rc = self._lib.framer_feed(
            self._h, stream_id, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            samples.size)
        if rc != 0:
            raise ValueError(f"feed failed: {rc}")

    def finish(self, stream_id: int) -> None:
        self._lib.framer_finish_stream(self._h, stream_id)

    def next_batch(self):
        """Returns (rows, batch_array (B, row_len) f32, stream_ids, chunk_ids,
        valid_lens); rows == 0 when nothing is ready."""
        out = np.zeros((self.batch, self.row_len), np.float32)
        sids = np.zeros(self.batch, np.int32)
        cids = np.zeros(self.batch, np.int64)
        valid = np.zeros(self.batch, np.int64)
        rows = self._lib.framer_next_batch(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            sids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return rows, out, sids, cids, valid

    def pending(self) -> int:
        return self._lib.framer_pending(self._h)

    # -- restartable state (kill-and-resume; framer.cpp's state layout) ----
    def save_state(self) -> bytes:
        """Serialize all framer state (stream buffers, chunk cursors, the
        ready queue) so that a restored framer reproduces the same batches."""
        n = self._lib.framer_state_size(self._h)
        buf = np.zeros(n, np.uint8)
        wrote = self._lib.framer_save_state(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        if wrote != n:
            raise RuntimeError(f"framer_save_state wrote {wrote}, expected {n}")
        return buf.tobytes()

    def restore_state(self, data: bytes) -> None:
        """Restore :meth:`save_state`'s bytes into this framer, which must
        have the same chunk_len / prefix_len / batch; raises ``ValueError``
        on a blob it cannot read or from another geometry."""
        buf = np.frombuffer(data, np.uint8)
        rc = self._lib.framer_restore_state(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)
        if rc != 0:
            raise ValueError(f"framer_restore_state failed: {rc}")
