"""Chunked streaming helper (reference ``ChunkData``, ``l3ac/codec.py:159-188``).

A copy of ``l3ac_tpu/runtime/chunk.py`` (numpy only; the port imports
nothing of the JAX package). Splits a sequence into chunks of ``chunk_len``
with ``prefix_len`` overlap carried from the previous chunk; reassembly
drops each later chunk's prefix. Operates on arrays along axis 0, with the
reference's exact chunk lengths: first chunk ``chunk_len``, later chunks
``prefix_len + chunk_len`` (shorter at the tail).

:mod:`l3ac_tpu_torch.runtime.streaming` builds the batched fixed-shape
pipeline on top of this.
"""

from __future__ import annotations

import numpy as np


class ChunkData:
    def __init__(self, chunk_len: int, prefix_len: int, original_data=None,
                 chunk_data=None):
        assert chunk_len > prefix_len
        self.chunk_len = chunk_len
        self.prefix_len = prefix_len
        self._original_data = original_data
        self._chunk_data = chunk_data

    @property
    def data(self):
        if self._original_data is not None:
            return self._original_data
        parts = [self._chunk_data[0]]
        parts.extend(x[self.prefix_len:] for x in self._chunk_data[1:])
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    @property
    def chunk_data(self):
        if self._chunk_data is not None:
            return self._chunk_data
        data = self._original_data
        chunks = []
        for i in range(0, len(data), self.chunk_len):
            if i == 0:
                chunks.append(data[: self.chunk_len])
            else:
                chunks.append(data[i - self.prefix_len: i + self.chunk_len])
        return chunks
