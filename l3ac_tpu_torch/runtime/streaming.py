"""Batched, fixed-shape streaming (``l3ac_tpu/runtime/streaming.py``): the
batched form of the reference's sequential batch-1 ``ChunkData`` loop
(``l3ac/codec.py:124-156``).

B independent streams go through the codec over fixed-size chunks with a
one-hop prefix (the reference's overlap), so two shapes serve the chunks of
audio of any length and only the tails take shapes of their own. Chunks of
different streams share a call. Batches go to the model's device and tokens
and audio come back as numpy (audio fp32); encode and decode run in the
model's dtype (fp32 or bf16).

Unlike the JAX package's ``StreamCodec``, the encode does not zero-pad a
first or a tail chunk to the full row length: that padding is not
transparent to the encoder (ROADMAP C), and without it the tokens equal
``L3AC.extract_unit``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class StreamCodec:
    """Fixed-shape chunked encode / decode over batches of streams."""

    def __init__(self, model, *, chunk_seconds: float = 5.0, batch_size: int = 8):
        self.model = model
        self.mc = model.mc
        hop = self.mc.hop_length
        sr = model.config.sample_rate
        self.chunk_len = max(hop, int(chunk_seconds * sr) // hop * hop)
        self.prefix_len = hop
        self.batch_size = batch_size
        self.tok_chunk = self.chunk_len // hop
        self.tok_prefix = 1

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.model.device)

    @torch.inference_mode()
    def _encode(self, batch: np.ndarray) -> np.ndarray:
        _, idx = self.model.codec.encode(self._to_device(batch).to(self.model.dtype))
        return idx.cpu().numpy()

    @torch.inference_mode()
    def _decode(self, batch: np.ndarray) -> np.ndarray:
        audio = self.model.codec.decode(self._to_device(batch).to(self.model.dtype))
        return audio.float().cpu().numpy()

    @torch.inference_mode()
    def _decode_idx(self, batch: np.ndarray) -> np.ndarray:
        return self.model.codec.decode_indices(self._to_device(batch)).float().cpu().numpy()

    def _padded(self, audio) -> np.ndarray:
        a = np.asarray(audio, np.float32).reshape(-1)
        hop = self.mc.hop_length
        return np.pad(a, (0, math.ceil(len(a) / hop) * hop - len(a)))

    # -- encode ------------------------------------------------------------
    def encode_streams(self, audios: list[np.ndarray],
                       use_native: bool | None = None) -> list[np.ndarray]:
        """Encode a list of variable-length streams -> per-stream token arrays.

        Streams are cut into ``ChunkData`` segments (a one-hop prefix on
        every chunk but the first), and each segment is encoded at its own
        length: segments of one length share a call, and the two full
        lengths (a first chunk, a later chunk) are padded with zero rows to
        ``batch_size``. Token outputs drop the prefix tokens exactly like
        ``ChunkData`` reassembly, so they equal ``L3AC.extract_unit``'s.

        ``use_native``: assemble the segments in the C++ framer
        (``runtime.native``); True raises when it cannot be built or loaded,
        None uses it when it is available.
        """
        from . import native
        if use_native is None:
            use_native = native.available()
        padded = [self._padded(a) for a in audios]
        if use_native:
            segments = self._segments_native(padded)
        else:
            segments = []
            for i, a in enumerate(padded):
                for c in range(math.ceil(len(a) / self.chunk_len)):
                    start = c * self.chunk_len
                    segments.append((i, c, a[max(0, start - self.prefix_len):
                                              start + self.chunk_len]))
        return self._encode_grouped(segments, len(padded))

    def _segments_native(self, padded: list[np.ndarray]) -> list:
        """The same (stream, chunk, samples) segments, assembled by the C++
        framer: its rows hold each segment left-aligned with its valid
        length."""
        from .native import NativeFramer

        framer = NativeFramer(self.chunk_len, self.prefix_len, self.batch_size)
        sids = {}
        for i, a in enumerate(padded):
            sid = framer.add_stream()
            framer.feed(sid, a)
            framer.finish(sid)
            sids[sid] = i
        segments = []
        while framer.pending():
            rows, batch, row_sids, row_cids, valid = framer.next_batch()
            if rows == 0:
                break
            segments.extend((sids[int(row_sids[r])], int(row_cids[r]), batch[r, :int(valid[r])])
                            for r in range(rows))
        return segments

    def _encode_grouped(self, segments: list, n_streams: int) -> list[np.ndarray]:
        """Encode (stream, chunk, samples) segments grouped by length, in
        (stream, chunk) order within a group, so that both framers make the
        same calls.

        A segment is never padded with zero samples: the encoder's convs
        look ahead and its per-position norms turn a zero column into O(1)
        activations, so trailing zeros can change the last real token."""
        full = (self.chunk_len, self.prefix_len + self.chunk_len)
        groups: dict[int, list] = {}
        for i, c, seg in sorted(segments, key=lambda s: s[:2]):
            groups.setdefault(len(seg), []).append((i, c, seg))
        tokens: list[dict] = [{} for _ in range(n_streams)]
        for seg_len, items in groups.items():
            for ofs in range(0, len(items), self.batch_size):
                batch = items[ofs:ofs + self.batch_size]
                x = np.stack([seg for (_, _, seg) in batch])
                if seg_len in full and len(batch) < self.batch_size:
                    x = np.concatenate(
                        [x, np.zeros((self.batch_size - len(batch), seg_len), np.float32)])
                idx = self._encode(x)
                for r, (i, c, _) in enumerate(batch):
                    tokens[i][c] = idx[r][self.tok_prefix:] if c > 0 else idx[r]
        return [np.concatenate([t[c] for c in sorted(t)]) for t in tokens]

    # -- decode ------------------------------------------------------------
    def decode_streams(self, features: list[np.ndarray],
                       lengths: list[int] | None = None) -> list[np.ndarray]:
        """Decode per-stream feature arrays (T_i, C) back to audio.

        Full interior chunks share one shape, padded with zero rows to
        ``batch_size``. Tail chunks are decoded at their exact token length
        (as the JAX package does): the decoder's EnhanceBlock InstanceNorm is
        global over time, so zero-padding a tail would change the whole
        chunk.
        """
        return self._decode_grouped([np.asarray(f, np.float32) for f in features], lengths,
                                    self._decode)

    def decode_indices_streams(self, indices: list[np.ndarray],
                               lengths: list[int] | None = None) -> list[np.ndarray]:
        """Decode per-stream FSQ index arrays (T_i,) back to audio: the
        token-domain twin of :meth:`decode_streams` (reference
        ``decode_unit``'s indices path)."""
        return self._decode_grouped([np.asarray(i, np.int32) for i in indices], lengths,
                                    self._decode_idx)

    def _decode_grouped(self, arrays: list[np.ndarray], lengths, fn):
        hop = self.mc.hop_length
        tok_in = self.tok_prefix + self.tok_chunk
        n_chunks = [max(1, math.ceil(len(f) / self.tok_chunk)) for f in arrays]
        outs = [[None] * n for n in n_chunks]

        # every (stream, chunk) segment, grouped by its token length
        groups: dict[int, list] = {}
        for i, f in enumerate(arrays):
            for c in range(n_chunks[i]):
                start = c * self.tok_chunk
                lo = max(0, start - self.tok_prefix)
                seg = f[lo:start + self.tok_chunk]
                groups.setdefault(len(seg), []).append((i, c, start - lo, seg))

        for seg_len, items in groups.items():
            for ofs in range(0, len(items), self.batch_size):
                batch = items[ofs:ofs + self.batch_size]
                x = np.stack([seg for (_, _, _, seg) in batch])
                if seg_len == tok_in and len(batch) < self.batch_size:
                    x = np.concatenate(
                        [x, np.zeros((self.batch_size - len(batch), *x.shape[1:]), x.dtype)])
                audio = fn(x)
                for r, (i, c, pre, _) in enumerate(batch):
                    outs[i][c] = audio[r][pre * hop:]

        result = [np.concatenate(o) for o in outs]
        if lengths is not None:
            result = [r[:n] for r, n in zip(result, lengths)]
        return result
