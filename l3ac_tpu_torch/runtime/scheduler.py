"""Mixed-config continuous-batching server (``l3ac_tpu/runtime/scheduler.py``).

Serves encode and decode streams of different lengths and different
checkpoints (e.g. 1kbps and 3kbps) at once: three lanes per config (encode,
decode from indices, decode from features), each with its own framer, and
one shared host loop. Streams arrive (``submit`` / ``submit_decode`` /
``feed``) and depart (``tokens`` / ``audio``) at any time; a device step
packs up to ``batch_size`` ready chunk rows of one lane, so chunks of
different streams and different chunk positions share a call (continuous
batching), and a late stream's first chunk rides beside an old stream's
tenth. ``drain`` packs every ready row of every lane into waves of a few
programs each.

Rows are grouped by their valid length: full chunks share two shapes (a
first chunk, ``chunk_len``; a later one, ``chunk_len`` plus its one-hop
prefix) and each first or tail chunk runs at its own length. A group is
padded with zero *rows* to a palette size, never with zero samples. So
encode tokens equal ``L3AC.extract_unit``'s, which the JAX server's do not
where it pads an encode row with zero samples (ROADMAP C), and decode audio
equals ``StreamCodec``'s.

Every lane runs on its model's device (CUDA unless the caller built the
models on the CPU) in the model's dtype. Rows are assembled on the host (the
C++ framer of ``runtime.native``, or :class:`PyFramer` of the same
semantics), cast to bf16 there for a bf16 model, and uploaded from pinned
memory without blocking. Results stay on the device until they are
collected; then same-shape results are stacked on the device and each stack
is copied into pinned host memory, with one synchronize for all of them.

Data-parallel serving (``mesh=`` / ``dp_axis=``, ``l3ac_tpu/runtime/
scheduler.py:262-289,678-694``): a ``parallel.mesh`` mesh over
``torch.distributed`` whose ``dp_axis`` has dp ranks. Every rank runs the
same host loop in lockstep, with the same submissions and the same models
(replicated), and a step packs ``rows_per_step = batch_size * dp`` rows.
Each program's rows (a palette size, so a multiple of dp; padded with zero
rows, which keeps the grouping by valid length, so tokens still equal
``extract_unit``'s) are cut into dp equal slices and each rank runs its
own. Results are all-gathered over dp once per stacked shape group at
collection (JAX's one ``process_allgather`` per group; an exact all-reduce
of an int32 buffer, ``parallel.comm.gather_raw``), so every rank's framers
see every row. ``save_state`` / ``restore_state`` work as on one device,
into a server over the same mesh.
"""

from __future__ import annotations

import io
import json
import math
import struct
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel import comm


class PyFramer:
    """Python framer with the C++ framer's API and semantics: per-stream
    buffering, ``ChunkData`` one-prefix overlap rows, round-robin continuous
    batch filling (``native/framer.cpp``)."""

    def __init__(self, chunk_len: int, prefix_len: int, batch: int):
        self.chunk_len = chunk_len
        self.prefix_len = prefix_len
        self.batch = batch
        self.row_len = chunk_len + prefix_len
        self._streams: list[dict] = []
        self._rr = 0  # round-robin cursor

    def add_stream(self) -> int:
        self._streams.append({"buf": np.zeros(0, np.float32), "consumed": 0,
                              "next_chunk": 0, "finished": False, "done": False})
        return len(self._streams) - 1

    def feed(self, sid: int, samples: np.ndarray) -> None:
        s = self._streams[sid]
        if s["finished"]:
            raise ValueError(f"stream {sid} is finished")
        s["buf"] = np.concatenate([s["buf"], np.asarray(samples, np.float32).reshape(-1)])

    def finish(self, sid: int) -> None:
        s = self._streams[sid]
        s["finished"] = True
        if s["consumed"] + len(s["buf"]) <= s["next_chunk"] * self.chunk_len:
            s["done"] = True

    @staticmethod
    def _have(s: dict) -> int:
        """Samples ever fed (consumed and still buffered)."""
        return s["consumed"] + len(s["buf"])

    def _ready_chunk(self, s: dict) -> bool:
        if s["done"]:
            return False
        have = self._have(s)
        end = (s["next_chunk"] + 1) * self.chunk_len
        return have >= end or (s["finished"] and have > s["next_chunk"] * self.chunk_len)

    def pending(self) -> int:
        """Chunk rows ready to emit now (the C++ ``framer_pending``)."""
        n = 0
        for s in self._streams:
            if s["done"]:
                continue
            have = self._have(s)
            limit = have if s["finished"] else have // self.chunk_len * self.chunk_len
            n += max(0, math.ceil((limit - s["next_chunk"] * self.chunk_len) / self.chunk_len))
        return n

    def next_batch(self):
        """Returns (rows, batch (B, row_len) f32, stream ids, chunk ids,
        valid lengths); rows == 0 when nothing is ready. Each row holds its
        segment left-aligned, zeros after its valid length."""
        out = np.zeros((self.batch, self.row_len), np.float32)
        sids = np.zeros(self.batch, np.int32)
        cids = np.zeros(self.batch, np.int64)
        valid = np.zeros(self.batch, np.int64)
        rows = 0
        n = len(self._streams)
        scanned = 0
        while rows < self.batch and scanned < n:
            sid = (self._rr + scanned) % n
            s = self._streams[sid]
            if self._ready_chunk(s):
                c = s["next_chunk"]
                start = c * self.chunk_len
                lo = max(0, start - self.prefix_len)
                seg = s["buf"][lo - s["consumed"]:start + self.chunk_len - s["consumed"]]
                out[rows, :len(seg)] = seg
                sids[rows] = sid
                cids[rows] = c
                valid[rows] = len(seg)
                s["next_chunk"] += 1
                # drop samples no longer needed (keep the next chunk's prefix),
                # so that a long-lived stream's buffer stays bounded
                next_lo = max(0, s["next_chunk"] * self.chunk_len - self.prefix_len)
                if next_lo > s["consumed"]:
                    drop = min(next_lo - s["consumed"], len(s["buf"]))
                    s["buf"] = s["buf"][drop:]
                    s["consumed"] += drop
                if s["finished"] and s["next_chunk"] * self.chunk_len >= self._have(s):
                    s["done"] = True
                rows += 1
            else:
                scanned += 1
        self._rr = (self._rr + 1) % max(1, n)
        return rows, out, sids, cids, valid

    # -- restartable state (the contract of NativeFramer.save_state) -------
    _STATE_MAGIC = b"L3ACFRP1"

    def save_state(self) -> bytes:
        """Serialize all framer state (buffers, chunk cursors, the round-robin
        cursor) so that a restored framer reproduces the same batches."""
        parts = [self._STATE_MAGIC,
                 struct.pack("<5q", self.chunk_len, self.prefix_len, self.batch, self._rr,
                             len(self._streams))]
        for s in self._streams:
            parts.append(struct.pack("<5q", s["consumed"], s["next_chunk"], int(s["finished"]),
                                     int(s["done"]), len(s["buf"])))
            parts.append(np.asarray(s["buf"], np.float32).tobytes())
        return b"".join(parts)

    def restore_state(self, data: bytes) -> None:
        if data[:8] != self._STATE_MAGIC:
            raise ValueError("not a PyFramer state blob")
        ofs = 8
        chunk_len, prefix_len, batch, rr, n = struct.unpack_from("<5q", data, ofs)
        ofs += 40
        if (chunk_len, prefix_len, batch) != (self.chunk_len, self.prefix_len, self.batch):
            raise ValueError("state from a differently-configured framer")
        streams = []
        for _ in range(n):
            consumed, next_chunk, finished, done, blen = struct.unpack_from("<5q", data, ofs)
            ofs += 40
            buf = np.frombuffer(data, np.float32, count=blen, offset=ofs).copy()
            ofs += blen * 4
            streams.append({"buf": buf, "consumed": consumed, "next_chunk": next_chunk,
                            "finished": bool(finished), "done": bool(done)})
        self._streams = streams
        self._rr = rr


def _make_framer(chunk_len: int, prefix_len: int, batch: int, use_native: bool | None):
    """The C++ framer when ``use_native`` (raises when it cannot be built),
    :class:`PyFramer` when False, the C++ one if it builds when None."""
    from . import native
    if use_native is None:
        use_native = native.available()
    if use_native:
        return native.NativeFramer(chunk_len, prefix_len, batch)
    return PyFramer(chunk_len, prefix_len, batch)


@dataclass
class _Lane:
    """One (config, direction): its framer, its device call and its streams.

    ``kind``: ``"enc"`` (audio -> FSQ indices), ``"dec_idx"`` (indices ->
    audio), ``"dec_feat"`` (quantized features -> audio). The decode lanes
    ride the same float32 framer as encode: FSQ indices are exact in float32
    (every released codebook < 2^24) and (T, C) features flatten row-major
    on a C-multiple chunk grid, so chunk boundaries fall on whole frames.
    """
    model: object
    framer: object
    hop: int
    kind: str
    width: int = 1                                  # flattened units per token
    tok_prefix: int = 1
    handles: dict = field(default_factory=dict)     # framer sid -> handle
    run: object = None                              # device rows -> device result
    last_served: int = 0                            # for lane aging
    in_cast: torch.dtype | None = None              # host-side cast before the upload


@dataclass
class _Stream:
    lane: str                                       # lane key "config:kind"
    sid: int                                        # framer-local stream id
    out: dict = field(default_factory=dict)         # chunk id -> tokens / audio
    fed: int = 0                                    # units fed (samples / tokens)
    expected_chunks: int | None = None              # known after finish()
    padded_len: int = 0
    length: int | None = None                       # decode: output crop

    @property
    def done(self) -> bool:
        return self.expected_chunks is not None and len(self.out) == self.expected_chunks


def _encoder(model):
    @torch.inference_mode()
    def run(x: torch.Tensor) -> torch.Tensor:
        return model.codec.encode(x.to(model.dtype))[1]
    return run


def _decoder(model, by_indices: bool, pcm16: bool):
    @torch.inference_mode()
    def run(x: torch.Tensor) -> torch.Tensor:
        audio = (model.codec.decode_indices(x) if by_indices
                 else model.codec.decode(x.to(model.dtype)))
        if pcm16:
            # upcast before the scale: bf16's 8-bit mantissa would swamp the
            # 16-bit grid
            audio = torch.round(audio.float() * 32767.0).to(torch.int16)
        return audio
    return run


class CodecServer:
    """Continuous-batching encode and decode server over several configs.

    ``models``: {name: ``models.zoo.L3AC``}. Three lanes per config (encode,
    decode from indices, decode from features), each with its own framer;
    one host loop packs up to ``batch_size`` ready chunk rows of one lane per
    step. The chunk is ``chunk_seconds`` rounded down to a hop multiple, plus
    a one-hop prefix (``ChunkData``; the reference serves both directions at
    ``l3ac/codec.py:113-156``).

    Rows run at their exact valid length: full chunks share two shapes, each
    first or tail chunk has its own (the encoder's convs look ahead and the
    decoder's InstanceNorm is global over time, so zero samples would change
    the chunk). A length's rows are padded with zero rows to ``batch_size *
    2^k`` (k <= ``MAX_WAVE_LOG2``), which bounds the shapes a lane sees.

    ``pcm16_output``: decode lanes emit int16 PCM from the device
    (``round(x * 32767)`` of the fp32 audio) instead of the model's dtype,
    halving the result bytes of an fp32 model; :meth:`audio` returns
    float32 all the same (/ 32767). ``stats`` counts device calls
    (``programs``: model calls and result stacks) and result copies
    (``fetches``), and sums the seconds of each drain phase: host row
    assembly (``t_assemble``), the host cast and upload (``t_upload``), the
    model call (``t_dispatch``: host time until it returns, which is device
    time too wherever the model path waits for the device), the result
    copies and their synchronize (``t_fetch``), the host scatter
    (``t_scatter``) and the framers' row gathering (``t_gather``).
    """

    #: the wave drain's palette: programs run at ``batch_size * 2^k`` rows,
    #: k = 0..MAX_WAVE_LOG2
    MAX_WAVE_LOG2 = 3

    def __init__(self, models: dict, *, chunk_seconds: float = 5.0, batch_size: int = 8,
                 use_native: bool | None = None, aging_steps: int = 8, mesh=None,
                 dp_axis: str = "dp", pcm16_output: bool = False):
        """``mesh``: a ``parallel.mesh`` mesh with a ``dp_axis``: data-parallel
        serving (the module's notes); every rank constructs the server and
        calls it alike."""
        self.pcm16_output = pcm16_output
        self.batch_size = batch_size
        self.mesh = mesh
        self._dp = mesh.shape[dp_axis] if mesh is not None else 1
        self._dp_index = mesh.coords[dp_axis] if mesh is not None else 0
        self._dp_group = mesh.group(dp_axis) if mesh is not None else None
        self._dp_axis = dp_axis
        self.rows_per_step = batch_size * self._dp
        self.aging_steps = aging_steps
        self.use_native = use_native
        self.lanes: dict[str, _Lane] = {}
        self.streams: dict[int, _Stream] = {}
        self.stats = {"programs": 0, "fetches": 0, "t_assemble": 0.0, "t_upload": 0.0,
                      "t_dispatch": 0.0, "t_fetch": 0.0, "t_scatter": 0.0, "t_gather": 0.0}
        self._next_handle = 0
        self._steps = 0
        self._inflight: list = []      # dispatched, not yet collected results
        self._chunk_seconds = chunk_seconds
        for name, model in models.items():
            mc = model.mc
            hop = mc.hop_length
            sr = model.config.sample_rate
            chunk_len = max(hop, int(chunk_seconds * sr) // hop * hop)
            tok_chunk = chunk_len // hop
            if tok_chunk < 2:
                raise ValueError(
                    f"{name}: chunk_seconds={chunk_seconds} gives a {tok_chunk}-token chunk; "
                    f"decode lanes need >= 2 tokens per chunk (hop {hop} @ {sr} Hz)")
            C = mc.feature_dim
            # serve in the model's dtype; a bf16 model's audio and feature
            # rows are rounded to bf16 on the host, as the device would round
            # them, which halves their upload
            host_cast = torch.bfloat16 if model.dtype == torch.bfloat16 else None

            def framer(n, prefix):
                return _make_framer(n, prefix, self.rows_per_step, use_native)

            self.lanes[f"{name}:enc"] = _Lane(
                model=model, framer=framer(chunk_len, hop), hop=hop, kind="enc",
                run=_encoder(model), in_cast=host_cast)
            self.lanes[f"{name}:dec_idx"] = _Lane(
                model=model, framer=framer(tok_chunk, 1), hop=hop, kind="dec_idx",
                run=_decoder(model, True, pcm16_output))
            self.lanes[f"{name}:dec_feat"] = _Lane(
                model=model, framer=framer(tok_chunk * C, C), hop=hop, kind="dec_feat",
                width=C, run=_decoder(model, False, pcm16_output), in_cast=host_cast)

    # -- stream lifecycle -------------------------------------------------
    def _new_stream(self, lane_key: str, length: int | None = None) -> int:
        lane = self.lanes[lane_key]
        sid = lane.framer.add_stream()
        handle = self._next_handle
        self._next_handle += 1
        self.streams[handle] = _Stream(lane=lane_key, sid=sid, length=length)
        lane.handles[sid] = handle
        return handle

    def submit(self, config: str, audio: np.ndarray | None = None) -> int:
        """Register an encode stream on ``config``; with ``audio``, feed and
        finish it at once. Returns a handle for :meth:`tokens`."""
        handle = self._new_stream(f"{config}:enc")
        if audio is not None:
            self.feed(handle, audio)
            self.finish(handle)
        return handle

    def submit_decode(self, config: str, *, indices: np.ndarray | None = None,
                      features: np.ndarray | None = None, length: int | None = None) -> int:
        """Register a decode stream on ``config`` (reference ``decompress`` /
        ``decode_unit``, ``l3ac/codec.py:118-122,149-156``) of FSQ indices
        or of (T, C) quantized features, one source per stream; ``length``
        crops the audio. Returns a handle for :meth:`audio`."""
        if (indices is None) == (features is None):
            raise ValueError("pass exactly one of indices / features")
        kind = "dec_idx" if features is None else "dec_feat"
        handle = self._new_stream(f"{config}:{kind}", length=length)
        data = indices if features is None else features
        if data is not None:
            self.feed(handle, data)
            self.finish(handle)
        return handle

    def feed(self, handle: int, data: np.ndarray) -> None:
        """Append stream content: audio samples (encode), indices (dec_idx)
        or (T, C) features (dec_feat)."""
        st = self.streams[handle]
        lane = self.lanes[st.lane]
        if lane.kind == "dec_feat":
            data = np.asarray(data, np.float32)
            if data.ndim != 2 or data.shape[1] != lane.width:
                raise ValueError(f"features must be (T, {lane.width}), got {data.shape}")
            st.fed += data.shape[0]
            lane.framer.feed(st.sid, data.reshape(-1))
        else:
            # indices are exact in float32 (every released codebook < 2^24)
            data = np.asarray(data).reshape(-1).astype(np.float32)
            st.fed += len(data)
            lane.framer.feed(st.sid, data)

    def finish(self, handle: int) -> None:
        """No more content will arrive. An encode stream is right-padded to
        a hop multiple (reference preprocess, ``l3ac/codec.py:79-84``); a
        decode stream's token grid is exact."""
        st = self.streams[handle]
        if st.fed == 0:
            raise ValueError("cannot finish an empty stream")
        lane = self.lanes[st.lane]
        if lane.kind == "enc":
            pad = math.ceil(st.fed / lane.hop) * lane.hop - st.fed
            if pad:
                lane.framer.feed(st.sid, np.zeros(pad, np.float32))
            st.padded_len = st.fed + pad
        else:
            st.padded_len = st.fed * lane.width
        lane.framer.finish(st.sid)
        st.expected_chunks = max(1, math.ceil(st.padded_len / lane.framer.chunk_len))

    # -- scheduling -------------------------------------------------------
    def _pick_lane(self) -> str | None:
        """The lane with the most ready rows (keeps batches full), unless a
        ready lane has gone ``aging_steps`` steps unserved: the longest
        waiting such lane wins, so that load on one lane starves no other."""
        ready = [(name, lane.framer.pending()) for name, lane in self.lanes.items()]
        ready = [(name, n) for name, n in ready if n > 0]
        if not ready:
            return None
        starved = [name for name, _ in ready
                   if self._steps - self.lanes[name].last_served >= self.aging_steps]
        if starved:
            return min(starved, key=lambda n: self.lanes[n].last_served)
        return max(ready, key=lambda x: x[1])[0]

    def step(self) -> bool:
        """Run one batch of the chosen lane (one program per valid length
        in it). Returns False when no work is ready anywhere."""
        name = self._pick_lane()
        if name is None:
            return False
        lane = self.lanes[name]
        rows, out, sids, cids, valid = lane.framer.next_batch()
        if rows == 0:
            return False
        self._steps += 1
        lane.last_served = self._steps
        self._dispatch(lane, rows, out, sids, cids, valid)
        return True

    def _upload(self, lane: _Lane, x: np.ndarray) -> torch.Tensor:
        """Host rows -> the lane's device, cast to ``in_cast`` on the host;
        to CUDA through pinned memory without blocking."""
        t = torch.from_numpy(x)
        dtype = lane.in_cast or t.dtype
        device = lane.model.device
        if device.type != "cuda":
            return t.to(dtype)
        host = torch.empty(t.shape, dtype=dtype, pin_memory=True)
        host.copy_(t)
        return host.to(device, non_blocking=True)

    def _dispatch(self, lane: _Lane, rows: int, out, sids, cids, valid) -> None:
        """Run ``rows`` framer rows of one lane: grouped by valid length,
        each group in palette-size programs padded with zero rows. Results
        stay on the device (pad rows of audio sliced off as a view) until
        :meth:`_collect`."""
        buckets: dict[int, list[int]] = {}
        for r in range(rows):
            buckets.setdefault(int(valid[r]), []).append(r)
        for v, rs in buckets.items():
            start = 0
            for P in self._wave_sizes(len(rs)):
                t0 = time.perf_counter()
                sel = np.asarray(rs[start:start + P])
                n = len(sel)
                x = np.zeros((P, v), np.int32 if lane.kind == "dec_idx" else np.float32)
                x[:n] = out[sel, :v]
                if lane.kind == "dec_feat":
                    x = x.reshape(P, v // lane.width, lane.width)
                if self._dp > 1:  # this rank's slice; the rows come back at collection
                    share = P // self._dp
                    x = x[self._dp_index * share:(self._dp_index + 1) * share]
                t1 = time.perf_counter()
                xd = self._upload(lane, x)
                t2 = time.perf_counter()
                res = lane.run(xd)
                t3 = time.perf_counter()
                self.stats["t_assemble"] += t1 - t0
                self.stats["t_upload"] += t2 - t1
                self.stats["t_dispatch"] += t3 - t2
                self.stats["programs"] += 1
                if lane.kind != "enc" and n < P and self._dp == 1:
                    # tokens are small and keep one shape per length; audio
                    # pad rows are not fetched (with dp the slices are
                    # gathered whole, and the pad rows skipped at the scatter)
                    res = res[:n]
                self._inflight.append((lane, res, sids[sel].copy(), cids[sel].copy(),
                                       valid[sel].copy()))
                start += n

    # -- wave drain: continuous batching at drain granularity -------------
    def _wave_sizes(self, n: int) -> list[int]:
        """Split ``n`` rows into palette program sizes (``rows_per_step *
        2^k``, k <= MAX_WAVE_LOG2), preferring one padded program: a call's
        host cost grows with the number of programs, not with pad rows."""
        cap = self.rows_per_step << self.MAX_WAVE_LOG2
        out = []
        while n > cap:
            out.append(cap)
            n -= cap
        p = self.rows_per_step
        while p < n:
            p <<= 1
        out.append(p)
        return out

    def _gather_ready(self, lane: _Lane):
        """Every chunk row a lane's framer has ready now."""
        outs, sids_l, cids_l, valid_l = [], [], [], []
        total = 0
        while True:
            rows, out, sids, cids, valid = lane.framer.next_batch()
            if rows == 0:
                break
            total += rows
            outs.append(out[:rows])
            sids_l.append(sids[:rows])
            cids_l.append(cids[:rows])
            valid_l.append(valid[:rows])
        if total == 0:
            return 0, None, None, None, None
        return (total, np.concatenate(outs), np.concatenate(sids_l), np.concatenate(cids_l),
                np.concatenate(valid_l))

    def _dispatch_wave(self) -> bool:
        """One wave: every ready row of every lane, each valid length in the
        fewest palette-size programs. Rows are independent in both
        directions (the decoder's InstanceNorm is per row), so the regrouping
        gives :meth:`step`'s results."""
        any_work = False
        for lane in self.lanes.values():
            tg = time.perf_counter()
            rows, out, sids, cids, valid = self._gather_ready(lane)
            self.stats["t_gather"] += time.perf_counter() - tg
            if not rows:
                continue
            any_work = True
            self._steps += 1
            lane.last_served = self._steps
            self._dispatch(lane, rows, out, sids, cids, valid)
        return any_work

    def _fetch_inflight(self) -> list:
        """Host copies of every in-flight result in the fewest transfers:
        same-shape results stacked on the device, one copy of each stack
        into pinned host memory, one synchronize for all. bf16 audio is
        widened to float32 on the host."""
        groups: dict[tuple, list[int]] = {}
        for i, item in enumerate(self._inflight):
            res = item[1]
            groups.setdefault((tuple(res.shape), res.dtype, res.device), []).append(i)
        t0 = time.perf_counter()
        copies, devices = [], set()
        for idxs in groups.values():
            arrs = [self._inflight[i][1] for i in idxs]
            s = arrs[0] if len(arrs) == 1 else torch.stack(arrs)
            self.stats["programs"] += int(len(arrs) > 1)
            if self._dp > 1:  # every rank's slice of each program's rows
                s = torch.cat(comm.gather_raw(s, self._dp_group, self._dp_index, self._dp,
                                              self._dp_axis), dim=int(len(arrs) > 1))
            if s.device.type == "cuda":
                host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                host.copy_(s, non_blocking=True)
                devices.add(s.device)
            else:
                host = s
            copies.append((idxs, host))
        self.stats["fetches"] += len(copies)
        for device in devices:
            torch.cuda.synchronize(device)
        fetched: list = [None] * len(self._inflight)
        for idxs, host in copies:
            # a copy that owns its memory: the pinned block goes back to the
            # allocator for the next upload
            a = host.float().numpy() if host.dtype == torch.bfloat16 else host.numpy().copy()
            for j, i in enumerate(idxs):
                fetched[i] = a if len(idxs) == 1 else a[j]
        self.stats["t_fetch"] += time.perf_counter() - t0
        return fetched

    def _collect(self) -> None:
        """Scatter every dispatched result into its streams."""
        if not self._inflight:
            return
        fetched = self._fetch_inflight()
        t0 = time.perf_counter()
        for arr, (lane, _, sids, cids, valid) in zip(fetched, self._inflight):
            for r in range(len(sids)):
                st = self.streams[lane.handles[int(sids[r])]]
                c = int(cids[r])
                if lane.kind == "enc":
                    a = arr[r][:math.ceil(int(valid[r]) / lane.hop)]
                    st.out[c] = a[lane.tok_prefix:] if c > 0 else a
                else:
                    st.out[c] = arr[r][lane.tok_prefix * lane.hop:] if c > 0 else arr[r]
        self.stats["t_scatter"] += time.perf_counter() - t0
        self._inflight.clear()

    def drain(self) -> None:
        """Process everything ready: waves (:meth:`_dispatch_wave`) until
        none is left, then one stacked fetch of all results."""
        while self._dispatch_wave():
            pass
        self._collect()

    # -- results ----------------------------------------------------------
    def done(self, handle: int) -> bool:
        self._collect()
        return self.streams[handle].done

    def _finished(self, handle: int, encode: bool) -> _Stream:
        self._collect()
        st = self.streams[handle]
        if st.lane.endswith(":enc") != encode:
            raise ValueError(f"{'tokens' if encode else 'audio'}() is for "
                             f"{'encode' if encode else 'decode'} streams")
        if not st.done:
            raise RuntimeError("stream not finished / processed; call drain() or step()")
        return st

    def tokens(self, handle: int) -> np.ndarray:
        st = self._finished(handle, encode=True)
        return np.concatenate([st.out[c] for c in sorted(st.out)])

    def audio(self, handle: int) -> np.ndarray:
        """A decode stream's audio as float32, cropped to its ``length``."""
        st = self._finished(handle, encode=False)
        out = np.concatenate([st.out[c] for c in sorted(st.out)])
        if out.dtype == np.int16:       # pcm16_output lanes
            out = out.astype(np.float32) / 32767.0
        elif out.dtype != np.float32:
            out = out.astype(np.float32)
        return out[:st.length] if st.length is not None else out

    # -- restartable server state -----------------------------------------
    def save_state(self) -> bytes:
        """Serialize all server state (framer buffers, stream bookkeeping,
        the tokens and audio made so far, the scheduling counters) as one
        ``.npz``, so that a server restored over the same models resumes
        mid-flight with the same results."""
        self._collect()                 # in-flight results first
        arrays: dict[str, np.ndarray] = {}
        meta = {"next_handle": self._next_handle, "steps": self._steps,
                "batch_size": self.batch_size, "rows_per_step": self.rows_per_step,
                "chunk_seconds": self._chunk_seconds,
                "lanes": {}, "streams": {}}
        for name, lane in self.lanes.items():
            meta["lanes"][name] = {"last_served": lane.last_served,
                                   "handles": {str(k): v for k, v in lane.handles.items()}}
            arrays[f"framer::{name}"] = np.frombuffer(lane.framer.save_state(), np.uint8)
        for h, st in self.streams.items():
            meta["streams"][str(h)] = {
                "lane": st.lane, "sid": st.sid, "fed": st.fed,
                "expected_chunks": st.expected_chunks, "padded_len": st.padded_len,
                "length": st.length, "chunks": sorted(st.out)}
            for c in st.out:
                arrays[f"out::{h}::{c}"] = st.out[c]
        buf = io.BytesIO()
        np.savez(buf, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
        return buf.getvalue()

    def restore_state(self, data: bytes) -> None:
        """Restore :meth:`save_state`'s bytes into a new server over the same
        models (the same configs, batch and chunk geometry, and framer kind:
        the framers' blobs are their own). Raises ``ValueError`` on other
        lanes or another ``batch_size``."""
        with np.load(io.BytesIO(data)) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            if set(meta["lanes"]) != set(self.lanes):
                raise ValueError(f"lane mismatch: saved {sorted(meta['lanes'])} vs "
                                 f"constructed {sorted(self.lanes)}")
            if meta["batch_size"] != self.batch_size or \
                    meta.get("rows_per_step", self.batch_size) != self.rows_per_step:
                raise ValueError("batch_size mismatch (or another dp)")
            self._next_handle = meta["next_handle"]
            self._steps = meta["steps"]
            for name, lm in meta["lanes"].items():
                lane = self.lanes[name]
                lane.last_served = lm["last_served"]
                lane.handles = {int(k): v for k, v in lm["handles"].items()}
                lane.framer.restore_state(z[f"framer::{name}"].tobytes())
            self.streams = {}
            for hs, sm in meta["streams"].items():
                h = int(hs)
                st = _Stream(lane=sm["lane"], sid=sm["sid"], fed=sm["fed"],
                             expected_chunks=sm["expected_chunks"],
                             padded_len=sm["padded_len"], length=sm["length"])
                st.out = {c: z[f"out::{h}::{c}"] for c in sm["chunks"]}
                self.streams[h] = st
