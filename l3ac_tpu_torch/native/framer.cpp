// Host-side stream framer / continuous-batching feeder (C++).
//
// The TPU wants fixed-shape batches; audio arrives as ragged, unbounded
// streams. This component owns the host-side hot loop: per-stream ring
// buffers, chunk assembly with the reference's 1-hop prefix overlap
// (ChunkData semantics, reference l3ac/codec.py:159-188), and zero-copy
// batch assembly into caller-provided (batch, prefix+chunk) float32 buffers.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment). The Python
// fallback implementation lives in l3ac_tpu/runtime/streaming.py; parity is
// tested in tests/test_native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <vector>

namespace {

struct Stream {
    std::vector<float> buffer;   // pending samples (appended by feed())
    int64_t consumed = 0;        // absolute sample index of buffer start
    int64_t chunk_index = 0;     // next chunk number to emit
    bool finished = false;       // no more feed() calls will arrive
    bool done = false;           // all chunks emitted
};

struct Framer {
    int64_t chunk_len;
    int64_t prefix_len;
    int batch;
    std::vector<Stream> streams;
    std::deque<int> ready;       // round-robin queue of stream ids to poll
};

// number of samples stream needs buffered (relative to chunk start) before
// chunk c can be emitted
inline int64_t chunk_start(const Framer& f, int64_t c) {
    return c == 0 ? 0 : c * f.chunk_len - f.prefix_len;
}
inline int64_t chunk_end(const Framer& f, int64_t c) {
    return (c + 1) * f.chunk_len;
}

}  // namespace

extern "C" {

Framer* framer_create(int64_t chunk_len, int64_t prefix_len, int batch) {
    if (chunk_len <= prefix_len || batch <= 0) return nullptr;
    auto* f = new Framer();
    f->chunk_len = chunk_len;
    f->prefix_len = prefix_len;
    f->batch = batch;
    return f;
}

void framer_destroy(Framer* f) { delete f; }

int framer_add_stream(Framer* f) {
    f->streams.emplace_back();
    int id = static_cast<int>(f->streams.size()) - 1;
    f->ready.push_back(id);
    return id;
}

// append samples to a stream; returns 0 on success
int framer_feed(Framer* f, int stream_id, const float* data, int64_t n) {
    if (stream_id < 0 || stream_id >= (int)f->streams.size()) return -1;
    Stream& s = f->streams[stream_id];
    if (s.finished) return -2;
    s.buffer.insert(s.buffer.end(), data, data + n);
    return 0;
}

int framer_finish_stream(Framer* f, int stream_id) {
    if (stream_id < 0 || stream_id >= (int)f->streams.size()) return -1;
    f->streams[stream_id].finished = true;
    return 0;
}

// Assemble up to `batch` chunk rows into out (batch x (prefix+chunk) floats,
// zero-filled). Row r gets stream stream_ids[r], chunk number chunk_ids[r],
// with row_valid[r] = number of valid samples in that row (tail chunks are
// shorter). Returns the number of rows filled.
int framer_next_batch(Framer* f, float* out, int* stream_ids,
                      int64_t* chunk_ids, int64_t* row_valid) {
    const int64_t row_len = f->prefix_len + f->chunk_len;
    int rows = 0;
    std::memset(out, 0, sizeof(float) * row_len * f->batch);
    size_t polled = 0, total = f->ready.size();
    while (rows < f->batch && polled < total) {
        int id = f->ready.front();
        f->ready.pop_front();
        polled++;
        Stream& s = f->streams[id];
        if (s.done) continue;
        const int64_t c = s.chunk_index;
        const int64_t start = chunk_start(*f, c);
        const int64_t end = chunk_end(*f, c);
        const int64_t have = s.consumed + (int64_t)s.buffer.size();
        const bool full = have >= end;
        // a tail chunk must contain NEW content (past c*chunk_len) — a
        // prefix-only remainder is not a chunk (ChunkData semantics: an
        // exact-multiple stream has exactly len/chunk_len chunks)
        const bool tail = s.finished && have > c * f->chunk_len && have < end;
        if (full || tail) {
            const int64_t seg_end = full ? end : have;
            const int64_t seg_len = seg_end - start;
            const float* src = s.buffer.data() + (start - s.consumed);
            std::memcpy(out + (int64_t)rows * row_len, src,
                        sizeof(float) * seg_len);
            stream_ids[rows] = id;
            chunk_ids[rows] = c;
            row_valid[rows] = seg_len;
            rows++;
            s.chunk_index++;
            // drop samples no longer needed (keep prefix for the next chunk);
            // after a tail chunk next_start can exceed what is buffered
            const int64_t next_start = chunk_start(*f, s.chunk_index);
            if (next_start > s.consumed) {
                const int64_t drop = std::min<int64_t>(
                    next_start - s.consumed, (int64_t)s.buffer.size());
                s.buffer.erase(s.buffer.begin(), s.buffer.begin() + drop);
                s.consumed += drop;
            }
            if (s.finished &&
                s.consumed + (int64_t)s.buffer.size() <=
                    s.chunk_index * f->chunk_len) {
                s.done = true;  // remaining samples are prefix-only: no new content
            } else {
                f->ready.push_back(id);
            }
        } else if (!s.finished) {
            f->ready.push_back(id);  // waiting for more samples
        } else {
            s.done = true;           // finished with nothing left to emit
        }
    }
    return rows;
}

// count of chunk rows ready to emit RIGHT NOW across all streams — the same
// contract as PyFramer.pending() (l3ac_tpu/runtime/scheduler.py). Counting
// live streams instead (the round-2 bug) made the scheduler's _pick_lane
// prefer a lane of idle, unfed streams over a lane with finished work, so
// drain() returned early with unprocessed chunks.
int framer_pending(Framer* f) {
    int64_t n = 0;
    for (auto& s : f->streams) {
        if (s.done) continue;
        const int64_t have = s.consumed + (int64_t)s.buffer.size();
        // unfinished streams can only emit full chunks; finished streams also
        // emit a tail chunk for any new content past the last chunk boundary
        const int64_t limit =
            s.finished ? have : (have / f->chunk_len) * f->chunk_len;
        const int64_t base = s.chunk_index * f->chunk_len;
        if (limit > base)
            n += (limit - base + f->chunk_len - 1) / f->chunk_len;
    }
    return static_cast<int>(std::min<int64_t>(n, INT32_MAX));
}

// ---------------------------------------------------------------------------
// State serialization — restartable scheduler state (kill-and-resume must
// reproduce identical batches, so the round-robin queue order is part of the
// state). Little-endian int64 header/fields; float payload as raw IEEE-754.
//
// Layout: magic, version, chunk_len, prefix_len, batch, n_streams,
//         per stream [consumed, chunk_index, finished, done, buf_len,
//                     buf floats...],
//         ready_len, ready ids...

static constexpr int64_t kMagic = 0x4c33414346524d31;  // "L3ACFRM1"
static constexpr int64_t kVersion = 1;

int64_t framer_state_size(Framer* f) {
    int64_t n = 6 * (int64_t)sizeof(int64_t);
    for (auto& s : f->streams)
        n += 5 * (int64_t)sizeof(int64_t) + (int64_t)s.buffer.size() * sizeof(float);
    n += (int64_t)sizeof(int64_t) * (1 + (int64_t)f->ready.size());
    return n;
}

namespace {
inline void put_i64(uint8_t*& p, int64_t v) {
    std::memcpy(p, &v, sizeof(v));
    p += sizeof(v);
}
inline bool get_i64(const uint8_t*& p, const uint8_t* end, int64_t* v) {
    if (p + sizeof(*v) > end) return false;
    std::memcpy(v, p, sizeof(*v));
    p += sizeof(*v);
    return true;
}
}  // namespace

int64_t framer_save_state(Framer* f, uint8_t* buf, int64_t cap) {
    const int64_t need = framer_state_size(f);
    if (cap < need) return -1;
    uint8_t* p = buf;
    put_i64(p, kMagic);
    put_i64(p, kVersion);
    put_i64(p, f->chunk_len);
    put_i64(p, f->prefix_len);
    put_i64(p, f->batch);
    put_i64(p, (int64_t)f->streams.size());
    for (auto& s : f->streams) {
        put_i64(p, s.consumed);
        put_i64(p, s.chunk_index);
        put_i64(p, s.finished ? 1 : 0);
        put_i64(p, s.done ? 1 : 0);
        put_i64(p, (int64_t)s.buffer.size());
        const int64_t nb = (int64_t)s.buffer.size() * sizeof(float);
        std::memcpy(p, s.buffer.data(), nb);
        p += nb;
    }
    put_i64(p, (int64_t)f->ready.size());
    for (int id : f->ready) put_i64(p, id);
    return p - buf;
}

int framer_restore_state(Framer* f, const uint8_t* buf, int64_t n) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int64_t magic, version, chunk_len, prefix_len, batch, n_streams;
    if (!get_i64(p, end, &magic) || magic != kMagic) return -1;
    if (!get_i64(p, end, &version) || version != kVersion) return -2;
    if (!get_i64(p, end, &chunk_len) || !get_i64(p, end, &prefix_len) ||
        !get_i64(p, end, &batch))
        return -3;
    if (chunk_len != f->chunk_len || prefix_len != f->prefix_len ||
        batch != f->batch)
        return -4;  // state from a differently-configured framer
    if (!get_i64(p, end, &n_streams) || n_streams < 0) return -3;
    std::vector<Stream> streams((size_t)n_streams);
    for (auto& s : streams) {
        int64_t finished, done, buf_len;
        if (!get_i64(p, end, &s.consumed) || !get_i64(p, end, &s.chunk_index) ||
            !get_i64(p, end, &finished) || !get_i64(p, end, &done) ||
            !get_i64(p, end, &buf_len) || buf_len < 0)
            return -3;
        const int64_t nb = buf_len * (int64_t)sizeof(float);
        if (p + nb > end) return -3;
        s.buffer.resize((size_t)buf_len);
        std::memcpy(s.buffer.data(), p, nb);
        p += nb;
        s.finished = finished != 0;
        s.done = done != 0;
    }
    int64_t ready_len;
    if (!get_i64(p, end, &ready_len) || ready_len < 0) return -3;
    std::deque<int> ready;
    for (int64_t i = 0; i < ready_len; i++) {
        int64_t id;
        if (!get_i64(p, end, &id) || id < 0 || id >= n_streams) return -3;
        ready.push_back((int)id);
    }
    f->streams = std::move(streams);
    f->ready = std::move(ready);
    return 0;
}

}  // extern "C"
