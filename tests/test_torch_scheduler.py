"""The port's ``CodecServer`` (``l3ac_tpu_torch/runtime/scheduler.py``) on the
CPU: against the port's own ``extract_unit`` and ``StreamCodec``, and against
the JAX package's ``CodecServer`` on ``debug``.

Two configs served together: ``debug`` from one seeded checkpoint converted
for both packages, and ``tiny3k``, ``debug`` with the plain transformer
(``en_coder_compress_rate`` 1, hop 12), as in ``tests/test_scheduler.py``.
Tokens are equal; audio within 1e-4 x max(1, max |want|) of the reference
(the tolerance of ``tests/test_torch_stream.py``), and a resumed server's
within rtol 2e-4 / atol 1e-6 of an uninterrupted one (JAX's bounds). The
JAX server runs on ``debug`` only, its lanes on the JAX model's own jitted
functions, so that its compiles are shared.
"""

import functools

import numpy as np
import pytest
import torch

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import zoo as jz
from l3ac_tpu.runtime import convert as jcv
from l3ac_tpu.runtime.scheduler import CodecServer as JaxCodecServer
from l3ac_tpu_torch import profile_serve
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.ops import kernels as K
from l3ac_tpu_torch.runtime import convert, native
from l3ac_tpu_torch.runtime.scheduler import CodecServer, PyFramer
from l3ac_tpu_torch.runtime.streaming import StreamCodec

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CHUNK_SECONDS = 0.1
WINDOW = int(CHUNK_SECONDS * 16000)     # extract_unit's process_window for the same chunks
FRAMERS = [pytest.param(False, id="python"), pytest.param(True, id="native")]


def _close_audio(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX debug, {"debug": port debug, "tiny3k": port tiny3k}), debug's
    weights from one seeded checkpoint."""
    sds = convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=11)
    numpy_sds = {m: {k: v.numpy() for k, v in sd.items()} for m, sd in sds.items()}
    jmodel = jz.L3AC(jax_config("debug"), params=jcv.convert_checkpoint(
        numpy_sds, jax_config("debug").network_config, strict=True))
    dbg = get_model("debug", device="cpu")
    dbg.load_state_dict(convert.convert_checkpoint(
        numpy_sds, get_config("debug").network_config, strict=True))
    tiny3k = get_model("debug", device="cpu", seed=7, network_config={"en_coder_compress_rate": 1})
    return jmodel, {"debug": dbg, "tiny3k": tiny3k}


def _audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 16000)) * 0.3).astype(np.float32)


# (config, audio): ragged lengths, first chunks, interior chunks and tails
STREAMS = [("debug", _audio(0.31, 1)), ("tiny3k", _audio(0.17, 2)), ("debug", _audio(0.52, 3)),
           ("tiny3k", _audio(0.26, 4)), ("debug", _audio(0.08, 5))]


@functools.lru_cache(maxsize=None)
def _extract(i: int):
    """extract_unit's (tokens, features) of STREAMS[i]."""
    cfg, a = STREAMS[i]
    idx, feat = _models()[1][cfg].extract_unit(a[None], process_window=WINDOW)
    return idx.data, feat.data


def _server(**kw) -> CodecServer:
    kw.setdefault("batch_size", 4)
    return CodecServer(_models()[1], chunk_seconds=CHUNK_SECONDS, **kw)


@pytest.mark.parametrize("entry", ["step", "drain"])
@pytest.mark.parametrize("use_native", FRAMERS)
def test_mixed_config_tokens_equal_extract_unit_and_stream_codec(use_native, entry):
    models = _models()[1]
    before = dict(K.LAUNCHES)
    server = _server(use_native=use_native)
    handles = [server.submit(cfg, a) for cfg, a in STREAMS[:3]]
    assert server.step()
    # arrivals mid-flight
    handles += [server.submit(cfg, a) for cfg, a in STREAMS[3:]]
    if entry == "step":
        while server.step():
            pass
    else:
        server.drain()
    for i, (h, (cfg, a)) in enumerate(zip(handles, STREAMS)):
        got = server.tokens(h)
        assert len(got) == -(-len(a) // models[cfg].mc.hop_length)
        np.testing.assert_array_equal(got, _extract(i)[0], err_msg=f"{cfg} stream {i}")
        want = StreamCodec(models[cfg], chunk_seconds=CHUNK_SECONDS,
                           batch_size=4).encode_streams([a], use_native=use_native)[0]
        np.testing.assert_array_equal(got, want)
    assert server.stats["programs"] > 0 and server.stats["fetches"] > 0
    assert K.LAUNCHES == before        # the CPU runs the plain versions


@pytest.mark.parametrize("use_native", FRAMERS)
def test_decode_lanes_match_stream_codec(use_native):
    models = _models()[1]
    before = dict(K.LAUNCHES)
    server = _server(use_native=use_native)
    h_idx = [server.submit_decode(cfg, indices=_extract(i)[0], length=len(a))
             for i, (cfg, a) in enumerate(STREAMS)]
    assert server.step()
    h_feat = [server.submit_decode(cfg, features=_extract(i)[1])
              for i, (cfg, _) in enumerate(STREAMS)]
    server.drain()
    for i, (cfg, a) in enumerate(STREAMS):
        sc = StreamCodec(models[cfg], chunk_seconds=CHUNK_SECONDS, batch_size=4)
        got = server.audio(h_idx[i])
        assert got.dtype == np.float32 and got.shape == (len(a),)
        _close_audio(got, sc.decode_indices_streams([_extract(i)[0]], [len(a)])[0])
        _close_audio(server.audio(h_feat[i]), sc.decode_streams([_extract(i)[1]])[0])
    assert K.LAUNCHES == before


@pytest.mark.parametrize("use_native", FRAMERS)
def test_kill_and_resume_mid_flight(use_native):
    """save_state after three steps, restore into a new server over the same
    models, drain: the results of an uninterrupted run."""
    def submit_all(server):
        enc = [server.submit(cfg, a) for cfg, a in STREAMS[:4]]
        dec = server.submit_decode("tiny3k", indices=np.arange(300) % 17, length=None)
        feat = server.submit_decode("debug", features=_extract(2)[1], length=7000)
        return enc, dec, feat

    ref = _server(use_native=use_native)
    enc_r, dec_r, feat_r = submit_all(ref)
    ref.drain()

    s1 = _server(use_native=use_native)
    enc_1, dec_1, feat_1 = submit_all(s1)
    for _ in range(3):
        assert s1.step()
    blob = s1.save_state()
    del s1
    s2 = _server(use_native=use_native)
    s2.restore_state(blob)
    s2.drain()
    for h_ref, h in zip(enc_r, enc_1):
        np.testing.assert_array_equal(s2.tokens(h), ref.tokens(h_ref))
    for h_ref, h in ((dec_r, dec_1), (feat_r, feat_1)):
        np.testing.assert_allclose(s2.audio(h), ref.audio(h_ref), rtol=2e-4, atol=1e-6)


def test_restore_rejects_a_mismatched_server():
    models = _models()[1]
    blob = CodecServer({"debug": models["debug"]}, chunk_seconds=CHUNK_SECONDS, batch_size=4,
                       use_native=False).save_state()
    with pytest.raises(ValueError, match="lane mismatch"):
        _server(use_native=False).restore_state(blob)
    with pytest.raises(ValueError, match="batch_size"):
        CodecServer({"debug": models["debug"]}, chunk_seconds=CHUNK_SECONDS, batch_size=2,
                    use_native=False).restore_state(blob)
    # a framer blob is its own framer's: python and native do not mix
    with pytest.raises(ValueError):
        CodecServer({"debug": models["debug"]}, chunk_seconds=CHUNK_SECONDS, batch_size=4,
                    use_native=True).restore_state(blob)


@pytest.mark.parametrize("use_native", FRAMERS)
def test_incremental_feed_equals_one_shot(use_native):
    models = {"debug": _models()[1]["debug"]}
    audio = STREAMS[2][1]
    s1 = CodecServer(models, chunk_seconds=CHUNK_SECONDS, batch_size=4, use_native=use_native)
    h1 = s1.submit("debug", audio)
    s1.drain()
    s2 = CodecServer(models, chunk_seconds=CHUNK_SECONDS, batch_size=4, use_native=use_native)
    h2 = s2.submit("debug")
    for ofs in range(0, len(audio), 1111):      # ragged pieces, compute between them
        s2.feed(h2, audio[ofs:ofs + 1111])
        s2.step()
    s2.finish(h2)
    s2.drain()
    np.testing.assert_array_equal(s1.tokens(h1), s2.tokens(h2))
    np.testing.assert_array_equal(s2.tokens(h2), _extract(2)[0])


def test_lane_aging_prevents_starvation():
    """A lone ready chunk on one lane is served within ``aging_steps`` steps
    under sustained load on another."""
    server = _server(batch_size=2, use_native=False, aging_steps=3)
    h_small = server.submit("tiny3k", _audio(0.11, 6))
    server.submit("debug", _audio(1.5, 7))      # alone, more than aging_steps batches
    served_at = None
    for n in range(1, 20):
        if not server.step():
            break
        if served_at is None and server.done(h_small):
            served_at = n
    assert served_at is not None and 2 <= served_at <= 4, served_at


@pytest.mark.parametrize("use_native", FRAMERS)
def test_idle_lane_does_not_stall_a_ready_lane(use_native):
    """Two registered but unfed streams on one lane do not outscore a lane
    with finished work, and drain() leaves no ready row behind."""
    server = _server(use_native=use_native)
    server.submit("debug")
    server.submit("debug")
    h = server.submit("tiny3k", STREAMS[3][1])
    server.drain()
    assert server.done(h)
    np.testing.assert_array_equal(server.tokens(h), _extract(3)[0])


def test_pcm16_output_is_within_one_step_of_float():
    ref = _server(use_native=False)
    pcm = _server(use_native=False, pcm16_output=True)
    handles = {}
    for srv in (ref, pcm):
        handles[id(srv)] = [srv.submit_decode(cfg, indices=_extract(i)[0], length=len(a))
                            for i, (cfg, a) in enumerate(STREAMS[:3])]
        srv.drain()
    for hr, hp in zip(handles[id(ref)], handles[id(pcm)]):
        want, got = ref.audio(hr), pcm.audio(hp)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1.0 / 32767.0
    assert pcm.lanes["debug:dec_idx"].run(torch.zeros(4, 66, dtype=torch.int32)).dtype == torch.int16


def test_bf16_server_host_cast_is_the_device_cast_and_audio_is_fp32():
    """A bf16 server rounds audio and feature rows to bf16 on the host before
    the upload; with the cast left to the lane's call instead, tokens and
    audio are bit-identical. tokens() are int32 and audio() float32."""
    def make():
        return CodecServer({"debug": get_model("debug", device="cpu", dtype=torch.bfloat16)},
                           chunk_seconds=CHUNK_SECONDS, batch_size=4, use_native=False)

    host, dev = make(), make()
    assert host.lanes["debug:enc"].in_cast == torch.bfloat16
    assert host.lanes["debug:dec_feat"].in_cast == torch.bfloat16
    assert host.lanes["debug:dec_idx"].in_cast is None
    for lane in dev.lanes.values():
        lane.in_cast = None
    audio = STREAMS[0][1]
    x = audio[:1608].reshape(1, -1)
    assert torch.equal(host._upload(host.lanes["debug:enc"], x).view(torch.int16),
                       torch.from_numpy(x).to(torch.bfloat16).view(torch.int16))
    hh, hd = host.submit("debug", audio), dev.submit("debug", audio)
    host.drain()
    dev.drain()
    th, td = host.tokens(hh), dev.tokens(hd)
    assert th.dtype == np.int32
    np.testing.assert_array_equal(th, td)
    feat = _extract(0)[1]
    hs = [host.submit_decode("debug", indices=th, length=len(audio)),
          host.submit_decode("debug", features=feat, length=len(audio))]
    ds = [dev.submit_decode("debug", indices=td, length=len(audio)),
          dev.submit_decode("debug", features=feat, length=len(audio))]
    host.drain()
    dev.drain()
    for a, b in zip(hs, ds):
        ah, ad = host.audio(a), dev.audio(b)
        assert ah.dtype == np.float32 and ah.shape == (len(audio),) and np.isfinite(ah).all()
        np.testing.assert_array_equal(ah, ad)


def test_profile_serve_load_drives_every_lane(monkeypatch):
    """``profile_serve``'s load (which ``chip_smoke.py`` serves on the card)
    at 1/25 of its lengths: every lane runs, every stream completes, piecewise
    and late streams included, and their tokens equal extract_unit's."""
    models = _models()[1]
    models = {"1kbps": models["debug"], "3kbps": models["tiny3k"]}
    monkeypatch.setattr(profile_serve, "SERVE_ENCODE_SECONDS",
                        tuple(s / 25 for s in profile_serve.SERVE_ENCODE_SECONDS))
    enc = profile_serve.serve_load()
    tokens, features = profile_serve.random_decode_inputs(models, enc)
    server = CodecServer(models, chunk_seconds=CHUNK_SECONDS, batch_size=8, use_native=True)
    calls = profile_serve.timed_lanes(server)
    out, wall = profile_serve.run_serve_load(server, enc, tokens, features)
    assert wall > 0 and all(n > 0 for n, _ in calls.values())
    assert len(out) == 12 + 6 + 2
    for i in (0, profile_serve.SERVE_INCREMENTAL[0], profile_serve.SERVE_LATE):
        cfg, a = enc[i]
        np.testing.assert_array_equal(out["enc", i], models[cfg].extract_unit(
            a[None], process_window=WINDOW)[0].data)
    for i in profile_serve.SERVE_DEC_IDX:
        assert out["dec_idx", i].shape == (len(enc[i][1]),)
    for i in profile_serve.SERVE_DEC_FEAT:
        assert out["dec_feat", i].shape == (len(tokens[i]) * models[enc[i][0]].mc.hop_length,)
    assert profile_serve.serve_seconds(enc) == pytest.approx(163.4 / 25, rel=1e-3)


# -- the framers -----------------------------------------------------------
def _fed(framer, lengths, seed=3):
    rng = np.random.default_rng(seed)
    for n in lengths:
        sid = framer.add_stream()
        framer.feed(sid, (rng.standard_normal(n) * 0.5).astype(np.float32))
        framer.finish(sid)
    return framer


def _drain_batches(framer) -> list:
    seq = []
    while framer.pending():
        rows, batch, sids, cids, valid = framer.next_batch()
        if rows == 0:
            break
        seq.append((rows, batch.copy(), sids.copy(), cids.copy(), valid.copy()))
    return seq


def test_python_and_native_framers_give_byte_equal_rows():
    """The batch fill order is each framer's policy; each (stream, chunk)'s
    row, zeros after its valid length included, is byte-equal."""
    lengths = [300, 121, 480, 77, 240]
    rows = []
    for framer in (PyFramer(120, 24, 3), native.NativeFramer(120, 24, 3)):
        got = {}
        for n, batch, sids, cids, valid in _drain_batches(_fed(framer, lengths)):
            for r in range(n):
                got[(int(sids[r]), int(cids[r]))] = (int(valid[r]), batch[r].tobytes())
        rows.append(got)
    assert rows[0].keys() == rows[1].keys() and len(rows[0]) == 12
    assert rows[0] == rows[1]


@pytest.mark.parametrize("use_native", FRAMERS)
def test_framer_save_and_restore_reproduce_the_remaining_batches(use_native):
    make = (lambda: native.NativeFramer(120, 24, 3)) if use_native else (
        lambda: PyFramer(120, 24, 3))
    lengths = [500, 130, 977, 260]
    ref = _drain_batches(_fed(make(), lengths))
    f1 = _fed(make(), lengths)
    f1.next_batch()
    f2 = make()
    f2.restore_state(f1.save_state())
    resumed = _drain_batches(f2)
    assert len(resumed) == len(ref) - 1
    for got, want in zip(resumed, ref[1:]):
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        (native.NativeFramer(100, 24, 3) if use_native else PyFramer(100, 24, 3)).restore_state(
            f1.save_state())


def test_native_framer_state_errors():
    framer = _fed(native.NativeFramer(120, 24, 3), [300])
    with pytest.raises(ValueError, match="failed: -1"):
        framer.restore_state(b"\0" * 64)
    blob = framer.save_state()
    with pytest.raises(ValueError, match="failed: -3"):
        framer.restore_state(blob[:-4])

    class Short:
        """The library, with a save that writes one byte less than it said."""
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        def framer_save_state(self, h, buf, n):
            return self.lib.framer_save_state(h, buf, n) - 1

    framer._lib = Short(framer._lib)
    with pytest.raises(RuntimeError, match="wrote"):
        framer.save_state()
    framer._lib = framer._lib.lib


def test_native_server_raises_when_the_framer_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="not found"):
        _server(use_native=True)
    assert isinstance(_server().lanes["debug:enc"].framer, PyFramer)


def test_caller_errors_raise():
    server = _server(use_native=False)
    with pytest.raises(ValueError, match="exactly one"):
        server.submit_decode("debug")
    with pytest.raises(ValueError, match="exactly one"):
        server.submit_decode("debug", indices=np.zeros(3), features=np.zeros((3, 32)))
    with pytest.raises(ValueError, match=r"\(T, 32\)"):
        server.submit_decode("debug", features=np.zeros((3, 31)))
    h = server.submit("debug")
    with pytest.raises(ValueError, match="empty"):
        server.finish(h)
    server.feed(h, STREAMS[0][1])
    with pytest.raises(RuntimeError, match="not finished"):
        server.tokens(h)
    server.finish(h)
    with pytest.raises(ValueError, match="is finished"):
        server.feed(h, STREAMS[0][1])
    server.drain()
    with pytest.raises(ValueError, match="decode streams"):
        server.audio(h)
    np.testing.assert_array_equal(server.tokens(h), _extract(0)[0])


def test_chunk_rule_rejects_one_token_chunks():
    with pytest.raises(ValueError, match="1-token chunk"):
        CodecServer({"debug": _models()[1]["debug"]}, chunk_seconds=30 / 16000)


# -- against the JAX package's CodecServer ---------------------------------
def _jax_server(**kw) -> JaxCodecServer:
    """JAX's server on debug, its lanes on the JAX model's jitted functions
    (the same programs as the lanes' own for an fp32 model)."""
    jmodel = _models()[0]
    server = JaxCodecServer({"debug": jmodel}, chunk_seconds=CHUNK_SECONDS, use_native=False, **kw)
    server.lanes["debug:enc"].run = jmodel._encode
    server.lanes["debug:dec_idx"].run = jmodel._decode_indices
    server.lanes["debug:dec_feat"].run = jmodel._decode
    return server


# eight one-token streams (1 token each after the hop padding) and one of
# two full chunks: JAX compiles one server shape and three extract_unit ones
HOP = 24
ONE_TOKEN = [_audio((HOP - k) / 16000, 20 + k) for k in range(8)]
TWO_CHUNKS = _audio(2 * 1584 / 16000, 30)


@functools.lru_cache(maxsize=None)
def _encode_runs():
    """(JAX server tokens, port server tokens, JAX extract_unit tokens) of
    ONE_TOKEN + [TWO_CHUNKS] on debug."""
    jmodel, models = _models()
    streams = ONE_TOKEN + [TWO_CHUNKS]
    out = []
    for server in (_jax_server(batch_size=8),
                   CodecServer({"debug": models["debug"]}, chunk_seconds=CHUNK_SECONDS,
                               batch_size=8, use_native=True)):
        handles = [server.submit("debug", a) for a in streams]
        server.drain()
        out.append([np.asarray(server.tokens(h)) for h in handles])
    out.append([np.asarray(jmodel.extract_unit(a[None], process_window=WINDOW)[0].data)
                for a in streams])
    return out


def test_encode_tokens_equal_jax_server_where_it_equals_its_extract_unit():
    jax_tokens, tokens, jax_extract = _encode_runs()
    _, models = _models()
    for a, t, jt, je in zip(ONE_TOKEN + [TWO_CHUNKS], tokens, jax_tokens, jax_extract):
        assert len(t) == len(jt) == len(je) == -(-len(a) // HOP)
        np.testing.assert_array_equal(t, je)     # the port equals JAX's extract_unit
        np.testing.assert_array_equal(t, models["debug"].extract_unit(
            a[None], process_window=WINDOW)[0].data)
        # where the two servers differ, JAX's left its extract_unit
        np.testing.assert_array_equal(t != jt, je != jt)


def test_jax_server_zero_padding_changes_one_token_streams():
    """ROADMAP C: JAX's CodecServer encodes each segment in a full row padded
    with zero samples, and the encoder does not ignore them; the port's
    tokens equal extract_unit's on every one-token stream."""
    jax_tokens, tokens, jax_extract = _encode_runs()
    faulty = 0
    for t, jt, je in zip(tokens[:8], jax_tokens[:8], jax_extract[:8]):
        np.testing.assert_array_equal(t, je)
        faulty += int((jt != je).sum())
    assert faulty > 0


def test_decode_lanes_match_jax_server():
    """dec_idx and dec_feat audio against JAX's CodecServer on debug: a stream
    of two full chunks by indices (a first and an interior chunk shape) and
    one chunk by features."""
    _, models = _models()
    tokens = _encode_runs()[1][-1]
    feat = models["debug"].extract_unit(TWO_CHUNKS[None, :1584], process_window=WINDOW)[1].data
    results = []
    for server in (_jax_server(batch_size=4), _server(use_native=True)):
        h = [server.submit_decode("debug", indices=tokens, length=len(TWO_CHUNKS) - 5),
             server.submit_decode("debug", features=feat)]
        server.drain()
        results.append([np.asarray(server.audio(x)) for x in h])
    for got, want in zip(results[1], results[0]):
        assert got.shape == want.shape and got.dtype == np.float32
        _close_audio(got, want)
