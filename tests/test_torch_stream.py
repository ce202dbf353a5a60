"""The port's chunked facade (``extract_unit`` / ``decode_unit``), its
``StreamCodec`` (python and native framer) and ``get_model_info`` against the
JAX package's, on ``debug`` with one seeded checkpoint converted for both
(no JAX init), and ``get_model_info``'s parameter count at ``1kbps``.

Indices and tokens are equal; audio within 1e-4 x max(1, max |want|) and
features within rtol / atol 1e-4 (the tolerances of
``test_torch_decode.py`` / ``test_torch_encode.py``).
"""

import functools

import numpy as np
import pytest

import jax

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import zoo as jz
from l3ac_tpu.runtime import convert as jcv
from l3ac_tpu.runtime.chunk import ChunkData as JaxChunkData
from l3ac_tpu.runtime.streaming import StreamCodec as JaxStreamCodec
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.zoo import get_model, get_model_info
from l3ac_tpu_torch.ops import kernels as K
from l3ac_tpu_torch.runtime import convert, native
from l3ac_tpu_torch.runtime.chunk import ChunkData
from l3ac_tpu_torch.runtime.streaming import StreamCodec

RNG = np.random.default_rng(21)


def _close_audio(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _models():
    sds = convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=11)
    numpy_sds = {m: {k: v.numpy() for k, v in sd.items()} for m, sd in sds.items()}
    jmodel = jz.L3AC(jax_config("debug"), params=jcv.convert_checkpoint(
        numpy_sds, jax_config("debug").network_config, strict=True))
    model = get_model("debug", device="cpu")
    model.load_state_dict(convert.convert_checkpoint(
        numpy_sds, get_config("debug").network_config, strict=True))
    return jmodel, model


def test_chunk_data_is_jax_chunk_data():
    data = np.arange(23)
    for cls in (ChunkData, JaxChunkData):
        assert cls(chunk_len=5, prefix_len=1, original_data=data).data is data
    mine = ChunkData(chunk_len=5, prefix_len=1, original_data=data).chunk_data
    theirs = JaxChunkData(chunk_len=5, prefix_len=1, original_data=data).chunk_data
    assert [list(c) for c in mine] == [list(c) for c in theirs]
    np.testing.assert_array_equal(ChunkData(5, 1, chunk_data=mine).data, data)


def test_extract_and_decode_unit_match_jax():
    jmodel, model = _models()
    hop = model.mc.hop_length
    audio = (RNG.standard_normal((1, hop * 40 - 7)) * 0.3).astype(np.float32)
    before = dict(K.LAUNCHES)
    idx, feat = model.extract_unit(audio, process_window=hop * 16)
    jidx, jfeat = jmodel.extract_unit(audio, process_window=hop * 16)
    assert len(idx.chunk_data) == len(jidx.chunk_data) == 3
    for a, b in zip(idx.chunk_data, jidx.chunk_data):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(feat.chunk_data, jfeat.chunk_data):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    assert idx.data.shape == (40,)

    by_idx = model.decode_unit(chunk_indices=idx)
    by_feat = model.decode_unit(chunk_q_feature=feat)
    assert by_idx.shape == by_feat.shape == (1, hop * 40)
    _close_audio(by_idx, np.asarray(jmodel.decode_unit(chunk_indices=jidx)))
    _close_audio(by_feat, np.asarray(jmodel.decode_unit(chunk_q_feature=jfeat)))
    assert K.LAUNCHES == before        # the CPU runs the plain versions


def test_stream_codec_matches_jax_and_extract_unit():
    """Tokens equal JAX's ``StreamCodec`` wherever JAX's equal its own
    ``extract_unit``; the port's equal ``extract_unit``'s everywhere (it
    pads no chunk with zero samples, ROADMAP C), on both framers."""
    jmodel, model = _models()
    hop = model.mc.hop_length
    # 40, 24, 9, 56 and 9 tokens: chunks of 16, 17 and 9 tokens only, the
    # shapes JAX has compiled for the test above
    lengths = (hop * 40 - 7, hop * 24 - 3, hop * 9 - 1, hop * 56 - 11, hop * 9 - 13)
    streams = [(RNG.standard_normal(n) * 0.3).astype(np.float32) for n in lengths]
    sc = StreamCodec(model, chunk_seconds=hop * 16 / 16000, batch_size=4)
    jsc = JaxStreamCodec(jmodel, chunk_seconds=hop * 16 / 16000, batch_size=4)
    # the same jitted JAX functions as the model's, so that their compiles are shared
    jsc._encode, jsc._decode_idx = jmodel._encode, jmodel._decode_indices
    tokens = sc.encode_streams(streams, use_native=False)
    assert native.available()
    native_tokens = sc.encode_streams(streams, use_native=True)
    jax_tokens = jsc.encode_streams(streams, use_native=False)
    for n, s, t, nt, jt in zip(lengths, streams, tokens, native_tokens, jax_tokens):
        jt = np.asarray(jt)
        assert len(t) == len(nt) == len(jt) == -(-n // hop)
        np.testing.assert_array_equal(t, nt)
        chunks, _ = model.extract_unit(s[None], process_window=hop * 16)
        np.testing.assert_array_equal(t, chunks.data)
        jchunks, _ = jmodel.extract_unit(s[None], process_window=hop * 16)
        np.testing.assert_array_equal(chunks.data, np.asarray(jchunks.data))
        # where the port and JAX's StreamCodec differ, JAX's left its extract_unit
        np.testing.assert_array_equal(t != jt, np.asarray(jchunks.data) != jt)

    audio = sc.decode_indices_streams(tokens, lengths)
    jaudio = jsc.decode_indices_streams(tokens, lengths)
    for n, a, ja in zip(lengths, audio, jaudio):
        assert a.shape == (n,)
        _close_audio(a, np.asarray(ja))
    # by features: the same chunks as decode_unit (held against JAX above)
    for s, a in zip(streams[1:3], sc.decode_streams(
            [model.extract_unit(s[None], process_window=hop * 16)[1].data for s in streams[1:3]])):
        _, feat = model.extract_unit(s[None], process_window=hop * 16)
        _close_audio(a, model.decode_unit(chunk_q_feature=feat)[0])


def test_jax_stream_codec_zero_padding_changes_tokens():
    """ROADMAP C: JAX's ``StreamCodec`` pads a short chunk with zero samples
    to the full row, and the encoder does not ignore them; the port's
    tokens equal ``extract_unit``'s. Eight one-token streams."""
    jmodel, model = _models()
    hop = model.mc.hop_length
    rng = np.random.default_rng(5)
    streams = [(rng.standard_normal(hop - k) * 0.3).astype(np.float32) for k in range(8)]
    jsc = JaxStreamCodec(jmodel, chunk_seconds=hop * 16 / 16000, batch_size=8)
    jsc._encode = jmodel._encode
    jax_tokens = jsc.encode_streams(streams, use_native=False)
    tokens = StreamCodec(model, chunk_seconds=hop * 16 / 16000,
                         batch_size=8).encode_streams(streams, use_native=False)
    faulty = 0
    for s, t, jt in zip(streams, tokens, jax_tokens):
        want = np.asarray(jmodel.extract_unit(s[None], process_window=hop * 16)[0].data)
        np.testing.assert_array_equal(t, want)
        faulty += int((np.asarray(jt) != want).sum())
    assert faulty > 0


def test_stream_decode_of_one_chunk_is_the_direct_decode():
    _, model = _models()
    hop = model.mc.hop_length
    sc = StreamCodec(model, chunk_seconds=hop * 32 / 16000, batch_size=2)
    audio = (RNG.standard_normal((1, hop * 8)) * 0.3).astype(np.float32)
    q, _ = model.encode_audio(audio)
    want = model.decode_audio(audio_feature=q)[0].numpy()
    np.testing.assert_allclose(sc.decode_streams([q[0].numpy()])[0], want, rtol=1e-5, atol=1e-6)


def test_get_model_info_matches_jax_less_its_bias_caches():
    jmodel, model = _models()
    mine = get_model_info(model, eval_flops_seconds=1)
    theirs = jz.get_model_info(jmodel, eval_flops_seconds=1)
    for key in ("codebook_size", "frame_rate", "bps", "receptive_field"):
        assert mine[key] == theirs[key], key
    caches = sum(int(np.prod(np.shape(leaf))) for path, leaf in
                 jax.tree_util.tree_flatten_with_path(jmodel.params)[0]
                 if any(getattr(p, "key", None) == "bias_cache" for p in path))
    assert caches > 0
    assert mine["params"] == theirs["params"] - caches == 108_984
    assert mine["macs"] > 0 and mine["macs_per_audio_second"] == mine["macs"]


def test_get_model_info_counts_1kbps_weights_without_caches():
    model = get_model("1kbps", device="cpu")
    info = get_model_info(model, eval_flops_seconds=1)
    assert info["params"] == 11_250_879
    assert info["codebook_size"] == 7 ** 6 and round(info["bps"]) == 998


def test_native_framer_raises_when_it_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    assert not native.available()
    _, model = _models()
    sc = StreamCodec(model, chunk_seconds=1.0, batch_size=2)
    with pytest.raises(RuntimeError, match="not found"):
        sc.encode_streams([np.zeros(400, np.float32)], use_native=True)
    assert len(sc.encode_streams([np.zeros(400, np.float32)])[0]) == -(-400 // model.mc.hop_length)
