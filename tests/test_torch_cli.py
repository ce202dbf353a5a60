"""``python -m l3ac_tpu_torch`` against ``python -m l3ac_tpu`` on ``debug``
(``--device cpu``), WAV I/O against the JAX package's, and the host metrics.

Both CLIs' ``_load_model`` are replaced by models holding one converted
seeded checkpoint (JAX's CLI has no path flag). The token files are equal;
the WAVs within 1 / 32767 (one PCM16 step) + 1e-4 x max(1, max |audio|),
the decode tolerance of ``test_torch_decode.py``.
"""

import json

import numpy as np
import pytest
import torch

import l3ac_tpu.__main__ as jax_cli
from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import zoo as jz
from l3ac_tpu.runtime import convert as jcv
from l3ac_tpu.utils import audio_io as jax_audio_io
from l3ac_tpu_torch import __main__ as cli
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.runtime import convert
from l3ac_tpu_torch.utils import metrics
from l3ac_tpu_torch.utils.audio_io import read_wav, write_wav

SR = 16000


def test_cli_list(capsys):
    assert cli.main(["list"]) == 0
    names = capsys.readouterr().out.split()
    assert names == sorted(names) and {"1kbps", "debug"} <= set(names)


def test_cli_info_on_the_cpu(capsys):
    assert cli.main(["info", "--model", "debug", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["params"] == 108_984 and info["codebook_size"] == 125
    assert info["macs"] > 0 and info["macs_per_audio_second"] * 10 == pytest.approx(info["macs"], 1e-6)


def test_cli_encode_decode_matches_jax(tmp_path, monkeypatch, capsys):
    sds = convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=13)
    ckpt = convert.write_state_dicts(sds, tmp_path / "ckpt")
    jmodel = jz.L3AC(jax_config("debug"), params=jcv.convert_model_dir(
        ckpt, jax_config("debug").network_config, config_name="debug"))
    model = get_model("debug", device="cpu").load_pretrained(ckpt)
    asked = []

    def load(name, pretrained, device):
        asked.append((name, pretrained, device))
        return model

    monkeypatch.setattr(cli, "_load_model", load)
    monkeypatch.setattr(jax_cli, "_load_model", lambda name, pretrained: jmodel)

    t = np.arange(SR // 2 + 37, dtype=np.float32) / SR
    x = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * np.sin(2 * np.pi * 2700 * t)).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    write_wav(wav_in, x, SR)
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        extra = ["--device", "cpu"] if tag == "port" else []
        assert main(["encode", str(wav_in), str(tmp_path / f"{tag}.npz"), "--model", "debug",
                     *extra]) == 0
        line = capsys.readouterr().out
        assert f"-> {tmp_path / f'{tag}.npz'}" in line
        assert main(["decode", str(tmp_path / f"{tag}.npz"), str(tmp_path / f"{tag}.wav"),
                     *extra]) == 0
    assert asked == [("debug", False, "cpu")] * 2

    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["indices", "length", "model"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        assert int(a["length"]) == len(x) and str(a["model"]) == "debug"
    y, rate = read_wav(tmp_path / "port.wav")
    jy, _ = read_wav(tmp_path / "jax.wav")
    assert rate == SR and y.shape == jy.shape == x.shape
    np.testing.assert_allclose(y, jy, rtol=0, atol=1 / 32767 + 1e-4 * max(1.0, np.abs(jy).max()))


def test_wav_round_trip_and_across_packages(tmp_path):
    t = np.arange(SR, dtype=np.float32) / SR
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    write_wav(tmp_path / "tone.wav", x, SR)
    y, rate = read_wav(tmp_path / "tone.wav", expect_rate=SR)
    assert rate == SR and y.shape == x.shape and y.dtype == np.float32
    np.testing.assert_allclose(y, x, atol=1.0 / 32767)
    jy, _ = jax_audio_io.read_wav(tmp_path / "tone.wav")
    np.testing.assert_array_equal(y, jy)
    jax_audio_io.write_wav(tmp_path / "jax.wav", x, SR)
    assert (tmp_path / "jax.wav").read_bytes() == (tmp_path / "tone.wav").read_bytes()
    with pytest.raises(ValueError, match="sample rate"):
        read_wav(tmp_path / "tone.wav", expect_rate=8000)


def test_metrics_are_host_counters():
    m = metrics.StreamMetrics()
    meter = m.meter("encode").start()
    meter.stop(audio_seconds=2.0)
    snap = m.snapshot()["encode"]
    assert snap["calls"] == 1 and snap["audio_seconds"] == 2.0 and meter.rtf > 0
    assert m.meter("encode") is meter
    a, b = torch.tensor([0.0, 1.0, 2.0]), np.array([0.0, 1.0, 4.0])
    assert metrics.mse(a, b) == pytest.approx(4.0 / 3)
    assert metrics.mse(a, a) == 0.0
