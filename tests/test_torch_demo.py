"""``python -m l3ac_tpu_torch.demo`` (the port's copy of ``examples/demo.py``)
on the CPU: ``--model debug --random --device cpu`` prints the token ids of
the synthetic chirp, equal to the port's own ``encode_audio`` of that clip,
and a finite MSE; without ``--random`` or ``--model-path`` it raises rather
than download."""

import json

import numpy as np
import pytest

from l3ac_tpu_torch import demo
from l3ac_tpu_torch.models.zoo import get_model


def test_demo_prints_the_encode_audio_tokens(capsys):
    res = demo.main(["--model", "debug", "--random", "--device", "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("token ids: "))
    printed = np.asarray(json.loads(line[len("token ids: "):]))
    m = get_model("debug", device="cpu", seed=0)
    _, want = m.encode_audio(demo.synthetic_chirp(m.config.sample_rate))
    np.testing.assert_array_equal(printed, want.numpy())
    np.testing.assert_array_equal(res["tokens"], want.numpy())
    assert np.isfinite(res["mse"]) and f"MSE: {res['mse']}" in out
    assert "models: " in out and "'1kbps'" in out and "model info: " in out
    assert f"tokens: {tuple(want.shape)}" in out


def test_demo_without_weights_raises():
    with pytest.raises(SystemExit, match="nothing is downloaded"):
        demo.main(["--model", "debug", "--device", "cpu"])


def test_demo_chirp_is_the_examples_clip():
    a = demo.synthetic_chirp(16000)
    assert a.shape == (1, 64000) and a.dtype == np.float32
    assert 0.1 < np.abs(a).max() <= 0.4
