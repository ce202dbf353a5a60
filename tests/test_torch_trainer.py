"""The port's trainer (``l3ac_tpu_torch/trainer.py``), its CLI and its debug
helpers on the CPU, at ``debug`` with batch 2 x 4 tokens:

- kill and resume: 2 steps with ``save_every=2``, then ``resume`` to step 4,
  equal bit for bit to an uninterrupted 4-step run (parameters and Adam
  moments), with drop-path and FSQ noise on, so that the step generators
  are replayed too;
- the loss decreases over 8 steps at ``lr=1e-3``;
- the generators are a pure function of (seed, step): the same seed gives
  the same parameters, another generator seed other ones, and rate 0 is
  inert;
- ``resume`` with no checkpoint starts fresh; a resume whose checkpoint is at
  or past ``steps`` writes nothing new and reports its step (JAX's final-save
  rule);
- a port-saved ``params.npz`` loads in JAX's ``runtime.checkpoint.load_params``
  and in the port's; the step is stored as an int;
- ``python -m l3ac_tpu_torch train`` exits 0 and writes its checkpoint; dp /
  sp / tp above 1 raise, naming ROADMAP A11;
- ``make_train_step`` without an optimizer is plain SGD;
- ``utils.debug``: ``checked`` names a non-finite output, ``finite_or_raise``
  walks nested structures, ``nan_debug`` is autograd's anomaly mode.
"""

import numpy as np
import pytest
import torch

from l3ac_tpu_torch import trainer
from l3ac_tpu_torch.__main__ import main
from l3ac_tpu_torch.utils import debug
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

KW = dict(batch=2, tokens=4, lr=1e-3, device="cpu", log=lambda *a: None)


def _state(result) -> dict:
    codec, opt = result["codec"], result["optimizer"]
    out = {f"p/{n}": p.detach().clone() for n, p in codec.named_parameters()}
    for n, p in codec.named_parameters():
        s = opt.state[p]
        out[f"m/{n}"], out[f"v/{n}"] = s["exp_avg"].clone(), s["exp_avg_sq"].clone()
        out[f"s/{n}"] = s["step"].clone()
    return out


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_kill_and_resume_is_bit_equal(tmp_path):
    kw = dict(KW, drop_path_rate=0.2, spectral=True)
    whole = trainer.train("debug", steps=4, **kw)
    trainer.train("debug", steps=2, save_every=2, ckpt_dir=str(tmp_path), **kw)
    assert trainer.latest(tmp_path) == (2, tmp_path / "step_00000002")
    resumed = trainer.train("debug", steps=4, save_every=2, ckpt_dir=str(tmp_path),
                            resume=True, **kw)
    assert resumed["step"] == 4 and trainer.latest(tmp_path)[0] == 4
    assert _equal(_state(whole), _state(resumed))
    assert resumed["metrics"] == whole["metrics"]


def test_loss_decreases():
    losses = []
    trainer.train("debug", steps=8, **dict(KW, log=losses.append))
    values = [float(line.split("loss ")[1].split()[0]) for line in losses]
    assert len(values) == 8 and values[-1] < values[0]


def test_generators_are_a_function_of_seed_and_step(monkeypatch):
    kw = dict(KW, drop_path_rate=0.5)
    a = _state(trainer.train("debug", steps=2, **kw))
    b = _state(trainer.train("debug", steps=2, **kw))
    plain = _state(trainer.train("debug", steps=2, **dict(KW)))
    assert _equal(a, b) and not _equal(a, plain)
    g1, g2 = trainer.step_generator(0, 3, "cpu"), trainer.step_generator(0, 3, "cpu")
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert not torch.equal(torch.rand(4, generator=trainer.step_generator(0, 4, "cpu")),
                           torch.rand(4, generator=trainer.step_generator(1, 3, "cpu")))
    # the same data and weights, other step generators: other parameters
    base = trainer.step_generator
    monkeypatch.setattr(trainer, "step_generator",
                        lambda seed, step, device: base(seed + 7, step, device))
    c = _state(trainer.train("debug", steps=2, **kw))
    assert not _equal(a, c)


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    lines = []
    fresh = _state(trainer.train("debug", steps=2, **KW))
    got = trainer.train("debug", steps=2, ckpt_dir=str(tmp_path / "none"), resume=True,
                        **dict(KW, log=lines.append))
    assert any("starting fresh" in line for line in lines)
    assert _equal(_state(got), fresh)


def test_resume_at_or_past_steps_writes_nothing(tmp_path):
    trainer.train("debug", steps=3, save_every=3, ckpt_dir=str(tmp_path), **KW)
    before = sorted(p.name for p in tmp_path.iterdir())
    for steps in (3, 2):
        out = trainer.train("debug", steps=steps, save_every=2, ckpt_dir=str(tmp_path),
                            resume=True, **KW)
        assert out["step"] == 3 and out["metrics"] == {}
    assert sorted(p.name for p in tmp_path.iterdir()) == before == ["step_00000003"]


def test_saved_params_load_in_jax_and_in_the_port(tmp_path):
    out = trainer.train("debug", steps=1, save_every=1, ckpt_dir=str(tmp_path), **KW)
    path = tmp_path / "step_00000001"
    from l3ac_tpu_torch.runtime.checkpoint import load_params
    mc = out["codec"].mc
    sd = out["codec"].state_dict()
    mine = load_params(path / "params.npz", mc)
    assert all(torch.equal(mine[k], sd[k]) for k in sd)
    with np.load(path / "opt.npz") as z:
        assert z["step"].dtype == np.int64 and int(z["step"]) == 1
    import jax
    from l3ac_tpu.runtime.checkpoint import load_params as jax_load_params
    from l3ac_tpu_torch import weights
    jparams = jax_load_params(path / "params.npz")
    back = weights.from_jax_params(jax.tree.map(np.asarray, jparams), mc)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_cli_train_and_the_mesh_flags(tmp_path, capsys):
    assert main(["train", "--config", "debug", "--steps", "2", "--batch", "2", "--tokens", "4",
                 "--device", "cpu", "--ckpt-dir", str(tmp_path), "--save-every", "2",
                 "--spectral"]) == 0
    assert "step 2/2" in capsys.readouterr().out
    assert trainer.latest(tmp_path)[0] == 2
    # a mesh runs in every rank of a torch.distributed world (the 4-rank
    # runs: tests/test_torch_sharded_train.py); without one it says so
    for flag in ("--dp", "--sp", "--tp"):
        with pytest.raises(RuntimeError, match="torch.distributed"):
            main(["train", "--steps", "1", "--device", "cpu", flag, "2"])


def test_make_train_step_without_an_optimizer_is_sgd():
    from l3ac_tpu_torch import train
    codec = trainer.build_codec("debug", "cpu")
    before = {n: p.detach().clone() for n, p in codec.named_parameters()}
    audio = torch.from_numpy(trainer.SyntheticAudio(2, 96, 0)(0))
    metrics = train.make_train_step(codec, lr=1e-2)(audio)
    assert set(metrics) == {"wav_l2", "wav_l1", "loss"}
    for n, p in codec.named_parameters():
        assert torch.equal(p.detach(), before[n] - 1e-2 * p.grad), n


def test_debug_helpers():
    def f(x):
        return {"a": x, "b": [x, x / 0.0]}

    with pytest.raises(FloatingPointError, match=r"f output\['b'\]\[1\]"):
        debug.checked(f)(torch.ones(2))
    assert debug.checked(lambda x: x * 2)(torch.ones(2)).sum() == 4
    debug.finite_or_raise({"w": torch.ones(3), "n": [np.ones(2), 1.0, 3]})
    with pytest.raises(FloatingPointError, match=r"state\['n'\]\[0\]"):
        debug.finite_or_raise({"w": torch.ones(3), "n": [np.array([np.inf])]}, "state")
    x = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with debug.nan_debug():
            (torch.sqrt(x) * 0.0).sum().backward()
