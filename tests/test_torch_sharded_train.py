"""The sharded train step, the trainer on a mesh, sharded checkpoints and
data-parallel serving in the port, on the CPU, against the JAX package.

One group of 4 gloo ranks for the file (``tests/_torch_tp_worker.py``,
spawned once for the module) runs: one sharded step of ``debug`` at seed 0
on the meshes (1, 2, 2), (2, 1, 2) and (2, 2, 1) (SGD at lr 0, the waveform
loss: the spectral gradient is roundoff-conditioned at a seeded
model); six Adam steps with the spectral loss on a tone; the trainer on
(1, 2, 2) killed at step 2 and resumed; a tp 2 ``save_sharded`` loaded at
tp 4 and whole; ``CodecServer(mesh=)`` at dp 2 beside the single-device
server. Here the gradients are held, leaf by leaf, within JAX's own bound
(``tests/test_parallel.py:122-130``: 3e-2 x the leaf's scale + 1e-5) of
``jax.grad`` of JAX's ``loss_fn`` on the same weights, and within
``PORT_TOL`` of the port's single-process step.
"""

import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
import _torch_tp_worker as worker
from l3ac_tpu import train as jtrain
from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.runtime.checkpoint import load_params as jax_load_params
from l3ac_tpu_torch import train, weights
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.parallel import sharding
from l3ac_tpu_torch.runtime.checkpoint import save_params
from l3ac_tpu_torch.runtime.streaming import StreamCodec
from l3ac_tpu_torch.trainer import build_codec

pytestmark = pytest.mark.usefixtures("one_thread")

WORLD = 4
# the port's sharded step against its single-process step, per leaf: the
# same sums in another order (x max |leaf| + floor)
PORT_TOL = (1e-4, 1e-6)
JAX_TOL = (3e-2, 1e-5)     # tests/test_parallel.py:122-130


@pytest.fixture(scope="module")
def ranks():
    out = Path(tempfile.mkdtemp(prefix="torch_sharded_train_"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(worker.__file__)), str(r), str(WORLD),
                               str(port), str(out), "grads,noise,adam,trainer,ckpt,serve"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=400)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    # numpy arrays among the results: the files are the workers' own
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], out


@pytest.fixture(scope="module")
def single():
    """The port's single-process step and JAX's gradient on the same weights
    and audio: ({name: grad}, metrics, {name: JAX grad in the port's layout})."""
    codec = build_codec("debug", "cpu", 0)
    audio = worker.train_audio(codec.mc)
    loss, metrics = train.loss_fn(codec, torch.from_numpy(audio))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in codec.named_parameters()}
    jmc = jax_config("debug").network_config
    params = jax.tree.map(jnp.asarray, weights.to_jax_params(codec.state_dict(), codec.mc))
    jg = jax.jit(jax.grad(lambda p, a: jtrain.loss_fn(p, a, jmc)[0]))(params,
                                                                       jnp.asarray(audio))
    jgrads = weights.from_jax_params(jax.tree.map(np.asarray, jg), codec.mc)
    return grads, {k: float(v.detach()) for k, v in metrics.items()}, jgrads, codec.mc


def _whole_grads(res, shape, mc) -> dict:
    """The mesh's gradients put together over tp from the ranks at dp = sp
    = 0; every rank of a tp coordinate holds the same ones."""
    by_tp = {}
    for r in res:
        got = r["grads"][shape]
        c = got["coords"]
        if c["dp"] == 0 and c["sp"] == 0:
            by_tp[c["tp"]] = got["grads"]
    for r in res:
        got = r["grads"][shape]
        for k, g in got["grads"].items():
            assert torch.equal(g, by_tp[got["coords"]["tp"]][k]), (shape, k)
    n = shape[2]
    specs = sharding.full_specs(by_tp[0], mc, n)
    return {k: sharding.merge_shards([by_tp[t][k] for t in range(n)], specs[k])
            for k in by_tp[0]}


def _within(got: dict, want: dict, tol: tuple[float, float], label: str) -> None:
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        bound = tol[0] * w.abs().max().item() + tol[1]
        assert err <= bound, f"{label} {k}: {err} > {bound}"


@pytest.mark.parametrize("shape", worker.GRAD_MESHES)
def test_sharded_step_gradients_match_single_step_and_jax(ranks, single, shape):
    res, _ = ranks
    grads, metrics, jgrads, mc = single
    got = _whole_grads(res, shape, mc)
    assert set(got) == set(grads)
    _within(got, grads, PORT_TOL, f"{shape} vs the single-process step")
    _within(got, jgrads, JAX_TOL, f"{shape} vs jax.grad")
    for r in res:
        m = r["grads"][shape]["metrics"]
        for k in ("loss", "wav_l2", "wav_l1"):
            np.testing.assert_allclose(m[k], metrics[k], rtol=1e-5, err_msg=k)


def test_sharded_noise_is_the_single_device_noise(ranks):
    """Drop-path masks and FSQ noise drawn at the whole batch's shape and
    cut to each rank's (dp rows, sp block): the single-process loss."""
    from l3ac_tpu_torch.ops.droppath import seeded
    res, _ = ranks
    codec = build_codec("debug", "cpu", 0)
    with torch.no_grad():
        loss, _ = train.loss_fn(codec, torch.from_numpy(worker.train_audio(codec.mc)),
                                generator=seeded(worker.NOISE_SEED, "cpu"),
                                drop_path_rate=worker.NOISE_RATE)
    plain, _ = train.loss_fn(codec, torch.from_numpy(worker.train_audio(codec.mc)))
    assert abs(loss.item() - plain.item()) > 1e-3 * plain.item()   # the noise acts
    for r in res:
        np.testing.assert_allclose(r["noise"], loss.item(), rtol=1e-5)


def test_sharded_adam_spectral_loss_falls(ranks):
    res, _ = ranks
    losses = res[0]["adam"]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert all(r["adam"] == losses for r in res)


def test_trainer_kill_and_resume_on_a_mesh_is_bit_equal(ranks):
    res, _ = ranks
    for r in res:
        t = r["trainer"]
        assert t["params_equal"] and t["moments_equal"], r
        assert t["step"] == 3 and t["dirs"] == ["step_00000002", "step_00000003"]
        assert t["cli"] == 0
    t = res[0]["trainer"]
    # the step-3 checkpoint, loaded whole, is the gathered parameters
    assert set(t["loaded_whole"]) >= set(t["whole"])
    for k, v in t["whole"].items():
        assert torch.equal(t["loaded_whole"][k], v), k


def test_sharded_checkpoint_loads_at_other_tp_and_in_jax(ranks, tmp_path):
    res, out = ranks
    for r in res:
        c = r["ckpt"]
        assert c["at4_equal"] and c["at4_keys"] and c["at1_equal"]
        assert c["files"] == ["index.json", "shard_0.npz", "shard_1.npz"]
    full = res[0]["ckpt"]["full"]
    mc = get_model("debug", device="cpu").mc
    save_params(tmp_path / "p.npz", full, mc)
    jp = jax_load_params(tmp_path / "p.npz")
    want = weights.to_jax_params(full, mc)
    flat_got = jax.tree_util.tree_leaves_with_path(jp)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path], err_msg=str(path))


def test_data_parallel_server_matches_single_device_and_stream_codec(ranks):
    res, _ = ranks
    models = {"a": get_model("debug", device="cpu", seed=0),
              "b": get_model("debug", device="cpu", seed=1)}
    aud = worker.streams()
    for r in res:
        s = r["serve"]
        assert s["rows_per_step"] == 4
        (t1, a1), (t2, a2) = s["single"], s["dp"]
        for i, (x, y) in enumerate(zip(t1, t2)):
            np.testing.assert_array_equal(x, y, err_msg=f"stream {i}")
            np.testing.assert_array_equal(s["restored_tokens"][i], x)
        for x, y in zip(a1, a2):
            _close_audio(y, x)
    s = res[0]["serve"]
    toks, audio = s["dp"]
    for i, a in enumerate(aud):
        cfg = "a" if i % 2 else "b"
        sc = StreamCodec(models[cfg], chunk_seconds=0.1, batch_size=4)
        np.testing.assert_array_equal(toks[i], sc.encode_streams([a])[0])
        _close_audio(audio[i], sc.decode_indices_streams([toks[i]], [len(a)])[0])


def _close_audio(got, want):
    """tests/test_torch_scheduler.py's rule: a program's rows come in other
    batch compositions, so the sums differ in order."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))
