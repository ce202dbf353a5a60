"""The port's training path on the CPU against the JAX package's
(``l3ac_tpu/train.py``, ``ops/fsq.py:quantize_ste``, ``ops/droppath.py``,
``models/codec.py:forward``), on ``debug`` at batch 2 x 4 tokens with JAX's
``init_codec(PRNGKey(0))`` params carried across by ``weights.from_jax_params``.
JAX runs its jnp path (no Pallas kernel on the CPU).

- the HTK mel filterbank equal; ``stft_loss`` and ``mel_loss`` within 1e-5
  relative, on a clip shorter than every frame (JAX's gather repeats its
  last sample) and on one of many frames;
- ``loss_fn`` with ``spectral=True``: the waveform metrics within 1e-5
  relative, the spectral ones and the loss within 1e-4; the gradient of the
  waveform terms and the model's VJP of the spectral terms' cotangent (JAX's
  dL/dy), every leaf within 1e-4 relative L2 of JAX's; the spectral terms'
  own gradient on broadband clips; every
  parameter has a gradient of the whole loss, all-zero only where JAX's is
  zero in exact arithmetic (the tail's, ``dyn_bias``'s and the quantizer's
  projections have one). Why the spectral terms are held in parts: in the
  test;
- ``quantize_ste``: values and indices equal JAX's, the gradient through the
  activation too; the noise's masked share within a binomial bound of the
  rate, its size within 0.5 / L, the same generator seed the same result;
- ``drop_path`` / ``schedule``: JAX's rates, ascending and descending; the
  mask per sample, scaled by 1 / keep; inert at rate 0 or with no generator;
- ``Codec.forward`` with ``training=False`` equals the port's ``encode`` ->
  ``decode`` bit for bit, with JAX's keys and shapes;
- Adam: three steps on the waveform loss from the same params on
  ``SyntheticAudio`` batches, JAX's side the jitted gradient and
  ``optax.adam(1e-3)`` updates: each step's gradient within 1e-4 relative L2
  of JAX's at the same parameters, the moments within 1e-3, the parameters
  within 3 lr (Adam moves an entry by about lr * sign(g), so a gradient entry
  near 0 may move it the other way; 6 lr where the gradient is zero in exact
  arithmetic and each run follows its roundoff).

One jitted JAX function (the metrics, the waveform terms' gradient, dL/dy of
the spectral terms and the model's VJP of it) serves the whole file: the
batch shape is the same everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from l3ac_tpu import train as jtrain
from l3ac_tpu import trainer as jtrainer
from l3ac_tpu.config import get_config as jget_config
from l3ac_tpu.models import codec as jc
from l3ac_tpu.ops import droppath as jdrop
from l3ac_tpu.ops import fsq as jfsq
from l3ac_tpu.ops import pallas as pk
from l3ac_tpu_torch import train, trainer, weights
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.grad_check import exact_zero, negligible, rel_l2, scale_of
from l3ac_tpu_torch.models.codec import Codec
from l3ac_tpu_torch.ops import droppath, fsq
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOKENS, BATCH = 4, 2
# the loss's weights on (wav_l2, wav_l1, stft, mel): the waveform terms, all
WAV, TOTAL = (1.0, 0.1, 0.0, 0.0), (1.0, 0.1, 1.0, 1.0)


def _port_codec(params, mc):
    codec = Codec(mc)
    codec.load_state_dict(weights.from_jax_params(params, mc))
    return codec


@pytest.fixture(scope="module")
def case():
    assert not pk.enabled(), "JAX's jnp path: no Pallas kernel on the CPU"
    jmc = jget_config("debug").network_config
    mc = get_config("debug").network_config
    params = jc.init_codec(jax.random.PRNGKey(0), jmc)

    def parts(p, a):
        """(wav_l2, wav_l1, stft, mel) of the training forward, and y."""
        y = jc.forward(p, a, jmc, training=True)["generated_audio"]
        return jnp.stack([jnp.mean((y - a) ** 2), jnp.mean(jnp.abs(y - a)),
                          jtrain.stft_loss(y, a), jtrain.mel_loss(y, a)]), y

    def run(p, a):
        """The metrics, the waveform terms' gradient, the spectral terms'
        dL/dy and the model's VJP of it: one forward, two backward passes."""
        (vals, y), vjp = jax.vjp(lambda p: parts(p, a), p)
        g_wav = vjp((jnp.asarray(WAV), jnp.zeros_like(y)))[0]
        g_y = jax.grad(lambda y: jtrain.stft_loss(y, a) + jtrain.mel_loss(y, a))(y)
        g_spec = vjp((jnp.zeros_like(vals), g_y))[0]
        return vals, g_wav, g_y, g_spec

    data = jtrainer.SyntheticAudio(BATCH, TOKENS * mc.hop_length, seed=0)
    return jmc, mc, params, jax.jit(run), data


def _port(tree, mc) -> dict:
    """A JAX gradient tree in the port's names and layouts."""
    return weights.from_jax_params(jax.tree.map(np.asarray, tree), mc)


# -- losses ------------------------------------------------------------------

def test_mel_filterbank_equals_jax():
    np.testing.assert_array_equal(train._mel_filterbank(16000, 1024, 80),
                                  np.asarray(jtrain._mel_filterbank(16000, 1024, 80)))


@pytest.mark.parametrize("T", [96, 5000])
def test_stft_and_mel_losses_match_jax(T):
    rng = np.random.default_rng(T)
    y = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    for port, jax_fn in ((train.stft_loss, jtrain.stft_loss), (train.mel_loss, jtrain.mel_loss)):
        got = port(torch.from_numpy(y), torch.from_numpy(x)).item()
        want = float(jax.jit(jax_fn)(jnp.asarray(y), jnp.asarray(x)))
        assert abs(got - want) <= 1e-5 * abs(want), (port.__name__, got, want)


def test_loss_and_every_gradient_match_jax(case):
    """``loss_fn(spectral=True)`` against JAX's: the metrics, then the
    gradient in its two parts, each where it is well conditioned (below)."""
    jmc, mc, params, run, data = case
    audio = data(0)
    vals, g_wav_j, g_y, g_spec_j = run(params, jnp.asarray(audio))
    codec = _port_codec(params, mc)
    a = torch.from_numpy(audio)
    loss, met = train.loss_fn(codec, a, spectral=True)
    want = dict(zip(("wav_l2", "wav_l1", "stft", "mel"), map(float, vals)))
    want["loss"] = float(np.dot(TOTAL, np.asarray(vals)))
    # the waveform terms within 1e-5; the spectral ones within 1e-4: a
    # 96-sample clip fills each frame mostly with its repeated last sample,
    # whose Hann-windowed spectrum is zero in exact arithmetic above bin 1,
    # so those bins' log magnitudes are the FFTs' roundoff (JAX's and
    # torch's FFTs differ there by 4e-5 of the STFT term on this clip)
    for k, v in met.items():
        tol = 1e-5 if k.startswith("wav") else 1e-4
        assert abs(v.item() - want[k]) <= tol * abs(want[k]), (k, v.item(), want[k])

    # (1) the waveform loss's gradient, every leaf within 1e-4 relative L2
    # (2) the model's VJP of the spectral terms' cotangent dL/dy (JAX's), the
    # same. Leaves that hold roundoff alone (grad_check.negligible: zero in
    # exact arithmetic, as the enhance branches' biases before the instance
    # norm and the position MLP's last bias before the softmax are, or below
    # 1e-6 of the whole gradient's norm): both stay below 1e-6 of that norm.
    # The spectral terms' own gradient in y is
    # held on broadband clips (test_spectral_loss_gradients_match_jax): at
    # the model's low-pass output most bins are near zero and dL/dy is
    # conditioned by roundoff (1/|Y| at a bin of ~1e-6), in JAX as here.
    y = codec(a, training=True)["generated_audio"]
    wav = torch.mean((y - a) ** 2) + 0.1 * torch.mean(torch.abs(y - a))
    params_ = [p for _, p in codec.named_parameters()]
    g_wav = torch.autograd.grad(wav, params_, retain_graph=True)
    g_spec = torch.autograd.grad(y, params_, torch.from_numpy(np.array(g_y)))
    for got, want_g in ((g_wav, _port(g_wav_j, mc)), (g_spec, _port(g_spec_j, mc))):
        scale, zero = scale_of(want_g), negligible(want_g)
        for (name, _), g in zip(codec.named_parameters(), got):
            w = want_g[name]
            if name in zero:
                assert max(g.norm().item(), w.norm().item()) <= 1e-6 * scale, name
            else:
                assert rel_l2(g, w) <= 1e-4, (name, rel_l2(g, w))

    # every parameter has a gradient of the whole loss, all-zero only where
    # JAX's is zero in exact arithmetic
    loss.backward()
    total = _port(jax.tree.map(jnp.add, g_wav_j, g_spec_j), mc)
    names = [n for n, _ in codec.named_parameters()]
    assert set(names) == set(total)
    for name, p in codec.named_parameters():
        assert p.grad is not None, f"{name} has no gradient"
        assert p.grad.abs().sum() > 0 or exact_zero(name), name
    for part in ("decoder.tail_units.0.conv1.weight", "decoder.tail_alpha",
                 "decoder.out_conv.weight", "en_encoder.down_trans.dyn_bias.w1",
                 "en_decoder.up_trans.dyn_bias.b1", "quantizer.proj_in.weight",
                 "quantizer.proj_out.bias", "encoder.first.conv2.weight"):
        assert codec.get_parameter(part).grad.abs().sum() > 0, part


@pytest.mark.parametrize("T,tol", [(96, 1e-3), (5000, 1e-4)])
def test_spectral_loss_gradients_match_jax(T, tol):
    """The STFT and mel terms' gradients in y and x on broadband clips. A
    96-sample clip is framed through the clamp (the repeats carry no
    gradient, as in JAX): its frames' constant part leaves near-zero bins
    whose log-magnitude gradients are conditioned by roundoff (1.3e-4 apart
    on this clip), hence 1e-3 there."""
    rng = np.random.default_rng(T + 1)
    y = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    jf = lambda y, x: jtrain.stft_loss(y, x) + jtrain.mel_loss(y, x)
    gy_j, gx_j = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(y), jnp.asarray(x))
    yt, xt = torch.from_numpy(y).requires_grad_(), torch.from_numpy(x).requires_grad_()
    (train.stft_loss(yt, xt) + train.mel_loss(yt, xt)).backward()
    assert rel_l2(yt.grad, torch.from_numpy(np.asarray(gy_j))) <= tol
    assert rel_l2(xt.grad, torch.from_numpy(np.asarray(gx_j))) <= tol


# -- FSQ's straight-through estimator --------------------------------------

def test_quantize_ste_matches_jax():
    levels = (5, 5, 5)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((2, 7, 3)) * 1.5).astype(np.float32)
    r = rng.standard_normal((2, 7, 3)).astype(np.float32)
    q_j, idx_j, li_j = jfsq.quantize_ste(jnp.asarray(z), levels)
    g_j = jax.grad(lambda z: jnp.sum(jfsq.quantize_ste(z, levels)[0] * r))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    q, idx, li = fsq.quantize_ste(zt, levels)
    (q * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(li.numpy(), np.asarray(li_j))
    # tanh's derivative by each library's formula: 1e-5 relative where
    # 1 - tanh^2 cancels
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-7)
    # eval values: the STE's forward is quantize's up to one fp32 rounding
    q_eval, idx_eval, _ = fsq.quantize(zt.detach(), levels)
    np.testing.assert_array_equal(idx.numpy(), idx_eval.numpy())
    np.testing.assert_allclose(q.detach().numpy(), q_eval.numpy(), atol=1e-6)


def test_quantize_ste_noise():
    levels, rate, n = (7, 7, 7, 7, 7, 7), 0.5, 4000
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 6)).astype(np.float32))
    q0, idx0, _ = fsq.quantize_ste(z, levels)
    q1, idx1, _ = fsq.quantize_ste(z, levels, noise_rate=rate,
                                   generator=droppath.seeded(5, "cpu"))
    q2, _, _ = fsq.quantize_ste(z, levels, noise_rate=rate, generator=droppath.seeded(5, "cpu"))
    q3, _, _ = fsq.quantize_ste(z, levels, noise_rate=rate, generator=droppath.seeded(6, "cpu"))
    assert torch.equal(q1, q2) and not torch.equal(q1, q3)
    assert torch.equal(idx0, idx1)                    # indices from the clean input
    act = (torch.tanh(z) + 1.0) / 2.0
    noised = q1 != q0
    share = noised.float().mean().item()
    sd = (rate * (1 - rate) / z.numel()) ** 0.5
    assert abs(share - rate) <= 5 * sd, share
    # a noised element is act + U(-0.5, 0.5) / L, mapped to [-1, 1]
    dev = ((q1 + 1.0) / 2.0 - act)[noised]
    assert dev.abs().max().item() <= 0.5 / 7 + 1e-6
    assert fsq.quantize_ste(z, levels, noise_rate=rate)[0].equal(q0)   # no generator: inert


# -- drop-path ---------------------------------------------------------------

@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("n", [1, 5])
def test_drop_path_schedule_matches_jax(ascending, n):
    want = [r for r, _ in jdrop.schedule(0.3, n, jax.random.PRNGKey(0), ascending=ascending)]
    got = [r for r, _ in droppath.schedule(0.3, n, droppath.seeded(0, "cpu"),
                                           ascending=ascending)]
    assert got == want
    assert droppath.schedule(0.3, n, None) == [(0.0, None)] * n
    assert droppath.schedule(0.0, n, droppath.seeded(0, "cpu")) == [(0.0, None)] * n


def test_drop_path_mask_is_per_sample_and_scaled():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 3, 5)).astype(np.float32))
    out = droppath.drop_path(x, 0.25, droppath.seeded(1, "cpu"))
    kept = [torch.allclose(o, xi / 0.75) for o, xi in zip(out, x)]
    dropped = [bool((o == 0).all()) for o in out]
    assert all(k != d for k, d in zip(kept, dropped))           # whole samples
    assert 0 < sum(dropped) < 64
    assert droppath.drop_path(x, 0.0, droppath.seeded(1, "cpu")) is x
    assert droppath.drop_path(x, 0.5, None) is x


def test_training_forward_without_rng_is_bit_equal_to_the_plain_forward(case):
    """Rate 0, or no generator: the units' outputs are the plain forward's."""
    _, mc, params, _, data = case
    codec = _port_codec(params, mc)
    audio = torch.from_numpy(data(1))
    with torch.no_grad():
        a = codec(audio, training=True)["generated_audio"]
        b = codec(audio, training=True, drop_path_rate=0.3)["generated_audio"]
        c = codec(audio, training=True, generator=droppath.seeded(2, "cpu"),
                  drop_path_rate=0.0)["indices"]
        d = codec(audio, training=True, generator=droppath.seeded(2, "cpu"),
                  drop_path_rate=0.3)["generated_audio"]
    assert torch.equal(a, b) and not torch.equal(a, d)
    assert c.shape == (BATCH, TOKENS)


# -- Codec.forward's dict ------------------------------------------------------

def test_forward_dict_matches_encode_decode_and_jax_shapes(case):
    jmc, mc, params, _, data = case
    codec = _port_codec(params, mc)
    audio = data(2)[:, :-5]                  # not a hop multiple: padded, then cropped
    a = torch.from_numpy(audio)
    with torch.no_grad():
        out = codec(a, training=False)
        padded = torch.nn.functional.pad(a, (0, 5))
        q, idx = codec.encode(padded)
        y = codec.decode(q)[..., :audio.shape[1]]
    assert torch.equal(out["generated_audio"], y) and torch.equal(out["indices"], idx)
    assert torch.equal(out["hidden_feature"]["quantized_trans_feature"], q)
    shapes = jax.eval_shape(lambda p, x: jc.forward(p, x, jmc, training=True), params,
                            jax.ShapeDtypeStruct(audio.shape, jnp.float32))

    def flat(tree):
        return {k: tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    port = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32), out))[0]}
    assert {k: tuple(v.shape) for k, v in port.items()} == flat(shapes)
    assert out["commit_loss"].shape == () and float(out["commit_loss"]) == 0.0


# -- Adam against optax.adam ----------------------------------------------------

def test_three_adam_steps_match_optax(case):
    """Three Adam steps on the waveform loss (the spectral terms' gradient is
    conditioned by roundoff at this model's output, see above). Each
    package follows its own trajectory; after the first step an entry whose
    gradient sign differs moves by up to 2 lr, so each step's gradient is
    held against JAX's at the port's own parameters, the moments (which sum
    gradients taken at parameters that differ that way) within 1e-3 and the
    parameters within 3 lr."""
    jmc, mc, params, run, data = case
    lr = 1e-3
    opt = optax.adam(lr)
    p = params
    state = opt.init(p)

    @jax.jit
    def update(grads, state, p):      # one small compile, not an op-by-op walk
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    codec = _port_codec(params, mc)
    adam = torch.optim.Adam(codec.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def wav_grads(tree, audio):
        return run(tree, jnp.asarray(audio))[1]

    noisy = set()
    for step in range(3):
        audio = data(step)
        here = wav_grads(weights.to_jax_params(codec.state_dict(), mc), audio)
        grads = here if step == 0 else wav_grads(p, audio)
        p, state = update(grads, state, p)
        codec.zero_grad(set_to_none=True)
        loss, _ = train.loss_fn(codec, torch.from_numpy(audio))
        loss.backward()
        want = weights.from_jax_params(jax.tree.map(np.asarray, here), mc)
        zero = negligible(want)
        noisy |= zero
        for name, t in codec.named_parameters():
            if name not in zero:
                assert rel_l2(t.grad, want[name]) <= 1e-4, (step, name, rel_l2(t.grad, want[name]))
        adam.step()
    mu = weights.from_jax_params(jax.tree.map(np.asarray, state[0].mu), mc)
    nu = weights.from_jax_params(jax.tree.map(np.asarray, state[0].nu), mc)
    final = weights.from_jax_params(jax.tree.map(np.asarray, p), mc)
    for name, t in codec.named_parameters():
        s = adam.state[t]
        # a leaf whose gradient is roundoff alone (at some step), which Adam
        # scales to steps of about lr in either direction: 3 steps of each
        # run, 6 lr apart at most
        noise = name in noisy
        if not noise:
            assert rel_l2(s["exp_avg"], mu[name]) <= 1e-3, (name, rel_l2(s["exp_avg"], mu[name]))
            assert rel_l2(s["exp_avg_sq"], nu[name]) <= 1e-3, name
        bound = (6 if noise else 3) * lr
        assert (t.detach() - final[name]).abs().max().item() <= bound, name
    assert int(state[0].count) == 3
    assert all(adam.state[t]["step"].item() == 3 for t in codec.parameters())


def test_trainer_feeds_equal_jax(tmp_path):
    for step in (0, 5):
        np.testing.assert_array_equal(trainer.SyntheticAudio(2, 100, 3)(step),
                                      jtrainer.SyntheticAudio(2, 100, 3)(step))
    from l3ac_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(0)
    for i, n in enumerate((50, 400, 1000)):
        write_wav(tmp_path / f"c{i}.wav", rng.standard_normal(n) * 0.2, 16000)
    mine = trainer.WavDirAudio(tmp_path, 3, 300, 16000, seed=1)
    theirs = jtrainer.WavDirAudio(tmp_path, 3, 300, 16000, seed=1)
    for step in (0, 1, 7):
        np.testing.assert_array_equal(mine(step), theirs(step))
