"""UpTransV1 (``models.local_transformer.UpTransV1``) against the JAX
package's ``init_up_trans_v1`` / ``up_trans_v1_apply``, at dim 32, depth 2, a
post-interleave window of 16 and rates 2 and 4, fp32 with TF32 off: the
forward within 1e-5, the gradients with respect to the tokens and the input
within 1e-4 of ``jax.grad``, and the converters of a torch-layout state dict
(``runtime.convert.convert_up_trans_v1``) equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l3ac_tpu.models import local_transformer as jlt
from l3ac_tpu.runtime import convert as jconvert
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.local_transformer import TransConfig, UpTransV1
from l3ac_tpu_torch.runtime import convert

DIM, DEPTH, WINDOW = 32, 2, 16


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _pair(rate: int, seed: int):
    """The JAX params, its TransConfig, and the port module carrying them."""
    jtc = jlt.TransConfig(dim=DIM, depth=DEPTH, window_size=WINDOW)
    p = jlt.init_up_trans_v1(jax.random.PRNGKey(seed), jtc, rate)
    m = UpTransV1(TransConfig(dim=DIM, depth=DEPTH, window_size=WINDOW), rate)
    m.load_state_dict(weights.up_trans_v1_state_dict(p))
    m.attach_bias_cache()
    return p, jtc, m


def _x(rate: int, seed: int) -> np.ndarray:
    T = 3 * WINDOW // rate + 1        # the widened sequence is padded to a window multiple
    return (np.random.default_rng(seed).standard_normal((2, T, DIM)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("rate", [2, 4])
def test_forward_matches_jax(rate):
    p, jtc, m = _pair(rate, seed=rate)
    x = _x(rate, 100 + rate)
    want = np.asarray(jlt.up_trans_v1_apply(p, jnp.asarray(x), jtc, rate))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == (2, x.shape[1] * rate, DIM) == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [2, 4])
def test_gradients_match_jax(rate):
    """d/d(tokens, x) of sum(out * g) for a seeded g."""
    p, jtc, m = _pair(rate, seed=10 + rate)
    x = _x(rate, 200 + rate)
    g = np.random.default_rng(300 + rate).standard_normal(
        (2, x.shape[1] * rate, DIM)).astype(np.float32)

    def loss(tokens, xj):
        out = jlt.up_trans_v1_apply({**p, "tokens": tokens}, xj, jtc, rate)
        return jnp.sum(out * g)

    j_tok, j_x = jax.grad(loss, argnums=(0, 1))(p["tokens"], jnp.asarray(x))
    m.bias_cache = None  # the table from the live MLP weights under autograd
    xt = torch.from_numpy(x).requires_grad_(True)
    (m(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(m.tokens.grad.numpy(), np.asarray(j_tok), rtol=0, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_x), rtol=0, atol=1e-4)


def _torch_state_dict(rate: int, seed: int) -> dict:
    """A seeded state dict in the reference's torch layout (``UpTransV1`` of
    ``l3ac/local_trans.py``: ``compressed_tokens.{i}`` and ``trans.*``)."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    d, inner, ff = DIM // 2, 6 * (DIM // 4), int(DIM * 4 * 2 / 3)
    sd = {f"compressed_tokens.{i}": r(1, 1, DIM) for i in range(rate - 1)}
    for seq, (o, i) in zip((0, 2, 4), ((d, 1), (d, d), (6, d))):
        sd[f"trans.dynamic_pos_bias.mlp.{seq}.weight"] = r(o, i)
        sd[f"trans.dynamic_pos_bias.mlp.{seq}.bias"] = r(o)
    for layer in range(DEPTH):
        a, f = f"trans.layers.{layer}.0", f"trans.layers.{layer}.1"
        sd |= {f"{a}.norm.weight": r(DIM), f"{a}.norm.bias": r(DIM),
               f"{a}.to_qkv.weight": r(3 * inner, DIM), f"{a}.to_out.weight": r(DIM, inner),
               f"{f}.0.weight": r(DIM), f"{f}.0.bias": r(DIM),
               f"{f}.1.weight": r(2 * ff, DIM), f"{f}.4.weight": r(DIM, ff)}
    return sd


def _flat(tree, prefix="", out=None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}.", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


@pytest.mark.parametrize("rate", [2, 4])
def test_converter_matches_jax(rate):
    """The port's converter and JAX's on one state dict: every array equal
    (JAX's carried to the port's names and layouts), and the port's tree
    loads strictly into the module."""
    sd = _torch_state_dict(rate, seed=rate)
    ours = _flat(convert.convert_up_trans_v1(sd, DEPTH, rate))
    theirs = {k: v.numpy() for k, v in weights.up_trans_v1_state_dict(
        jconvert.convert_up_trans_v1(sd, DEPTH, rate)).items()}
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    m = UpTransV1(TransConfig(dim=DIM, depth=DEPTH, window_size=WINDOW), rate)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in ours.items()}, strict=True)


def test_window_must_be_a_rate_multiple():
    with pytest.raises(ValueError, match="not a multiple"):
        UpTransV1(TransConfig(dim=DIM, depth=1, window_size=WINDOW), 3)


def test_init_is_seeded():
    a, b = (UpTransV1(TransConfig(dim=DIM, depth=1, window_size=WINDOW), 4) for _ in range(2))
    for m in (a, b):
        m.init_weights(torch.Generator().manual_seed(5))
    assert a.tokens.shape == (3, DIM)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
