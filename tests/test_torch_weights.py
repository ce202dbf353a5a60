"""The weight bridge: JAX init_codec -> save_params (npz) -> the port's
load_npz -> from_jax_params -> a strict load into the port's Codec."""

import numpy as np
import pytest
import torch

import jax

from l3ac_tpu.config import get_config
from l3ac_tpu.models import codec as jc
from l3ac_tpu.runtime.checkpoint import save_params
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.models.codec import Codec


@pytest.fixture(scope="module")
def npz_tree(tmp_path_factory):
    mc = get_config("debug").network_config
    path = tmp_path_factory.mktemp("ckpt") / "debug.npz"
    save_params(path, jc.init_codec(jax.random.PRNGKey(0), mc))
    return weights.load_npz(path), mc


def test_every_encode_key_is_consumed(npz_tree):
    tree, mc = npz_tree
    sd = weights.from_jax_params(tree, mc)
    codec = Codec(mc)
    codec.load_state_dict(sd, strict=True)
    assert set(sd) == set(codec.state_dict())
    # layouts: conv (K, Cin/g, Cout) -> (Cout, Cin/g, K); linear (Cin, Cout) -> (Cout, Cin)
    dw = tree["encoder"]["stages"][0]["units"][0]["dw"]["w"]
    np.testing.assert_array_equal(sd["encoder.stages.0.units.0.dw.weight"].numpy(),
                                  dw.transpose(2, 1, 0))
    qkv = tree["en_encoder"]["down_trans"]["layers"][0]["attn"]["qkv"]["w"]
    np.testing.assert_array_equal(
        sd["en_encoder.down_trans.layers.0.attn.qkv.weight"].numpy(), qkv.T)


def test_bias_cache_leaves_are_recomputed_not_loaded(npz_tree):
    tree, mc = npz_tree
    tree = dict(tree, en_encoder=dict(tree["en_encoder"]))
    tree["en_encoder"]["post_trans"] = dict(tree["en_encoder"]["post_trans"],
                                            bias_cache=np.zeros((6, 16, 32), np.float32))
    assert set(weights.from_jax_params(tree, mc)) == set(Codec(mc).state_dict())


def test_stray_key_in_an_encode_subtree_raises(npz_tree):
    tree, mc = npz_tree
    tree = dict(tree, encoder=dict(tree["encoder"], stray={"w": np.zeros((1, 2, 3))}))
    with pytest.raises(KeyError, match="encoder.stray.weight"):
        weights.from_jax_params(tree, mc)


def test_missing_key_wrong_shape_and_unknown_subtree_raise(npz_tree):
    tree, mc = npz_tree
    q = dict(tree["quantizer"])
    del q["proj_out"]
    with pytest.raises(KeyError, match="quantizer.proj_out"):
        weights.from_jax_params(dict(tree, quantizer=q), mc)
    enc = dict(tree["encoder"], out_conv={"w": np.zeros((3, 16, 7), np.float32),
                                          "b": np.zeros((7,), np.float32)})
    with pytest.raises(ValueError, match="out_conv.weight"):
        weights.from_jax_params(dict(tree, encoder=enc), mc)
    with pytest.raises(KeyError, match="unknown"):
        weights.from_jax_params(dict(tree, extra={}), mc)


def test_decoder_subtrees_are_skipped(npz_tree):
    tree, mc = npz_tree
    without = {k: v for k, v in tree.items() if k not in ("decoder", "en_decoder")}
    a, b = weights.from_jax_params(tree, mc), weights.from_jax_params(without, mc)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_plain_en_encoder_config_keys():
    """3kbps uses the plain (uncompressed) transformer stack."""
    mc = get_config("3kbps").network_config
    assert not mc.uses_compressed_transformer
    sd = weights.from_jax_params(jc.init_codec(jax.random.PRNGKey(1), mc), mc)
    Codec(mc).load_state_dict(sd, strict=True)
