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


def test_every_decode_key_is_consumed(npz_tree):
    """decoder and en_decoder load strictly, with their layouts."""
    tree, mc = npz_tree
    sd = weights.from_jax_params(tree, mc)
    names = [k for k in sd if k.startswith(("decoder.", "en_decoder."))]
    assert len(names) > 50 and set(sd) == set(Codec(mc).state_dict())
    dec = tree["decoder"]
    st = dec["stages"][0]
    checks = {
        "decoder.stages.0.enhance.merge.weight": st["enhance"]["merge"]["w"].transpose(2, 1, 0),
        "decoder.stages.0.enhance.in_norm.weight": st["enhance"]["in_norm"]["w"],
        "decoder.stages.0.enhance.base.branches.3.weight":
            st["enhance"]["base"]["branches"][3]["w"].transpose(2, 1, 0),
        "decoder.stages.0.up_conv.weight": st["up_conv"]["w"].transpose(2, 1, 0),
        "decoder.tail_units.2.conv1.weight": dec["tail_units"][2]["conv1"]["w"].transpose(2, 1, 0),
        "decoder.tail_units.2.alpha2": dec["tail_units"][2]["alpha2"],
        "decoder.tail_alpha": dec["tail_alpha"],
        "decoder.out_conv.weight": dec["out_conv"]["w"].transpose(2, 1, 0),
        "en_decoder.up_trans.layers.1.ff.w1.weight":
            tree["en_decoder"]["up_trans"]["layers"][1]["ff"]["w1"]["w"].T,
    }
    for name, want in checks.items():
        np.testing.assert_array_equal(sd[name].numpy(), want)
    assert sd["decoder.stages.0.enhance.merge.weight"].shape == (mc.decoder_dims[0], 4, 1)
    assert sd["decoder.out_conv.weight"].shape == (1, mc.decoder_dims[-1], 7)


def test_stray_key_in_the_decoder_raises(npz_tree):
    tree, mc = npz_tree
    dec = dict(tree["decoder"], stray={"w": np.zeros((1, 2, 3), np.float32)})
    with pytest.raises(KeyError, match="decoder.stray.weight"):
        weights.from_jax_params(dict(tree, decoder=dec), mc)
    missing = {k: v for k, v in tree.items() if k != "en_decoder"}
    with pytest.raises(KeyError, match="en_decoder"):
        weights.from_jax_params(missing, mc)


def test_plain_en_encoder_config_keys():
    """3kbps uses the plain (uncompressed) transformer stacks, en_encoder and
    en_decoder."""
    mc = get_config("3kbps").network_config
    assert not mc.uses_compressed_transformer
    sd = weights.from_jax_params(jc.init_codec(jax.random.PRNGKey(1), mc), mc)
    Codec(mc).load_state_dict(sd, strict=True)
