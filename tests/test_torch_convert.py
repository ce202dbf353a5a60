"""The port's checkpoint converter and ``.npz`` checkpoints against the JAX
package's (``l3ac_tpu.runtime.convert`` / ``checkpoint``), on seeded
reference-layout state dicts built from the five key manifests (no released
checkpoint is needed), and the two models on one converted ``debug``
checkpoint.

The converter must be bit-equal to ``from_jax_params(convert_checkpoint(sd))``
on every tensor. Encode indices are equal; decoded audio within
1e-4 x max(1, max |want|), the tolerance of ``test_torch_decode.py``.
"""

import socket
import urllib.request

import numpy as np
import pytest
import torch

import jax

from l3ac_tpu.config import get_config as jax_config
from l3ac_tpu.models import zoo as jz
from l3ac_tpu.runtime import checkpoint as jck
from l3ac_tpu.runtime import convert as jcv
from l3ac_tpu_torch import weights
from l3ac_tpu_torch.config import get_config
from l3ac_tpu_torch.models.zoo import get_model
from l3ac_tpu_torch.runtime import checkpoint, convert

NAMES = ("0k75bps", "1k5bps", "1kbps", "3kbps", "debug")


def _numpy(sds):
    return {m: {k: v.numpy() for k, v in sd.items()} for m, sd in sds.items()}


@pytest.fixture(scope="module")
def debug_dir(tmp_path_factory):
    """A seeded debug checkpoint written as the reference's five .pt files."""
    sds = convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=3)
    return convert.write_state_dicts(sds, tmp_path_factory.mktemp("debug_ckpt"))


@pytest.mark.parametrize("name", NAMES)
def test_converter_is_bit_equal_to_jax(name):
    sds = _numpy(convert.seeded_state_dicts(convert.load_key_manifest(name), seed=1))
    mc = get_config(name).network_config
    mine = convert.convert_checkpoint(sds, mc, strict=True)
    theirs = weights.from_jax_params(
        jcv.convert_checkpoint(sds, jax_config(name).network_config, strict=True), mc)
    assert mine.keys() == theirs.keys()
    for k, t in theirs.items():
        assert mine[k].dtype == t.dtype == torch.float32, k
        assert torch.equal(mine[k], t), k
    folded = sum(k.endswith(".original0") for sd in sds.values() for k in sd)
    assert folded > 0
    if name == "1kbps":   # the manifest's values less one gain per folded row
        assert sum(t.numel() for t in mine.values()) == 11_250_879


def test_strict_errors_name_the_key_as_jax_does():
    sds = _numpy(convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=2))
    mc, jmc = get_config("debug").network_config, jax_config("debug").network_config
    key = "blocks.1.0.module.pw_conv1.parametrizations.weight.original1"
    missing = {**sds, "encoder": {k: v for k, v in sds["encoder"].items() if k != key}}
    with pytest.raises(KeyError) as mine:
        convert.convert_checkpoint(missing, mc)
    with pytest.raises(KeyError) as theirs:
        jcv.convert_checkpoint(missing, jmc)
    assert "'encoder'" in str(mine.value) and key in str(mine.value)
    assert str(mine.value) == str(theirs.value)

    extra = {**sds, "decoder": {**sds["decoder"], "stray.weight": np.zeros(3, np.float32),
                                "blocks.99.bias": np.zeros(2, np.float32)}}
    with pytest.raises(ValueError) as mine:
        convert.convert_checkpoint(extra, mc, strict=True)
    with pytest.raises(ValueError) as theirs:
        jcv.convert_checkpoint(extra, jmc, strict=True)
    assert "decoder: 2/" in str(mine.value) and "stray.weight" in str(mine.value)
    assert str(mine.value) == str(theirs.value)
    convert.convert_checkpoint(extra, mc)          # not strict: the extra keys are ignored


def test_validate_manifest_lists_what_jax_lists():
    manifest = convert.load_key_manifest("debug")
    assert manifest == jcv.load_key_manifest("debug")
    sds = _numpy(convert.seeded_state_dicts(manifest, seed=4))
    assert convert.validate_manifest(sds, manifest) == []
    bad = {m: dict(sd) for m, sd in sds.items() if m != "quantizer"}
    bad["encoder"].pop("blocks.0.conv_1.bias")
    bad["decoder"]["extra.key"] = np.zeros(1, np.float32)
    bad["en_encoder"]["local_trans.layers.0.0.norm.weight"] = np.zeros(7, np.float32)
    mine = convert.validate_manifest(bad, manifest)
    assert sorted(mine) == sorted(jcv.validate_manifest(bad, manifest))
    text = "\n".join(mine)
    for part in ("quantizer: module state dict missing", "blocks.0.conv_1.bias",
                 "unexpected keys: extra.key", "shape [7] != manifest [32]"):
        assert part in text


def test_pt_files_round_trip_and_convert_strictly(debug_dir):
    sds = convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=3)
    for m, sd in sds.items():
        back = convert.load_torch_state_dict(debug_dir / f"{m}.pt")
        assert back.keys() == sd.keys()
        for k, v in sd.items():
            assert back[k].dtype == np.float32 and np.array_equal(back[k], v.numpy()), k
    mc = get_config("debug").network_config
    from_dir = convert.convert_model_dir(debug_dir, mc, config_name="debug")
    direct = convert.convert_checkpoint(_numpy(sds), mc, strict=True)
    assert all(torch.equal(from_dir[k], direct[k]) for k in direct)


def test_npz_checkpoints_load_across_packages(tmp_path):
    mc, jmc = get_config("debug").network_config, jax_config("debug").network_config
    model = get_model("debug", device="cpu", seed=7)
    state = model.codec.state_dict()
    checkpoint.save_params(tmp_path / "port.npz", state, mc)
    jtree = jck.load_params(tmp_path / "port.npz")
    again = checkpoint.load_params(tmp_path / "port.npz", mc)
    assert all(torch.equal(again[k], state[k]) for k in state)

    sds = _numpy(convert.seeded_state_dicts(convert.load_key_manifest("debug"), seed=5))
    jparams = jcv.convert_checkpoint(sds, jmc, strict=True)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_j]     # the same tree, no caches
    assert all(np.shape(a) == np.shape(b) for (_, a), (_, b) in zip(flat_p, flat_j))
    np.testing.assert_array_equal(np.asarray(jtree["encoder"]["first"]["conv2"]["w"]),
                                  state["encoder.first.conv2.weight"].numpy().transpose(2, 1, 0))

    jck.save_params(tmp_path / "jax.npz", jparams)
    mine = checkpoint.load_params(tmp_path / "jax.npz", mc)
    want = convert.convert_checkpoint(sds, mc, strict=True)
    assert mine.keys() == want.keys()
    assert all(torch.equal(mine[k], want[k]) for k in want)

    with pytest.raises(KeyError, match="missing"):
        weights.to_jax_params({k: v for k, v in state.items() if "pw1" not in k}, mc)


def test_jax_and_port_models_agree_on_one_converted_checkpoint(debug_dir):
    jmc = jax_config("debug").network_config
    jmodel = jz.L3AC(jax_config("debug"),
                     params=jcv.convert_model_dir(debug_dir, jmc, config_name="debug"))
    model = get_model("debug", device="cpu", seed=9).load_pretrained(debug_dir)
    hop = model.mc.hop_length
    audio = (np.random.default_rng(0).standard_normal((2, hop * 30 - 11)) * 0.3).astype(np.float32)
    _, idx = model.encode_audio(audio)
    _, jidx = jmodel.encode_audio(audio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want = np.asarray(jmodel.decode_audio(indices=jidx, audio_length=audio.shape[1]))
    got = model.decode_audio(indices=idx, audio_length=audio.shape[1]).numpy()
    assert got.shape == want.shape == audio.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_pretrained_never_downloads_and_names_every_missing_file(tmp_path, monkeypatch, debug_dir):
    def refuse(*a, **k):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    files = [f"{m}.pt" for m in convert.MODULES]
    with pytest.raises(FileNotFoundError) as e:
        get_model("debug", pretrained=True, device="cpu", model_dir=str(tmp_path))
    msg = str(e.value)
    cfg = get_config("debug", model_dir=str(tmp_path))
    assert _listed(msg) == files
    assert str(cfg.model_path) in msg and cfg.resolved_weight_url in msg

    partial = tmp_path / "partial"
    partial.mkdir()
    for f in files[:2]:
        (partial / f).write_bytes((debug_dir / f).read_bytes())
    with pytest.raises(FileNotFoundError) as e:
        get_model("debug", device="cpu").load_pretrained(partial)
    assert _listed(str(e.value)) == files[2:]


def _listed(msg: str) -> list[str]:
    return msg.split("missing checkpoint files ")[1].split(" in ")[0].split(", ")
