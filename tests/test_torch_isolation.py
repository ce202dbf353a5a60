"""The port stands alone: it imports neither JAX nor the JAX package, keeps
byte-identical config copies, and its entry points do not fall back to the
CPU unasked."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import l3ac_tpu_torch
from l3ac_tpu_torch.models.zoo import get_model

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "l3ac_tpu_torch"


def test_import_pulls_in_no_jax():
    code = ("import sys, l3ac_tpu_torch, l3ac_tpu_torch.weights, "
            "l3ac_tpu_torch.ops.kernels.local_attention, l3ac_tpu_torch.models.zoo, "
            "l3ac_tpu_torch.ops.quantized, l3ac_tpu_torch.ops.kernels.int8_matmul, "
            "l3ac_tpu_torch.tools.bisect_kernel, l3ac_tpu_torch.tools.interleave_probe; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'l3ac_tpu' or m.startswith('l3ac_tpu.')]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_sources_name_no_jax():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        src = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), f
        assert not re.search(r"l3ac_tpu(?!_torch)\b(?![/.]\w+\.py)", _code_only(src)), f


def _code_only(src: str) -> str:
    """Drop comments and string literals: the port's docstrings cite the JAX
    files it mirrors (``l3ac_tpu/models/...``), which is not an import."""
    src = re.sub(r'"""[\s\S]*?"""', "", src)
    src = re.sub(r"#.*", "", src)
    return re.sub(r"(\"[^\"\n]*\"|'[^'\n]*')", "", src)


@pytest.mark.parametrize("name", ["0k75bps", "1k5bps", "1kbps", "3kbps", "debug"])
def test_config_copies_equal_the_jax_tomls(name):
    ours = PORT / "configs" / f"{name}.toml"
    theirs = REPO / "l3ac_tpu" / "configs" / f"{name}.toml"
    assert ours.read_bytes() == theirs.read_bytes()
    assert name in l3ac_tpu_torch.list_models()


def test_get_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is then usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("debug", device="cuda")


def test_pretrained_names_the_converter_slice():
    with pytest.raises(NotImplementedError, match="A7"):
        get_model("debug", pretrained=True, device="cpu")
