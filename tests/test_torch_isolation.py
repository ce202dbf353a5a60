"""The port stands alone: it imports neither JAX nor the JAX package, keeps
byte-identical config copies, and its entry points do not fall back to the
CPU unasked."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
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
            "l3ac_tpu_torch.tools.bisect_kernel, l3ac_tpu_torch.tools.interleave_probe, "
            "l3ac_tpu_torch.tools.tc_variants, l3ac_tpu_torch.ops.kernels.tc_gemm, "
            "l3ac_tpu_torch.tools.attention_variants, l3ac_tpu_torch.tools.tail_variants, "
            "l3ac_tpu_torch.runtime.chunk, l3ac_tpu_torch.runtime.convert, "
            "l3ac_tpu_torch.runtime.checkpoint, l3ac_tpu_torch.runtime.native, "
            "l3ac_tpu_torch.runtime.streaming, l3ac_tpu_torch.runtime.scheduler, "
            "l3ac_tpu_torch.profile_serve, "
            "l3ac_tpu_torch.utils.audio_io, "
            "l3ac_tpu_torch.utils.metrics, l3ac_tpu_torch.__main__, "
            "l3ac_tpu_torch.train, l3ac_tpu_torch.trainer, l3ac_tpu_torch.ops.droppath, "
            "l3ac_tpu_torch.utils.debug, l3ac_tpu_torch.grad_check, "
            "l3ac_tpu_torch.ops.kernels.autograd, l3ac_tpu_torch.parallel.mesh, "
            "l3ac_tpu_torch.parallel.distributed, l3ac_tpu_torch.parallel.sp, "
            "l3ac_tpu_torch.parallel.halo, l3ac_tpu_torch.ops.codebook, "
            "l3ac_tpu_torch.models.codec, l3ac_tpu_torch.demo; "
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


@pytest.mark.parametrize("name", ["0k75bps", "1k5bps", "1kbps", "3kbps", "debug"])
def test_key_manifest_copies_equal_the_jax_manifests(name):
    ours = PORT / "configs" / f"{name}.keys.json"
    theirs = REPO / "l3ac_tpu" / "configs" / f"{name}.keys.json"
    assert ours.read_bytes() == theirs.read_bytes()


def test_framer_copy_equals_the_jax_framer_source():
    ours = PORT / "native" / "framer.cpp"
    theirs = REPO / "native" / "framer.cpp"
    assert ours.read_bytes() == theirs.read_bytes()


def test_native_framer_builds_from_the_port_copy():
    from l3ac_tpu_torch.runtime import native
    assert native.SOURCE.resolve().is_relative_to(PORT.resolve())
    assert native.SOURCE.is_file() and native.BUILD_DIR.resolve().is_relative_to(PORT.resolve())


def test_get_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is then usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("debug")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("debug", device="cuda")


def test_pretrained_names_the_converter_slice(tmp_path):
    """pretrained=True reads the reference's files from the config's
    model_path through the converter and never downloads: an empty
    directory raises naming the files."""
    with pytest.raises(FileNotFoundError, match="encoder.pt.*en_decoder.pt.*never downloads"):
        get_model("debug", pretrained=True, device="cpu", model_dir=str(tmp_path))


def test_new_entry_points_raise_without_cuda(tmp_path):
    """StreamCodec needs a model, whose default device is CUDA; the CLI
    runs on CUDA unless given --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is then usable")
    from l3ac_tpu_torch.runtime.streaming import StreamCodec
    from l3ac_tpu_torch.utils.audio_io import write_wav
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamCodec(get_model("debug"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("debug", pretrained=True)
    write_wav(tmp_path / "in.wav", np.zeros(1600, np.float32), 16000)
    cmd = [sys.executable, "-m", "l3ac_tpu_torch", "encode", str(tmp_path / "in.wav"),
           str(tmp_path / "out.npz"), "--model", "debug"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not (tmp_path / "out.npz").exists()
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and (tmp_path / "out.npz").exists(), out.stderr


def test_sp_and_codebook_entry_points_run_where_asked(tmp_path):
    """``encode_sp`` on a default model raises here (its device is CUDA);
    with a CPU model in a gloo process group (of one) it runs, as does
    ``nearest_codes`` on CPU tensors. In a subprocess, so that no process
    group outlives the test."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is then usable")
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import sys, torch\n"
        "from l3ac_tpu_torch.models import codec as fc\n"
        "from l3ac_tpu_torch.models.zoo import get_model\n"
        "from l3ac_tpu_torch.ops.codebook import nearest_codes\n"
        "from l3ac_tpu_torch.parallel import distributed, mesh\n"
        "try:\n"
        "    fc.encode_sp(get_model('debug'), torch.zeros(1, 384), mesh.make_mesh())\n"
        "    sys.exit('no error')\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA is not available' in str(e), e\n"
        f"distributed.initialize('tcp://localhost:{port}', 1, 0, backend='gloo')\n"
        "m = get_model('debug', device='cpu')\n"
        "q, idx = fc.encode_sp(m, torch.zeros(1, fc.sp_time_quantum(m.codec.mc)),\n"
        "                      distributed.multihost_mesh(sp=1))\n"
        "assert torch.distributed.get_backend() == 'gloo'\n"
        "assert q.device.type == 'cpu' and idx.shape == (1, 16)\n"
        "i, d = nearest_codes(torch.zeros(3, 6), torch.eye(6))\n"
        "assert i.device.type == 'cpu' and i.tolist() == [0, 0, 0]\n"
        "distributed.barrier()\n"
        "print('ran')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ran" in out.stdout, out.stderr


def test_demo_runs_on_the_card_unless_asked():
    """``python -m l3ac_tpu_torch.demo`` defaults to CUDA: without a card it
    raises, and only ``--device cpu`` runs the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo's default device runs")
    from l3ac_tpu_torch import demo
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--model", "debug", "--random"])
