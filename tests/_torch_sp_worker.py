"""One gloo rank of the port's sequence-parallel CPU tests.

    python tests/_torch_sp_worker.py RANK WORLD PORT OUT_DIR CASES

Imports torch and the port only. ``CASES`` is a comma list of
``primitives`` (the halo primitives of ``parallel.sp`` / ``parallel.halo``
on a seeded (2, 32, 3) stream), ``codec`` (``encode_sp`` / ``decode_sp`` /
``decode_indices_sp`` of ``debug`` at seed 0 on the meshes (1, 4, 1),
(1, 2, 2) and (2, 2, 1), and ``decode_sp`` with the fp64 tail), ``plain`` (the rate-1 transformer geometry at
sp = 4) and ``nearest`` (``sharded_nearest_codes`` over the ranks); the
inputs are made from fixed seeds here and in the test, so both hold the
same. Each rank writes its results to ``OUT_DIR/rank<RANK>.pt``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from l3ac_tpu_torch.config import ModelConfig, VQConfig  # noqa: E402
from l3ac_tpu_torch.models import codec as fc  # noqa: E402
from l3ac_tpu_torch.models.zoo import get_model  # noqa: E402
from l3ac_tpu_torch.ops import codebook  # noqa: E402
from l3ac_tpu_torch.ops.conv import conv1d  # noqa: E402
from l3ac_tpu_torch.parallel import distributed as pd  # noqa: E402
from l3ac_tpu_torch.parallel import halo, sp  # noqa: E402
from l3ac_tpu_torch.parallel import mesh as pm  # noqa: E402

PRIM_SHAPE = (2, 32, 3)
CODEC_B = 2
CODEC_SHARDS = 4          # the stream spans 4 quanta
# the rate-1 transformer geometry of tests/test_parallel.py:190-214
PLAIN_MC = ModelConfig(
    feature_dim=32, compress_rates=(4, 3), encoder_dims=(8, 12, 16),
    encoder_depths=(1, 1, 1), decode_rates=(3, 2, 2), decoder_dims=(16, 12, 8, 8),
    decoder_depths=(1, 1, 1, 1), decoder_last_layer="legacy", vq=VQConfig(levels=(5, 5, 5)),
    en_coder_depth=3, en_coder_window_size=16, en_coder_dynamic_pos=True,
    en_coder_compress_rate=1)
NEAREST = (1000, 6, 64)   # codebook rows, d, queries


def prim_input() -> np.ndarray:
    return np.random.default_rng(5).standard_normal(PRIM_SHAPE).astype(np.float32)


def conv_weight() -> np.ndarray:
    """A k9 conv for sp_apply (receptive field 8 to the left when causal-cropped)."""
    return np.random.default_rng(6).standard_normal((3, 3, 9)).astype(np.float32) * 0.3


def codec_audio(mc) -> np.ndarray:
    T = fc.sp_time_quantum(mc) * CODEC_SHARDS
    return (np.random.default_rng(7).standard_normal((CODEC_B, T)) * 0.3).astype(np.float32)


def plain_codec():
    from l3ac_tpu_torch.models.codec import Codec
    c = Codec(PLAIN_MC)
    c.init_weights(torch.Generator().manual_seed(1))
    c.attach_bias_caches()
    return c.eval()


def nearest_inputs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(8)
    n, d, m = NEAREST
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


def _block(t: torch.Tensor, i: int, n: int, dim: int) -> torch.Tensor:
    L = t.shape[dim] // n
    return t.narrow(dim, i * L, L).contiguous()


def run_primitives(mesh) -> dict:
    x = _block(torch.from_numpy(prim_input()), mesh.coords["sp"], mesh.shape["sp"], 1)
    w = torch.from_numpy(conv_weight())
    out = {}
    with sp.sequence_parallel(mesh, "sp"):
        out["halo_blocks"] = sp.halo_blocks(x, 3, 2, axis=1, fill=-1.5)
        out["pad_time"] = sp.pad_time(x, 3, 3, axis=1, fill=0.5)
        out["shift_right"] = sp.shift_right(x, axis=1)
        out["shift_left"] = sp.shift_left(x, axis=1)
        out["psum"] = sp.psum_if_active((x * x).sum(dim=1))
        out["edge_flags"] = sp.edge_flags()
        out["halo_exchange"] = halo.halo_exchange(x, left=2, right=1)
        # a causal k9 conv: its receptive field is the 8 frames on the left
        out["sp_apply"] = halo.sp_apply(
            lambda h: conv1d(torch.nn.functional.pad(h.transpose(1, 2), (8, 0)), w)
            .transpose(1, 2), x, halo_in=8)
        try:
            sp.halo_blocks(x, x.shape[1] + 1, 0, axis=1)
            out["too_wide"] = None
        except ValueError as e:
            out["too_wide"] = str(e)
    return out


def run_codec(model, audio: np.ndarray, mesh) -> dict:
    mc = model.mc
    a = torch.from_numpy(audio)
    if mesh.shape["dp"] > 1:
        a = _block(a, mesh.coords["dp"], mesh.shape["dp"], 0)
    a = _block(a, mesh.coords["sp"], mesh.shape["sp"], 1)
    batch_axis = "dp" if mesh.shape["dp"] > 1 else None
    q, idx = fc.encode_sp(model, a, mesh, batch_axis=batch_axis)
    y = fc.decode_sp(model, q, mesh, batch_axis=batch_axis)
    y_idx = fc.decode_indices_sp(model, idx, mesh, batch_axis=batch_axis)
    y64 = fc.decode_sp(model, q, mesh, batch_axis=batch_axis, tail_high_precision=True)
    errors = {}
    try:
        fc.encode_sp(model, a[:, :-mc.hop_length], mesh)
    except ValueError as e:
        errors["length"] = str(e)
    return {"q": q, "idx": idx, "y": y, "y_idx": y_idx, "y64": y64, "errors": errors,
            "coords": dict(mesh.coords)}


def main() -> int:
    rank, world, port, out, cases = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                     Path(sys.argv[4]), sys.argv[5].split(","))
    torch.set_num_threads(1)
    pd.initialize(f"tcp://localhost:{port}", world, rank, backend="gloo")
    res = {}
    mesh = pm.make_mesh(1, world, 1)
    if "primitives" in cases:
        res["primitives"] = run_primitives(mesh)
    if "codec" in cases:
        model = get_model("debug", device="cpu", seed=0).codec
        audio = codec_audio(model.mc)
        res["codec"] = {(1, 4, 1): run_codec(model, audio, mesh)}
        for shape in ((1, 2, 2), (2, 2, 1)):
            res["codec"][shape] = run_codec(model, audio, pm.make_mesh(*shape))
    if "plain" in cases:
        res["plain"] = run_codec(plain_codec(), codec_audio(PLAIN_MC), mesh)
    if "nearest" in cases:
        cb, q = nearest_inputs()
        shard = _block(torch.from_numpy(cb), rank, world, 0)
        res["nearest"] = codebook.sharded_nearest_codes(torch.from_numpy(q), shard, mesh,
                                                        axis_name="sp")
    torch.save(res, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
