"""The port's two probe kernels (``interleave``, ``conv_unit_stages``) and
tool entry points against the repo's TPU probes ``tools/test_interleave.py``
and ``tools/bisect_kernel.py``, run on the CPU with their Pallas kernels in
interpret mode; the wrappers run their plain versions here.

The probes are scripts, not modules of a package: each is loaded by path. At
import both set a persistent JAX compilation cache directory; the fixtures
put the two settings back before anything compiles, so no test writes there.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from l3ac_tpu_torch.ops.kernels import conv_unit_stages as cs
from l3ac_tpu_torch.ops.kernels import interleave as il
from l3ac_tpu_torch.tools import bisect_kernel as port_bisect
from l3ac_tpu_torch.tools import interleave_probe as port_interleave

REPO = Path(__file__).resolve().parents[1]
STAGE_TOL = 2.0 ** -6  # max abs error <= STAGE_TOL * max(1, max |probe|): ~2 bf16 ulps
EXACT_MODES = ("copy", "halo_only", "dw")
CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _load_probe(name: str):
    """Import tools/<name>.py by path, undo its cache settings, and make its
    pallas_call run in interpret mode (the module's own ``pl``, nothing global)."""
    saved = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                   BlockSpec=pl.BlockSpec, program_id=pl.program_id)
    return mod


def _bf16_bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array (JAX) or tensor (torch)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _torch_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).bfloat16()


# --- conv_unit_stages against tools/bisect_kernel.py -----------------------

B, C, T = 2, 8, 256
TILES = (64, 128)


@pytest.fixture(scope="module")
def bisect_runs():
    """Per tile: the probe's output of each mode (``make`` at (2, 8, 256), its
    own inputs) and the port tool's ``run`` on the same arrays."""
    probe = _load_probe("bisect_kernel")
    # make()'s weights, rebuilt with its jax.random calls (bisect_kernel.py:84-87)
    dtype = jnp.bfloat16
    dww = jax.random.normal(jax.random.PRNGKey(1), (C, 7), dtype)
    w1t = jax.random.normal(jax.random.PRNGKey(2), (4 * C, C), dtype) * 0.05
    w2t = jax.random.normal(jax.random.PRNGKey(3), (C, 4 * C), dtype) * 0.05
    runs = {}
    for tile in TILES:
        want, x = {}, None
        for mode in cs.MODES:
            run, x = probe.make(B, C, T, tile, mode)
            want[mode] = np.asarray(run(x).astype(jnp.float32))
        # bf16 -> fp32 -> bf16 is exact: the probe's arrays pass through as they are
        inp = port_bisect.StageInputs(*(_torch_bf16(a.astype(jnp.float32))
                                        for a in (x, dww, w1t, w2t)))
        runs[tile] = (want, port_bisect.run(inp, tile), inp)
    return runs


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", cs.MODES)
def test_stages_match_the_probe(bisect_runs, mode, tile):
    want, got, _ = bisect_runs[tile]
    g = got[mode]
    assert g.dtype == torch.bfloat16 and g.shape == (B, C, T)
    g, w = g.float().numpy(), want[mode]
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(g, w)
    else:
        err = np.abs(g - w).max()
        assert err <= STAGE_TOL * max(1.0, np.abs(w).max()), (err, (g == w).mean())


def test_stage_tile_is_part_of_the_result(bisect_runs):
    """dw and dw_mm pad every tile with zeros (the probe's tile-local
    jnp.pad), so tile 64 and tile 128 differ within 3 columns of 64 and 192;
    full reads the neighbouring tiles and does not depend on the tile."""
    (_, g64, _), (_, g128, _) = bisect_runs[64], bisect_runs[128]
    near = np.zeros(T, bool)
    for edge in (64, 192):
        near[edge - 3:edge + 3] = True
    for mode in ("dw", "dw_mm"):
        diff = (g64[mode] != g128[mode]).any(dim=(0, 1)).numpy()
        assert diff[near].any() and not diff[~near].any(), mode
    assert torch.equal(g64["full"], g128["full"])


def test_stage_tile_of_the_whole_length_pads_only_the_ends(bisect_runs):
    """dw at tile = T is the depthwise conv with zero pads at 0 and T alone,
    which full uses at any tile."""
    _, _, inp = bisect_runs[64]
    x, dww = inp.x.float(), inp.dww.float()
    xpad = torch.nn.functional.pad(x, (3, 3))
    ref = torch.zeros_like(x)
    for k in range(7):
        ref = ref + xpad[..., k:k + T] * dww[:, k:k + 1]
    assert torch.equal(cs.conv_unit_stages_plain(*inp, T, "dw"), ref.bfloat16())
    assert torch.equal(cs.conv_unit_stages_plain(*inp, T, "full"),
                       cs.conv_unit_stages_plain(*inp, 64, "full"))


# --- interleave against tools/test_interleave.py ---------------------------

S_PROBE, NT_PROBE, SCALE = 3840, 20, 2  # test_interleave.py:56-59
COVERED = SCALE * NT_PROBE * S_PROBE     # output columns its grid writes: 153600 of 159840


@pytest.fixture(scope="module")
def interleave_runs():
    """The probe's main() once: each strategy's (fn, x, want) captured through
    its ``expect`` and run here; the port tool's ``run`` on the same x."""
    probe = _load_probe("test_interleave")
    captured = []
    probe.expect = lambda tag, fn, x, want: captured.append((tag, fn, x, want))
    probe.main()
    assert [c[0] for c in captured] == [s[0] for s in port_interleave.STRATEGIES]
    x_lane = captured[0][2]
    ops = port_interleave.operands(
        torch.from_numpy(_bf16_bits(x_lane).view(np.int16).copy()).view(torch.bfloat16))
    ours = port_interleave.run(ops)
    return {tag: (np.asarray(jax.jit(fn)(x)), want, ours[tag]) for tag, fn, x, want in captured}


def _columns(a, tag, sl):
    """Output columns ``sl`` along the interleaved axis (T s)."""
    return a[:, sl] if "subl" in tag else a[..., sl]


@pytest.mark.parametrize("tag", [s[0] for s in port_interleave.STRATEGIES])
def test_interleave_matches_the_probe_on_its_covered_columns(interleave_runs, tag):
    probe_out, _, ours = interleave_runs[tag]
    cov = slice(0, COVERED)
    np.testing.assert_array_equal(_columns(_bf16_bits(ours), tag, cov),
                                  _columns(_bf16_bits(probe_out), tag, cov))


@pytest.mark.parametrize("tag", [s[0] for s in port_interleave.STRATEGIES])
def test_interleave_is_the_full_repeat(interleave_runs, tag):
    """The port against the probe's ``want`` (np.repeat over the whole T)."""
    _, want, ours = interleave_runs[tag]
    assert ours.shape == want.shape == ((8, 24, 159840) if "lane" in tag else (8, 159840, 24))
    np.testing.assert_array_equal(ours.float().numpy(), want)


def test_interleave_probe_leaves_its_tail_unwritten(interleave_runs):
    """T // S = 20 tiles of 3840 cover 76800 of the 79920 input columns: the
    probe's last 6240 output columns are never written (NaN in interpret
    mode), so its own allclose check cannot pass (ROADMAP C)."""
    for tag, (probe_out, want, _) in interleave_runs.items():
        tail = _columns(probe_out, tag, slice(COVERED, None)).astype(np.float32)
        assert tail.shape[1 if "subl" in tag else 2] == 6240
        assert np.isnan(tail).all(), tag
        assert not np.allclose(probe_out.astype(np.float32), want, atol=1e-2)


@pytest.mark.parametrize("s", [1, 2, 3, 5])
@pytest.mark.parametrize("channels_last", [False, True])
def test_interleave_plain_is_np_repeat(s, channels_last):
    x = np.random.default_rng(s).standard_normal((2, 5, 7)).astype(np.float32)
    got = il.interleave(_torch_bf16(x), s, channels_last=channels_last, packed=True)
    want = np.repeat(_torch_bf16(x).float().numpy(), s, axis=1 if channels_last else 2)
    np.testing.assert_array_equal(got.float().numpy(), want)


# --- wrapper checks and the tool entry points ------------------------------

def test_probe_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    w = (torch.zeros(8, 7, dtype=torch.bfloat16), torch.zeros(32, 8, dtype=torch.bfloat16),
         torch.zeros(8, 32, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        il.interleave(x.float(), 2)
    with pytest.raises(TypeError, match="bfloat16"):
        cs.conv_unit_stages(x.float(), *w, 32, "dw")
    with pytest.raises(TypeError, match="bfloat16"):
        cs.conv_unit_stages(x, *w[:2], w[2].float(), 32, "mm")
    with pytest.raises(ValueError, match="multiple of tile"):
        cs.conv_unit_stages(x, *w, 48, "full")
    with pytest.raises(ValueError, match="not one of"):
        cs.conv_unit_stages(x, *w, 32, "gelu")
    with pytest.raises(ValueError, match="do not match"):
        cs.conv_unit_stages(x, w[0], w[2], w[1], 32, "mm")


def test_bisect_tool_prints_the_probe_lines_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(port_bisect, "SHAPES", ((2, 8, 256), (1, 24, 200)))
    monkeypatch.setattr(port_bisect, "TILES", (64, 100))  # 100 divides only T = 200
    monkeypatch.setattr(port_bisect, "ITERS", 1)
    assert port_bisect.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[cpu")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["B2 C  8 T256 S64", "B1 C 24 T200 S100"]
    assert all(f" {m}=" in ln or ln.split(": ")[1].startswith(f"{m}=")
               for ln in lines[1:] for m in cs.MODES)


def test_interleave_tool_prints_the_probe_lines_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(port_interleave, "SHAPE", (2, 24, 100))
    monkeypatch.setattr(port_interleave, "ITERS", 1)
    assert port_interleave.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()[1:]
    assert [ln.split(":")[0] for ln in lines] == [s[0] for s in port_interleave.STRATEGIES]
    assert all(": OK " in ln and ln.endswith(" ms") for ln in lines)


@pytest.mark.parametrize("tool", [port_bisect, port_interleave])
def test_tools_run_on_cuda_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is then usable")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main([])
