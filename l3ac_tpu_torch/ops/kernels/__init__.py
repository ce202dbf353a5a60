"""Hand-written CUDA kernels for the H100 (``sm_90a``), one for each TPU
kernel of the encode and decode paths, of int8 weight-only inference and of
the two ``tools/`` probes, and their wrappers.

Each wrapper:
- checks device, dtype, shape and contiguity, and raises on what its kernel
  does not take. fp32 and bf16 (``DTYPES``) for every kernel of the codec,
  each dtype its own kernel (no bf16 tensor is cast to fp32 for an fp32
  kernel); bf16 only for the two probe kernels;
- on a CUDA tensor launches its kernel or raises; there is no fallback;
- on a CPU tensor runs the plain PyTorch version in the same module (which
  also takes float64 there where the kernel takes fp32: a reference for
  fp32's roundoff, as the training checks use it);
- adds one to ``LAUNCHES[name]`` where it launches its kernel, and nowhere
  else, so a run can show that it went through the kernel.

Sequence parallelism (``parallel.sp``): the wrappers of the conv kernels take
JAX's halo operands (``lh`` / ``rh``, and ``edges`` where the kernel pads per
layer). Where a kernel has no halo operand of its own, the wrapper stages
``[lh | x | rh]`` into one buffer (:func:`stage_halos`), runs the kernel or
its plain version on it as a local call and crops the halo frames' outputs
(:func:`crop_halos`). That is exact: every kernel pads or clamps only at the
ends of its buffer, each halo is at least the kernel's receptive field, and
on the globally first (last) shard no left (right) halo is staged, so the
kernel's own padding there is the monolithic one.
"""

import torch

from ...parallel import sp

LAUNCHES: dict[str, int] = {"first_block": 0, "conv_unit_ct": 0,
                            "conv_unit": 0, "local_attention": 0,
                            "up_fused_ct": 0, "up_fused": 0,
                            "legacy_tail_poly_ct": 0, "legacy_tail_ct": 0,
                            "int8_matmul": 0, "interleave": 0,
                            "conv_unit_stages": 0}


# the launches of the tensor-parallel operand modes (``parallel.tp``), also
# counted in LAUNCHES
TP_LAUNCHES: dict[str, int] = {"conv_unit_ct": 0, "conv_unit": 0, "local_attention": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, TP_LAUNCHES):
        for name in counts:
            counts[name] = 0


# the activation dtypes of the codec's kernels: an fp32 and a bf16 variant each
DTYPES = (torch.float32, torch.bfloat16)


def check_input(t: torch.Tensor, name: str, ndim: int | None = None,
                dtype: torch.dtype | tuple[torch.dtype, ...] = torch.float32) -> None:
    """The checks every kernel input passes before its pointer is taken;
    ``dtype`` is the one dtype the kernel takes or a tuple of them. A CPU
    tensor, which only the plain version sees, may be float64 where fp32 is
    taken."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    plain64 = t.dtype == torch.float64 and t.device.type == "cpu" and torch.float32 in dtypes
    if t.dtype not in dtypes and not plain64:
        raise TypeError(f"{name}: {', '.join(map(str, dtypes))} only, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def route(x: torch.Tensor, name: str) -> bool:
    """True when ``x`` is on a CUDA device (launch the kernel), False on the
    CPU (run the plain version); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {x.device}")


def check_cuda(ts: dict, device: torch.device,
               dtype: torch.dtype | tuple[torch.dtype, ...] = torch.float32) -> None:
    """Every operand of a launch is a contiguous ``dtype`` tensor on ``device``."""
    for name, t in ts.items():
        if t is None:
            continue
        check_input(t, name, dtype=dtype)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stage_halos(x: torch.Tensor, lh: torch.Tensor | None, rh: torch.Tensor | None,
                edges: tuple[int, int] | None = None, axis: int = -1
                ) -> tuple[torch.Tensor, int, int]:
    """``[lh | x | rh]`` along time axis ``axis``, leaving out ``lh`` where
    ``edges[0]`` (the globally first shard) and ``rh`` where ``edges[1]``;
    -> (buffer, left frames staged, right frames staged)."""
    use_l = lh is not None and not (edges is not None and int(edges[0]))
    use_r = rh is not None and not (edges is not None and int(edges[1]))
    if not (use_l or use_r):
        return x, 0, 0
    parts = ([lh.to(x.dtype)] if use_l else []) + [x] + ([rh.to(x.dtype)] if use_r else [])
    return (torch.cat(parts, dim=axis), lh.shape[axis] if use_l else 0,
            rh.shape[axis] if use_r else 0)


def crop_halos(y: torch.Tensor, left: int, right: int, axis: int = -1) -> torch.Tensor:
    """``y`` without ``left`` / ``right`` frames at the ends of ``axis``."""
    if not (left or right):
        return y
    return y.narrow(axis, left, y.shape[axis] - left - right)


def halo_call(fn, x: torch.Tensor, lh, rh, edges=None, *, axis: int = -1,
              out_axis: int = -1, scale: int = 1):
    """``fn`` on the staged buffer of x with SP suspended, the result (or
    each result of a tuple) cropped by the staged frames times ``scale``
    along ``out_axis``."""
    if lh is None and rh is None:
        return fn(x)
    buf, left, right = stage_halos(x, lh, rh, edges, axis)
    with sp.suspended():
        y = fn(buf)
    if isinstance(y, tuple):
        return tuple(crop_halos(t, left * scale, right * scale, out_axis) for t in y)
    return crop_halos(y, left * scale, right * scale, out_axis)
