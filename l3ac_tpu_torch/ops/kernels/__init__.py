"""Hand-written CUDA kernels for the H100 (``sm_90a``), one for each TPU
kernel of the encode and decode paths, of int8 weight-only inference and of
the two ``tools/`` probes, and their wrappers.

Each wrapper:
- checks device, dtype, shape and contiguity, and raises on what its kernel
  does not take. fp32 and bf16 (``DTYPES``) for every kernel of the codec,
  each dtype its own kernel (no bf16 tensor is cast to fp32 for an fp32
  kernel); bf16 only for the two probe kernels;
- on a CUDA tensor launches its kernel or raises; there is no fallback;
- on a CPU tensor runs the plain PyTorch version in the same module;
- adds one to ``LAUNCHES[name]`` where it launches its kernel, and nowhere
  else, so a run can show that it went through the kernel.
"""

import torch

LAUNCHES: dict[str, int] = {"first_block": 0, "conv_unit_ct": 0,
                            "conv_unit": 0, "local_attention": 0,
                            "up_fused_ct": 0, "up_fused": 0,
                            "legacy_tail_poly_ct": 0, "legacy_tail_ct": 0,
                            "int8_matmul": 0, "interleave": 0,
                            "conv_unit_stages": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the activation dtypes of the codec's kernels: an fp32 and a bf16 variant each
DTYPES = (torch.float32, torch.bfloat16)


def check_input(t: torch.Tensor, name: str, ndim: int | None = None,
                dtype: torch.dtype | tuple[torch.dtype, ...] = torch.float32) -> None:
    """The checks every kernel input passes before its pointer is taken;
    ``dtype`` is the one dtype the kernel takes or a tuple of them."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
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
