"""Hand-written CUDA kernels for the H100 (``sm_90a``), one per TPU kernel
of the encode path, and their wrappers.

Each wrapper:
- checks device, dtype (fp32 only), shape and contiguity, and raises on what
  its kernel does not take;
- on a CUDA tensor launches its kernel or raises; there is no fallback;
- on a CPU tensor runs the plain PyTorch version in the same module;
- adds one to ``LAUNCHES[name]`` where it launches its kernel, and nowhere
  else, so a run can show that it went through the kernel.
"""

import torch

LAUNCHES: dict[str, int] = {"first_block": 0, "conv_unit_ct": 0,
                            "conv_unit": 0, "local_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_input(t: torch.Tensor, name: str, ndim: int | None = None) -> None:
    """The checks every kernel input passes before its pointer is taken."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {t.dtype} (bf16 is not "
                        "supported yet)")
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


def check_cuda(ts: dict, device: torch.device) -> None:
    """Every operand of a launch is a contiguous fp32 tensor on ``device``."""
    for name, t in ts.items():
        if t is None:
            continue
        check_input(t, name)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
