"""1-D convolutions and dense layers with torch-layout weights.

Weights are in torch layout: conv ``(C_out, C_in // groups, K)``, linear
``(C_out, C_in)``. The JAX package keeps conv weights as
``(K, C_in // groups, C_out)`` and linear weights as ``(C_in, C_out)``;
``l3ac_tpu_torch.weights.from_jax_params`` transposes them once at load time.

Strided convs with ``kernel_size == stride`` (the encoder's downsampling
convs) have non-overlapping windows and run as a reshape plus one matrix
product (:func:`conv1d_strided_matmul`), as in ``l3ac_tpu/ops/conv.py``.
"""

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """General 1-D conv with symmetric zero padding. x: (B, Cin, T)."""
    return F.conv1d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv1d_strided_matmul(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor | None = None, *,
                          channels_last: bool = False) -> torch.Tensor:
    """Conv with kernel_size == stride and no padding, as reshape + matmul.

    w: (Cout, Cin, K). x: (B, Cin, T) -> (B, Cout, T // K), or with
    ``channels_last`` (B, T, Cin) -> (B, T // K, Cout). Needs ``T % K == 0``.
    """
    Cout, Cin, K = w.shape
    B, C, T = (x.shape[0], x.shape[2], x.shape[1]) if channels_last else x.shape
    if Cin != C or T % K:
        raise ValueError(f"strided conv needs Cin == {C} and T % {K} == 0, "
                         f"got w {tuple(w.shape)} and T = {T}")
    if channels_last:
        y = x.reshape(B, T // K, K * C) @ w.permute(2, 1, 0).reshape(K * C, Cout)
        return y if b is None else y + b
    y = torch.einsum("bctk,ock->bot", x.reshape(B, C, T // K, K), w)
    return y if b is None else y + b[:, None]


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """Dense layer over the last axis. w: (Cout, Cin)."""
    return F.linear(x, w, b)
