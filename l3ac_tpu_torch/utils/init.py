"""Parameter initializers with the distributions of ``l3ac_tpu/utils/init.py``,
drawn from an explicit ``torch.Generator``.

- Weight-normed convs and linears of the reference: trunc_normal(std=.02)
  (at std .02 the +-2 truncation is +-100 sigma, so a plain normal) and a
  zero bias.
- Plain torch layers (transformer linears, VQ projections, the EnhanceBlock's
  merge conv): torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
  and bias.
- Norm weights 1 and biases 0 (ChannelNorm, InstanceNorm); GRN gamma and beta
  0; snake alphas 1 (ConvUnit, LegacyUnit, the decoder tail).

The numbers differ from JAX's for the same seed: tests that compare the two
packages carry JAX's weights across with ``weights.from_jax_params``.
Values are drawn on the CPU and copied to the parameter's device.
"""

import torch
from torch import nn


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> None:
    t.copy_(torch.randn(t.shape, generator=gen) * std)


@torch.no_grad()
def normal_(t: torch.Tensor, gen: torch.Generator) -> None:
    """Standard normal, as ``torch.randn`` initialises a learned token."""
    t.copy_(torch.randn(t.shape, generator=gen))


@torch.no_grad()
def uniform_(t: torch.Tensor, gen: torch.Generator, bound: float) -> None:
    t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)


@torch.no_grad()
def weight_norm_layer_(m: nn.Module, gen: torch.Generator) -> None:
    """A reference weight-normed Conv1d or Linear: N(0, .02) weight, zero bias."""
    trunc_normal_(m.weight, gen)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def torch_default_(weight: torch.Tensor, bias: torch.Tensor | None,
                   gen: torch.Generator, fan_in: int) -> None:
    """torch's default Linear/Conv1d init."""
    bound = fan_in ** -0.5
    uniform_(weight, gen, bound)
    if bias is not None:
        uniform_(bias, gen, bound)


def torch_linear_(m: nn.Linear, gen: torch.Generator) -> None:
    torch_default_(m.weight, m.bias, gen, m.in_features)
