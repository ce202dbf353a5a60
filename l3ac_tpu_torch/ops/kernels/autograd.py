"""Gradients through the CUDA kernels, for training.

The JAX kernels define no VJPs: the JAX trainer turns them off for the whole
run and differentiates its jnp path (``l3ac_tpu/trainer.py:162-179``,
``l3ac_tpu/ops/pallas/__init__.py:34-44``). The port has no such switch: its
training forward goes through the kernels. Each kernel entry point of the
training path hands its launch and its plain version to :func:`call`:

- when autograd records nothing (grad mode off, as under the facade's
  ``inference_mode``, or no input requires grad), the launch runs as it is,
  exactly as before;
- otherwise :class:`KernelFunction` runs: its forward is the launch (counted
  in ``LAUNCHES`` as every launch is), its backward recomputes the plain
  version from the saved inputs under autograd and returns
  ``torch.autograd.grad`` of it, the vector-Jacobian product of the plain
  version. That is the gradient ``jax.grad`` of the jnp path gives, the one
  the JAX package trains with. The backward launches no kernel.

The differentiable inputs are the activations and the raw parameters (or
tensors that autograd builds from them, such as the stem's stacked branch
weights). The prepared buffers (packs, TF32 splits, folded GRN) are
operands of the launch only: built under ``no_grad`` and cached on the
parameters' versions (``conv_unit.cached_prepare``), so an optimizer step,
which changes every parameter in place, rebuilds each at the next forward.

Training runs in fp32, as the JAX package trains (its ``init_codec`` makes
fp32 params): a bf16 input under grad raises, and so does ``int8_matmul``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd would record an operation on ``tensors``: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class KernelFunction(torch.autograd.Function):
    """Forward: ``launch()``, the kernel on ``inputs`` as the wrapper holds
    them. Backward: the VJP of ``plain(*inputs)``, recomputed from the saved
    inputs, inside a profiler range ``backward:<name>`` (``profile_train``
    sums its device time per family). Both return one tensor."""

    @staticmethod
    def forward(ctx, name: str, launch: Callable, plain: Callable, *inputs):
        ctx.name, ctx.plain = name, plain
        ctx.save_for_backward(*inputs)
        return launch()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        want = ctx.needs_input_grad[3:]
        with torch.profiler.record_function(f"backward:{ctx.name}"), torch.enable_grad():
            args = [t if t is None else t.detach().requires_grad_(w)
                    for t, w in zip(ctx.saved_tensors, want)]
            out = ctx.plain(*args)
            diff = [a for a, w in zip(args, want) if w]
            got = iter(torch.autograd.grad(out, diff, grad, allow_unused=True))
        return (None, None, None, *(next(got) if w else None for w in want))


def call(name: str, launch: Callable[[], torch.Tensor], plain: Callable,
         *inputs) -> torch.Tensor:
    """``launch()``, the kernel's launch on ``inputs`` (the activations and
    weights its wrapper holds); through :class:`KernelFunction` when autograd
    records on them (:func:`needs_grad`), where ``plain(*inputs)`` is the
    version its backward differentiates and a bf16 input raises."""
    if not needs_grad(*inputs):
        return launch()
    low = [t.dtype for t in inputs if isinstance(t, torch.Tensor) and t.dtype != torch.float32]
    if low:
        raise TypeError(f"{name}: training runs in float32 only (the JAX package trains "
                        f"neither bf16 nor int8); got {low[0]} under autograd. Run "
                        f"{low[0]} models under torch.inference_mode() or torch.no_grad()")
    return KernelFunction.apply(name, launch, plain, *inputs)
