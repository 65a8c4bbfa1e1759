"""Gradients of the hand-written kernels.

Each JAX kernel with a ``custom_vjp`` runs its Pallas forward and a
backward made of plain XLA ops: the VJP of its jnp twin, or an explicit
einsum form. The port keeps that split. A wrapper whose inputs require a
gradient runs its forward (the CUDA launch on the card, the plain version
on the CPU) inside :class:`KernelFunction`, whose backward calls the
kernel's ``*_vjp`` in plain PyTorch. With no input requiring a gradient
the wrapper calls the forward directly, as serving always has.
"""

from __future__ import annotations

import torch

__all__ = ["KernelFunction", "differentiable", "twin_vjp", "refuse_grad"]


def _wants_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad for a in args)


class KernelFunction(torch.autograd.Function):
    """``run(*args)`` forward, ``vjp(saved, g)`` backward. ``args`` are
    tensors or None; ``save`` marks the ones the backward reads."""

    @staticmethod
    def forward(ctx, run, vjp, save, *args):
        ctx.vjp = vjp
        ctx.save_for_backward(*(a if keep else None
                                for a, keep in zip(args, save)))
        return run(*args)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, *ctx.vjp(ctx.saved_tensors, g))


def differentiable(run, vjp, args, save=None):
    """``run(*args)``; through :class:`KernelFunction` when autograd is on
    and an input requires a gradient. ``vjp(saved, g)`` gets ``args`` with
    the ones ``save`` leaves out as None and returns one gradient (or None)
    per argument."""
    if not _wants_grad(args):
        return run(*args)
    save = (True,) * len(args) if save is None else save
    return KernelFunction.apply(run, vjp, save, *args)


def twin_vjp(fn, primals, g):
    """The VJP of ``fn(*primals)`` at ``g`` by autograd: the gradient of
    every floating-point primal (None for the others)."""
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True)
              if torch.is_tensor(p) and p.is_floating_point() else p
              for p in primals]
        leaves = [x for x in xs if torch.is_tensor(x) and x.requires_grad]
        grads = iter(torch.autograd.grad(fn(*xs), leaves, g,
                                         allow_unused=True))
    return tuple(next(grads) if torch.is_tensor(x) and x.requires_grad
                 else None for x in xs)


def refuse_grad(name, field, args):
    """Raise when a CUDA launch of ``name`` is asked for a gradient: the
    kernel has none in the JAX package on the TPU either. ``field`` names
    the option that routes the forward through it."""
    if _wants_grad(args):
        raise NotImplementedError(
            f"{name} has no gradient (as in the JAX package on the TPU): "
            f"train with {field} off")
