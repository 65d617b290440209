"""Gradients of the kernel entries that training runs: the forward on the
hand-written kernel, the backward through the kernel's plain version.

``repro`` trains through its jnp attention and associative scan, never
through its Pallas kernels, and neither kernel has a VJP there, so there
is no backward kernel to port. The port's training step still runs the
kernels forward: :func:`kernel_with_plain_backward` launches the kernel
inside :class:`PlainBackward`, a ``torch.autograd.Function`` that saves
the inputs and, in its backward, recomputes the plain version from them
under autograd and returns ``torch.autograd.grad`` of it. The gradients
are therefore the plain path's, whatever the kernel rounds. A launch
outside such a function on an input that requires grad raises
(``_build.refuse_grad``): no output without a ``grad_fn`` leaves a kernel
entry under autograd.
"""

from __future__ import annotations

from typing import Callable

import torch


class PlainBackward(torch.autograd.Function):
    """``forward(ctx, kernel, plain, *tensors)``: ``kernel(*tensors)``, a
    tensor or a tuple of tensors; ``backward``: the vector-Jacobian
    product of ``plain(*tensors)`` (the same function in plain PyTorch)
    recomputed from the saved inputs. Inputs may be strided views (the
    scan's B and C are column slices); their gradients come back
    contiguous, which autograd accepts."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            outs = ctx.plain(*ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True)
                       if pairs and wrt else [None] * len(wrt))
        return (None, None, *(next(got) if n else None for n in needs))


def kernel_with_plain_backward(kernel: Callable, plain: Callable, *tensors):
    """``kernel(*tensors)``; under grad mode, with an input that requires
    grad, inside :class:`PlainBackward` so that the output carries the
    plain version's backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return PlainBackward.apply(kernel, plain, *tensors)
    return kernel(*tensors)
