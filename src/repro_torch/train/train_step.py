"""Train step: microbatched gradient accumulation and the optimizer on one
card, the port's counterpart of ``repro.train.train_step``.

``make_train_step(cfg, plan, opt_cfg, compress, impl)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``:

- with one microbatch, the loss and its gradients of the whole batch;
- with ``plan.microbatches = n > 1``, the batch's rows split into n
  microbatches in order, each one's gradients cast to
  ``plan.grad_accum_dtype`` and summed in it, then divided by n, and the
  loss averaged, as ``repro``'s scan over microbatches does;
- the optimizer's update (``plan.optimizer``) on those gradients, and
  ``grad_norm``, the L2 norm of the averaged gradients in float32.

Gradients come from ``torch.autograd.grad`` of ``models.loss_fn`` with
respect to detached copies of the parameter leaves, so the caller's
tensors never carry ``.grad``. ``impl`` picks the kernels (``"cuda"``:
the attention and scan kernels forward, their plain versions backward)
or the plain path (``"torch"``). ``repro``'s mesh, sharding constraints
and MoE expert sharding have no counterpart on one card. ``compress`` is
accepted and not used, as in ``repro`` (its ``make_train_step`` never
calls ``compress_gradients``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.kernels.registry import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.parallel.sharding import ParallelPlan
from repro_torch.train.optimizer import OptConfig, make_optimizer

ACCUM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def value_and_grad(cfg: ModelConfig, params, batch, impl: str = "auto"):
    """``(loss, parts, grads)``: ``loss_fn`` on ``batch`` and its gradients
    with respect to every parameter leaf, a tree of the params' layout
    (``jax.value_and_grad(loss_fn, has_aux=True)``)."""
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    live = tree_map(leaf, params)
    total, parts = loss_fn(cfg, live, batch, impl)
    grads = iter(torch.autograd.grad(total, leaves, allow_unused=True))
    grads = tree_map(lambda p: _zero_if_none(next(grads), p), params)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _zero_if_none(g, p):
    # a leaf the loss does not read (the vision projection on a text-only
    # batch) has gradient 0, as under jax.grad
    return torch.zeros_like(p) if g is None else g


def make_train_step(cfg: ModelConfig, plan: ParallelPlan,
                    opt_cfg: OptConfig = OptConfig(),
                    compress: bool = False, impl: str = "auto") -> Callable:
    opt = make_optimizer(plan.optimizer, opt_cfg)
    acc_dt = ACCUM_DTYPES[plan.grad_accum_dtype]

    def train_step(params, opt_state, batch):
        n_micro = plan.microbatches
        if n_micro <= 1:
            loss, _, grads = value_and_grad(cfg, params, batch, impl)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_micro:
                raise ValueError(f"{rows} rows do not split into {n_micro} "
                                 f"microbatches")
            micro = [{k: v.chunk(n_micro)[i] for k, v in batch.items()}
                     for i in range(n_micro)]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            losses = []
            for mb in micro:
                mloss, _, g = value_and_grad(cfg, params, mb, impl)
                grads = tree_map(lambda a, b: a + b.to(acc_dt), grads, g)
                losses.append(mloss)
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = torch.stack(losses).sum() / n_micro
        new_params, new_opt = opt.update(grads, opt_state, params)
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in tree_leaves(grads)))
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(cfg: ModelConfig, plan: ParallelPlan,
                     generator: Optional[torch.Generator] = None,
                     device: Union[str, torch.device, None] = None):
    """(params, opt_state): ``init_params`` from ``generator`` on
    ``device`` (``cuda`` unless the caller asks for the CPU) and the
    plan's optimizer state."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, dev)
    return params, make_optimizer(plan.optimizer).init(params)
