"""Train step: microbatched gradient accumulation and the optimizer, the
port's counterpart of ``repro.train.train_step``.

``make_train_step(cfg, plan, opt_cfg, compress, impl, mesh=None)``
returns ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``:

- with one microbatch, the loss and its gradients of the whole batch;
- with ``plan.microbatches = n > 1``, the batch's rows split into n
  microbatches, each one's gradients cast to ``plan.grad_accum_dtype`` and
  summed in it, then divided by n, and the loss averaged, as ``repro``'s
  scan over microbatches does;
- the optimizer's update (``plan.optimizer``) on those gradients, and
  ``grad_norm``, the L2 norm of the averaged gradients in float32.

Gradients come from ``torch.autograd.grad`` of ``models.loss_fn`` with
respect to detached copies of the parameter leaves, so the caller's
tensors never carry ``.grad``. ``impl`` picks the kernels (``"cuda"``:
the attention and scan kernels forward, their plain versions backward),
the plain path (``"torch"``) or the dry run's shape-only entries
(``"shape"``). ``compress`` is accepted and not used, as in ``repro``
(its ``make_train_step`` never calls ``compress_gradients``).

With a ``mesh`` (a ``DeviceMesh``; parameters, optimizer state and batch
as DTensors, from :func:`init_train_state` and
``parallel.sharding.shard_tree``) the step is ``repro``'s SPMD one: it
runs under ``sharding_ctx(mesh, moe_local_dispatch, no_ep)`` with the MoE
layer's expert sharder, every gradient is placed on the FSDP plan's
placements (``_grad_sharder``, ZeRO-2), and each microbatch keeps the
batch's data-parallel sharding on its rows (each rank splits its own rows,
so the split moves nothing; the microbatches hold other rows than
``repro``'s contiguous ones, and their mean is the same). The optimizer
state lives on the FSDP plan's placements (ZeRO-1).

The step is a :class:`TrainStep`, whose parts (the context, a
microbatch's gradients, the accumulators, the update) ``launch.dryrun``
also composes on its own: it traces one microbatch and counts it once for
each.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.registry import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.parallel.ctx import sharding_ctx
from repro_torch.parallel.sharding import (
    ParallelPlan,
    expert_sharder,
    map_with_path,
    param_shardings,
    placements,
    shard_tree,
    spec_for_param,
)
from repro_torch.train.optimizer import OptConfig, make_optimizer

ACCUM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def value_and_grad(cfg: ModelConfig, params, batch, impl: str = "auto",
                   shard_experts=None):
    """``(loss, parts, grads)``: ``loss_fn`` on ``batch`` and its gradients
    with respect to every parameter leaf, a tree of the params' layout
    (``jax.value_and_grad(loss_fn, has_aux=True)``)."""
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    live = tree_map(leaf, params)
    total, parts = loss_fn(cfg, live, batch, impl, shard_experts)
    grads = iter(torch.autograd.grad(total, leaves, allow_unused=True))
    grads = tree_map(lambda p: _zero_if_none(next(grads), p), params)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _zero_if_none(g, p):
    # a leaf the loss does not read (the vision projection on a text-only
    # batch) has gradient 0, as under jax.grad
    return torch.zeros_like(p) if g is None else g


def _grad_sharder(mesh, plan: ParallelPlan):
    """Gradients to the FSDP plan's placements (the parameters' specs with
    ``fsdp`` on)."""
    fsdp_plan = dataclasses.replace(plan, fsdp=True)

    def one(path, g):
        spec = spec_for_param(path, tuple(g.shape), mesh, fsdp_plan)
        return g.redistribute(mesh, placements(spec, mesh))

    return lambda grads: map_with_path(one, grads)


def _split_rows(v: torch.Tensor, n: int):
    """``v``'s rows in ``n`` microbatches. A DTensor whose rows are sharded
    (and nothing else) is split on each rank's own rows, so every
    microbatch keeps the data axes on its rows and nothing moves."""
    if isinstance(v, DTensor):
        pl = list(v.placements)
        if (all(isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == 0)
                for p in pl) and v.to_local().shape[0] % n == 0):
            return [DTensor.from_local(c, v.device_mesh, pl, run_check=False)
                    for c in v.to_local().chunk(n)]
    return list(v.chunk(n))


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    (module notes), and its parts."""

    def __init__(self, cfg: ModelConfig, plan: ParallelPlan,
                 opt_cfg: OptConfig = OptConfig(), impl: str = "auto",
                 mesh=None):
        self.cfg, self.plan, self.impl, self.mesh = cfg, plan, impl, mesh
        self.opt = make_optimizer(plan.optimizer, opt_cfg)
        self.acc_dt = ACCUM_DTYPES[plan.grad_accum_dtype]
        self.shard_experts = (expert_sharder(mesh) if mesh is not None
                              and cfg.family == "moe" else None)
        self.shard_grads = (_grad_sharder(mesh, plan) if mesh is not None
                            else (lambda g: g))

    def context(self):
        """What the step runs in: ``sharding_ctx`` on a mesh, else
        nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_ctx(self.mesh,
                            moe_local_dispatch=self.plan.moe_local_dispatch,
                            no_ep=self.plan.no_ep)

    def grads_of(self, params, batch):
        """``(loss, grads)`` of one microbatch, the gradients on the FSDP
        placements."""
        loss, _, g = value_and_grad(self.cfg, params, batch, self.impl,
                                    self.shard_experts)
        return loss, self.shard_grads(g)

    def microbatches(self, batch) -> List[dict]:
        """``batch``'s rows in ``plan.microbatches`` microbatches."""
        n = self.plan.microbatches
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"{rows} rows do not split into {n} "
                             f"microbatches")
        split = {k: _split_rows(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in split.items()} for i in range(n)]

    def zeros(self, params):
        """The gradient accumulators, 0 in ``plan.grad_accum_dtype``."""
        return self.shard_grads(tree_map(
            lambda p: torch.zeros_like(p, dtype=self.acc_dt), params))

    def add(self, acc, grads):
        return tree_map(lambda a, b: a + b.to(self.acc_dt), acc, grads)

    def update(self, params, opt_state, grads, loss):
        """The optimizer's update on the averaged ``grads``; the metrics."""
        new_params, new_opt = self.opt.update(grads, opt_state, params)
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in tree_leaves(grads)))
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    def __call__(self, params, opt_state, batch):
        with self.context():
            n = self.plan.microbatches
            if n <= 1:
                loss, grads = self.grads_of(params, batch)
            else:
                grads, losses = self.zeros(params), []
                for mb in self.microbatches(batch):
                    mloss, g = self.grads_of(params, mb)
                    grads = self.add(grads, g)
                    losses.append(mloss)
                grads = tree_map(lambda g: g / n, grads)
                loss = torch.stack(losses).sum() / len(losses)
            return self.update(params, opt_state, grads, loss)


def make_train_step(cfg: ModelConfig, plan: ParallelPlan,
                    opt_cfg: OptConfig = OptConfig(),
                    compress: bool = False, impl: str = "auto", *,
                    mesh=None) -> TrainStep:
    return TrainStep(cfg, plan, opt_cfg, impl, mesh)


def init_train_state(cfg: ModelConfig, plan: ParallelPlan,
                     generator: Optional[torch.Generator] = None,
                     device: Union[str, torch.device, None] = None,
                     mesh=None):
    """(params, opt_state): ``init_params`` from ``generator`` on
    ``device`` (``cuda`` unless the caller asks for the CPU) and the
    plan's optimizer state. With a ``mesh`` every rank draws the same
    whole weights and keeps its shards: the parameters on the plan's
    placements, the optimizer state on the FSDP plan's (ZeRO-1)."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, dev)
    opt_state = make_optimizer(plan.optimizer).init(params)
    if mesh is None:
        return params, opt_state
    return shard_state(params, opt_state, mesh, plan)


def shard_state(params, opt_state, mesh, plan: ParallelPlan):
    """Whole parameters and optimizer state as DTensors on ``mesh``: the
    parameters on ``plan``'s placements, the state on the FSDP plan's."""
    zero1 = dataclasses.replace(plan, fsdp=True)
    return (shard_tree(params, mesh, param_shardings(mesh, plan, params)),
            shard_tree(opt_state, mesh,
                       param_shardings(mesh, zero1, opt_state)))
