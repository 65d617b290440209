"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
256- or 512-rank backend, the port's counterpart of
``repro.launch.dryrun``.

For each cell this starts ``torch.distributed``'s ``"fake"`` backend as
rank 0 of the production mesh (``launch.mesh``), builds parameters,
optimizer state, inputs and caches as fake DTensors on the rules'
placements (``parallel.sharding``: nothing is allocated), and traces one
train, prefill or decode step under ``FakeTensorMode`` with the kernels'
shape-only entries (``impl="shape"``). ``repro`` lowers and compiles the
step with XLA instead. ``roofline.op_cost`` counts one rank's FLOPs,
bytes, collectives and live bytes through the step; the record gives the
fits-check (``memory``: one rank's argument, output, temp and peak bytes)
and the roofline terms, as ``repro``'s JSON does, under results/dryrun/.

A train step's microbatch loop traces its first microbatch and counts it
once for each microbatch, as ``repro``'s ``hlo_cost`` multiplies the
scan's body by its trip count; one rank's peak is the traced
microbatch's, the gradient accumulators live. An exception is recorded
as ``status: "error"`` and the run goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
(``--device cpu`` traces fake CPU tensors, for a machine without CUDA.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import ARCHITECTURES, canonical, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.shapes import (
    ENC_FRAMES,
    SHAPES,
    cell_supported,
    decode_cache_len,
    input_specs,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map
from repro_torch.models.model import init_cache, init_params
from repro_torch.parallel.sharding import (
    ParallelPlan,
    batch_shardings,
    cache_shardings,
    mesh_size,
    param_shardings,
    plan_for,
    shard_tree,
)
from repro_torch.roofline.analysis import roofline_report
from repro_torch.roofline.op_cost import OpCost, local_nbytes, repeated
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (
    TrainStep,
    make_train_step,
    shard_state,
)

PLAN_KEYS = ("fsdp", "microbatches", "seq_shard_cache", "optimizer",
             "shard_activation_seq", "remat_policy", "grad_accum_dtype",
             "moe_local_dispatch")


def _fake_inputs(specs: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=device)
            for k, s in specs.items()}


def one_microbatch_step(step: TrainStep):
    """``step`` as the dry run traces it: the first microbatch's gradients
    and their accumulation counted once for each microbatch
    (``op_cost.repeated``), the accumulators' set-up, the average and the
    update once. The loss it returns is that microbatch's."""
    n = step.plan.microbatches
    if n <= 1:
        return step

    def run(params, opt_state, batch):
        with step.context():
            first = step.microbatches(batch)[0]
            grads = step.zeros(params)
            with repeated(n):
                loss, g = step.grads_of(params, first)
                grads = step.add(grads, g)
            return step.update(params, opt_state,
                               tree_map(lambda g: g / n, grads), loss)

    return run


def trace_step(cfg: ModelConfig, shape_name: str, mesh, plan: ParallelPlan,
               device: torch.device) -> Dict[str, Any]:
    """Trace one step of ``shape_name``'s kind on ``mesh`` (fake backend
    up, ``FakeTensorMode`` entered by the caller; ``mesh`` None: one
    device, plain fake tensors). Returns ``op_cost``'s result and one
    rank's ``memory`` bytes."""
    kind = SHAPES[shape_name]["kind"]
    specs = input_specs(cfg, shape_name)
    batch, seq = SHAPES[shape_name]["batch"], SHAPES[shape_name]["seq"]
    def place(tree, specs_of):
        return tree if mesh is None else shard_tree(tree, mesh, specs_of(tree))

    params_g = init_params(cfg, device=device)
    inputs = place(_fake_inputs(specs, device),
                   lambda t: batch_shardings(mesh, t))
    if kind == "train":
        from repro_torch.train.optimizer import make_optimizer

        opt_g = make_optimizer(plan.optimizer).init(params_g)
        params, opt_state = (shard_state(params_g, opt_g, mesh, plan)
                             if mesh is not None else (params_g, opt_g))
        del params_g, opt_g
        step = one_microbatch_step(make_train_step(cfg, plan, impl="shape",
                                                   mesh=mesh))
        args = (params, opt_state, inputs)
    else:
        params = place(params_g, lambda t: param_shardings(mesh, plan, t))
        del params_g
        ctx = dict(moe_local_dispatch=plan.moe_local_dispatch, no_ep=plan.no_ep)
        if kind == "prefill":
            cache_g = init_cache(cfg, batch, seq + 8, device)
            step = make_prefill_step(cfg, mesh=mesh, impl="shape", **ctx)
        else:
            cache_g = init_cache(cfg, batch, decode_cache_len(shape_name), device)
            if cfg.is_enc_dec:  # cross k/v of a 4,096-frame encoder pass
                ck = (batch, ENC_FRAMES, cfg.n_kv_heads, cfg.hd)
                cache_g["cross_kv"] = [
                    (torch.empty(ck, dtype=cfg.dtype, device=device),
                     torch.empty(ck, dtype=cfg.dtype, device=device))
                    for _ in range(cfg.n_layers)]
            step = make_decode_step(cfg, mesh=mesh, **ctx)
        cache = place(cache_g, lambda t: cache_shardings(mesh, plan, cfg, t))
        del cache_g
        if kind == "prefill":
            args = (params, inputs, cache)
        else:
            args = (params, inputs["tokens"], cache, seq - 1)
    cost = OpCost()
    argument = cost.track(args)
    with cost:
        out = step(*args)
    output = local_nbytes(out)
    res = cost.result()
    res["memory"] = {"argument_bytes": argument, "output_bytes": output,
                     "temp_bytes": max(res["peak_bytes"] - argument - output, 0),
                     "peak_bytes": res["peak_bytes"]}
    return res


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               plan_overrides: Optional[Dict[str, Any]] = None,
               config_overrides: Optional[Dict[str, Any]] = None,
               device: Union[str, torch.device, None] = None):
    """Trace one cell on the fake production mesh; returns (cost, mesh
    size, plan, meta)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.registry import resolve_device

    dev = resolve_device(device)
    cfg = get_config(arch)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        plan = plan_for(cfg, shape_name, mesh)
        if plan_overrides:
            plan = dataclasses.replace(plan, **plan_overrides)
        with FakeTensorMode(allow_non_fake_inputs=True):
            res = trace_step(cfg, shape_name, mesh, plan, dev)
        n = mesh_size(mesh)
    return res, n, plan, {"cfg": cfg, "kind": SHAPES[shape_name]["kind"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             plan_overrides: Optional[Dict[str, Any]] = None,
             config_overrides: Optional[Dict[str, Any]] = None,
             tag: str = "",
             device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    ok, why = cell_supported(arch, shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "torch": torch.__version__,  # the counts follow DTensor's version
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        res, n_chips, plan, meta = lower_cell(arch, shape_name, multi_pod,
                                              plan_overrides, config_overrides,
                                              device)
        cfg = meta["cfg"]
        rec.update(
            status="ok",
            lower_s=round(time.time() - t0, 1),
            plan={k: getattr(plan, k) for k in PLAN_KEYS},
            memory=res["memory"],
            cost={"flops": res["flops"],
                  "bytes_accessed": res["bytes_accessed"]},
            collectives={
                "total_wire_bytes": res["collective_wire_bytes"],
                "per_kind": res["collective_per_kind"],
                "count": res["collective_counts"],
            },
            kernels=res["kernels"],
            model_params=cfg.param_count(),
            model_params_active=cfg.active_param_count(),
            roofline=roofline_report(
                kind=meta["kind"], cfg=cfg, shape=SHAPES[shape_name],
                n_chips=n_chips, flops=res["flops"],
                bytes_accessed=res["bytes_accessed"],
                coll={"total_wire_bytes": res["collective_wire_bytes"]}),
        )
    except Exception as e:  # record failures as first-class results
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def summary(rec: Dict[str, Any]) -> str:
    """One line of a record: status, cell, trace seconds, one rank's
    argument and peak GB, FLOPs, wire bytes by kind, the roofline's
    terms."""
    head = f"[{rec['status']:7s}] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s}"
    if rec["status"] != "ok":
        return f"{head} {rec.get('reason', rec.get('error', ''))}"
    mem, rl = rec["memory"], rec["roofline"]
    kinds = " ".join(f"{k}={v:.3e}" for k, v in
                     sorted(rec["collectives"]["per_kind"].items()))
    return (f"{head} trace={rec['lower_s']}s "
            f"arg={mem['argument_bytes'] / 1e9:.2f}GB "
            f"peak={mem['peak_bytes'] / 1e9:.2f}GB "
            f"flops={rec['cost']['flops']:.3e} "
            f"wire={rec['collectives']['total_wire_bytes']:.3e}B [{kinds}] "
            f"compute={rl['compute_s']:.4g}s memory={rl['memory_s']:.4g}s "
            f"collective={rl['collective_s']:.4g}s dominant={rl['dominant']} "
            f"torch={rec['torch']}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu: the fake tensors' device")
    args = ap.parse_args()

    archs = ARCHITECTURES if (args.all or args.arch is None) else [canonical(args.arch)]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, args.multi_pod, out_dir=args.out,
                           tag=args.tag, device=args.device)
            print(summary(rec), flush=True)


if __name__ == "__main__":
    main()
