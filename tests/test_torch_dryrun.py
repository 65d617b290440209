"""The dry run's cost model and traced cells on the CPU (fake tensors,
``torch.distributed``'s fake backend; no rank runs).

- ``roofline.op_cost``'s FLOPs for qwen3_4b's smoke prefill (B 2, T 32,
  no mesh) within 1% of ``repro``'s ``analyze_hlo`` on the same cell
  compiled by XLA (they are equal: 10,616,832 each).
- On a 2x2 fake mesh of qwen3_4b's smoke config (every dim divides):
  one rank's matrix-product FLOPs x 4 equal the unsharded count exactly
  for the prefill, and one rank's argument bytes equal the sum of its
  local shards from the rules; the train step's FLOPs x 4 are within 1%
  above the unsharded count (DTensor computes about 0.5% of the
  backward's products twice here, torch 2.13).
- A train step of 4 microbatches, traced one microbatch counted 4 times,
  counts the FLOPs of the step with 1.
- One ``OpCost`` counts at a time, and it puts back what it shadows.
- The arctic_480b smoke ``train_4k`` cell on the 16x16 fake mesh ends
  ``ok`` (FSDP, Adafactor, EP); the shape-only kernel entries refuse a
  tensor that holds data.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp
from repro import configs as jx_configs
from repro.models import model as jx_model
from repro.roofline.hlo_cost import analyze_hlo
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import selective_scan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.models.model import init_cache, init_params, prefill
from repro_torch.parallel import sharding
from repro_torch.roofline.op_cost import OpCost
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _jx_prefill_flops(arch: str, B: int, T: int) -> float:
    cfg = jx_configs.get_smoke_config(arch)
    p = jax.eval_shape(lambda: jx_model.init_params(cfg, jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: jx_model.init_cache(cfg, B, T + 8))
    batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32)}
    compiled = jax.jit(lambda p, b, c: jx_model.prefill(cfg, p, b, c)).lower(
        p, batch, cache).compile()
    return analyze_hlo(compiled.as_text())["flops"]


def test_op_cost_flops_match_hlo_cost_on_the_smoke_prefill():
    cfg = configs.get_smoke_config("qwen3_4b")
    with FakeTensorMode():
        params = init_params(cfg, device="cpu")
        cache = init_cache(cfg, 2, 40, "cpu")
        cost = OpCost()
        with cost:
            prefill(cfg, params, {"tokens": torch.zeros(2, 32, dtype=torch.int32)},
                    cache, impl="shape")
    got = cost.result()
    want = _jx_prefill_flops("qwen3_4b", 2, 32)
    assert got["flops"] == pytest.approx(want, rel=0.01)
    assert got["kernels"] == {"flash_attention": cfg.n_layers}
    assert got["bytes_accessed"] > 0 and got["collective_wire_bytes"] == 0


def _trace(cfg, shape, mesh, plan):
    with FakeTensorMode(allow_non_fake_inputs=True):
        return dryrun.trace_step(cfg, shape, mesh, plan, CPU)


def test_two_by_two_mesh_splits_the_products_exactly():
    cfg = configs.get_smoke_config("qwen3_4b")
    plan = sharding.ParallelPlan(fsdp=True, microbatches=1)
    one = {s: _trace(cfg, s, None, plan) for s in ("prefill_32k", "train_4k")}
    with fake_world(4):
        mesh = make_debug_mesh(2, 2, device="cpu")
        got = {s: _trace(cfg, s, mesh, plan) for s in ("prefill_32k", "train_4k")}
        with FakeTensorMode():
            params = init_params(cfg, device="cpu")
        specs = sharding.param_shardings(mesh, plan, params)
        local = sum(
            int(np.prod(sharding.local_shape(t.shape, s, mesh))) * t.element_size()
            for (_, t), (_, s) in zip(sharding.tree_paths(params),
                                      _spec_leaves(specs)))
    assert 4 * got["prefill_32k"]["flops"] == one["prefill_32k"]["flops"]
    # not below the unsharded count, and at most 1% above it: the products
    # DTensor computes twice at 2x2 (0.47% on torch 2.13)
    ratio = 4 * got["train_4k"]["flops"] / one["train_4k"]["flops"]
    assert 1.0 <= ratio <= 1.01, ratio
    assert got["prefill_32k"]["collective_wire_bytes"] > 0
    # the prefill's arguments: parameters, tokens and cache, one rank's shards
    batch, seq = 32, 32768
    tokens = batch * seq * 4 // 2  # int32 rows over "data"
    kv = 2 * cfg.n_layers * batch * (seq + 8) * cfg.n_kv_heads * cfg.hd * 2 // 4
    assert got["prefill_32k"]["memory"]["argument_bytes"] == local + tokens + kv
    assert got["prefill_32k"]["memory"]["peak_bytes"] >= local + tokens + kv


def test_one_traced_microbatch_counts_for_each():
    cfg = configs.get_smoke_config("qwen3_4b")
    got = {n: _trace(cfg, "train_4k", None,
                     sharding.ParallelPlan(microbatches=n)) for n in (1, 4)}
    assert got[4]["flops"] == got[1]["flops"] > 0
    assert got[4]["kernels"] == {"flash_attention": 4 * cfg.n_layers,
                                 "flash_attention.backward": 4 * cfg.n_layers}
    assert got[1]["kernels"] == {"flash_attention": cfg.n_layers,
                                 "flash_attention.backward": cfg.n_layers}


def test_op_cost_refuses_nesting_and_restores_the_propagator():
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    assert name not in vars(prop)
    with OpCost():
        assert name in vars(prop)
        with pytest.raises(RuntimeError, match="nest"):
            with OpCost():
                pass
    assert name not in vars(prop)
    own = getattr(prop, name)  # an instance override is put back as it was
    setattr(prop, name, own)
    try:
        with OpCost():
            assert vars(prop)[name] is not own
        assert vars(prop)[name] is own
    finally:
        delattr(prop, name)


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, sharding.PartitionSpec):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{prefix}{i}/")


def test_arctic_smoke_train_cell_ends_ok():
    cfg = configs.get_smoke_config("arctic_480b")
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}
    rec = dryrun.run_cell("arctic_480b", "train_4k", False,
                          config_overrides=over, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["plan"]["moe_local_dispatch"] and rec["mesh"] == "16x16"
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert set(rec) >= {"status", "plan", "memory", "cost", "collectives",
                        "model_params", "model_params_active", "roofline",
                        "lower_s"}
    assert "[ok     ] arctic_480b" in dryrun.summary(rec)


def test_unsupported_cell_is_skipped_and_errors_are_recorded():
    rec = dryrun.run_cell("qwen3_4b", "long_500k", False, device="cpu")
    assert rec["status"] == "skipped"
    rec = dryrun.run_cell("qwen3_4b", "train_4k", False, device="cpu",
                          plan_overrides={"optimizer": "sgd"})
    assert rec["status"] == "error" and "KeyError" in rec["error"]


def test_shape_only_entries_refuse_real_tensors_and_record_costs():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="fake or meta"):
        flash_attention(q, q, q, impl="shape")
    u = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="fake or meta"):
        selective_scan(u, u, torch.zeros(4, 2), torch.zeros(1, 8, 2),
                       torch.zeros(1, 8, 2), impl="shape")
    with FakeTensorMode():
        q = torch.empty(2, 4, 8, 16, requires_grad=True)
        k = torch.empty(2, 2, 8, 16, requires_grad=True)
        u = torch.empty(2, 8, 6, requires_grad=True)
        A = torch.empty(6, 3)
        bc = torch.empty(2, 8, 3)
        cost = OpCost()
        with cost:
            out = flash_attention(q, k, k, impl="shape")
            y, h = selective_scan(u, u, A, bc, bc, return_state=True,
                                  impl="shape")
            (out.sum() + y.sum()).backward()
        assert out.shape == q.shape and out.dtype == q.dtype
        assert y.shape == (2, 8, 6) and h.shape == (2, 6, 3)
        assert q.grad.shape == q.shape and u.grad.shape == u.shape
    fwd = 4.0 * 2 * 4 * 8 * 8 * 16
    mm = 0.0  # the sums' backward runs no product
    assert cost.result()["flops"] == 3 * fwd + mm
    assert cost.result()["kernels"] == {
        "flash_attention": 1, "flash_attention.backward": 1,
        "selective_scan": 1, "selective_scan.backward": 1}
