"""The mesh path on real ranks: four CPU processes on a 2x2 ``("data",
"model")`` mesh over ``gloo``, against one process.

- One FSDP train step of qwen3_4b's smoke config in float32 (two
  microbatches, AdamW at eps 1e-4, the plain attention): loss and every parameter
  after the step against the single-process step from the same weights
  and batch, rtol 1e-5 (atol 1e-6 for entries near 0).
- olmoe_1b_7b's smoke MoE layer with the shard-local dispatch at capacity
  factor 16 (dropless), EP and ``no_ep``, against the global dispatch in
  one process, within 1e-5.

Each test spawns its four ranks with a join timeout of its own (120 s)
and reads what rank 0 saved.
"""

import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.parallel.sharding import ParallelPlan
from repro_torch.train.optimizer import OptConfig
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
JOIN_S = 120
TRAIN_PLAN = ParallelPlan(fsdp=True, microbatches=2, grad_accum_dtype="f32")
# AdamW's first step divides each gradient by its own size: with eps 1e-8 a
# gradient within rounding of 0 may move its weight anywhere in +-lr, so the
# two orders of summation are compared where the step is well conditioned
TRAIN_OPT = OptConfig(eps=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_cfg():
    return configs.get_smoke_config("qwen3_4b").replace(dtype=torch.float32)


def _moe_cfg():
    return configs.get_smoke_config("olmoe_1b_7b").replace(
        dtype=torch.float32, capacity_factor=16.0)


def _batch(cfg, rows=8, seq=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)))
    return {"tokens": toks.int(), "labels": labels.int()}


def _moe_inputs(cfg, seed=5):
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(seed)
    p = moe.init_moe(g, cfg)
    x = torch.randn((4, 16, cfg.d_model), generator=g)
    return p, x


def _rank_main(rank: int, port: int, which: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.parallel.sharding import (
            batch_shardings,
            param_shardings,
            plan_for,
            shard_tree,
            tree_paths,
        )

        mesh = make_debug_mesh(2, 2, device="cpu")
        if which == "train":
            from repro_torch.train.train_step import (
                init_train_state,
                make_train_step,
            )

            cfg = _train_cfg()
            params, opt = init_train_state(
                cfg, TRAIN_PLAN, torch.Generator().manual_seed(0), "cpu",
                mesh=mesh)
            batch = _batch(cfg)
            batch = shard_tree(batch, mesh, batch_shardings(mesh, batch))
            step = make_train_step(cfg, TRAIN_PLAN, TRAIN_OPT, impl="torch",
                                   mesh=mesh)
            new_p, _, metrics = step(params, opt, batch)
            res = {"loss": metrics["loss"].full_tensor()}
            res.update({p: t.full_tensor() for p, t in tree_paths(new_p)})
        else:
            from repro_torch.models import moe
            from repro_torch.parallel.ctx import sharding_ctx

            cfg = _moe_cfg()
            p, x = _moe_inputs(cfg)
            res = {}
            for no_ep in (False, True):
                plan = plan_for(cfg, "prefill_32k", mesh)
                plan = ParallelPlan(fsdp=plan.fsdp, no_ep=no_ep)
                pd = shard_tree({"moe": p}, mesh,
                                param_shardings(mesh, plan, {"moe": p}))["moe"]
                xd = shard_tree(x, mesh, batch_shardings(mesh, x))
                with sharding_ctx(mesh, moe_local_dispatch=True, no_ep=no_ep):
                    y, _ = moe.moe_layer(pd, cfg, xd)
                res[f"no_ep={no_ep}"] = y.full_tensor()
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _spawn(which: str, tmp_path) -> dict:
    out = str(tmp_path / f"{which}.pt")
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, port, which, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    assert os.path.exists(out)
    return torch.load(out)


def test_fsdp_train_step_on_four_ranks_matches_one_process(tmp_path):
    from repro_torch.parallel.sharding import tree_paths
    from repro_torch.train.train_step import init_train_state, make_train_step

    got = _spawn("train", tmp_path)
    cfg = _train_cfg()
    params, opt = init_train_state(cfg, TRAIN_PLAN,
                                   torch.Generator().manual_seed(0), "cpu")
    new_p, _, metrics = make_train_step(cfg, TRAIN_PLAN, TRAIN_OPT,
                                        impl="torch")(
        params, opt, _batch(cfg))
    torch.testing.assert_close(got["loss"], metrics["loss"], rtol=1e-5, atol=0)
    want = dict(tree_paths(new_p))
    assert set(got) - {"loss"} == set(want)
    for path, t in want.items():
        torch.testing.assert_close(got[path], t, rtol=1e-5, atol=1e-6,
                                   msg=path)


def test_local_dispatch_on_four_ranks_matches_global(tmp_path):
    from repro_torch.models import moe

    got = _spawn("moe", tmp_path)
    cfg = _moe_cfg()
    p, x = _moe_inputs(cfg)
    want, _ = moe.moe_layer(p, cfg, x)
    for key in ("no_ep=False", "no_ep=True"):
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


@pytest.fixture(autouse=True)
def _no_group_left():
    import torch.distributed as dist

    yield
    assert not dist.is_initialized()
