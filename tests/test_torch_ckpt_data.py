"""The port's checkpoints, failover logic and data pipeline against the JAX
package's, on the CPU.

Checkpoints: the port's own round trip (no ``.tmp`` left, garbage
collection keeping the latest, an asynchronous save, a missing checkpoint
raising), and the on-disk layout shared with ``repro``: a checkpoint
written by ``repro``'s ``CheckpointManager`` (bf16 weights, AdamW state)
restores in the port with every bf16 bit, moment and step equal and
gives ``repro``'s loss (both in float32 on the restored weights, rtol
1e-5), and one written by the port restores in ``repro``, bit for bit.
The port's own resume (2 steps, save, restore, 2 steps) equals 4 steps
bitwise on the CPU. ``FailureDetector`` and ``ElasticPlanner`` as
``tests/test_checkpoint.py`` holds ``repro``'s. The corpus's batches are
bitwise ``repro``'s, and the tiered store's statistics and prefetch waits
equal to ``repro``'s on the same schedules.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jx_configs
from repro.ckpt.checkpoint import CheckpointManager as JxCheckpointManager
from repro.core.hotcold import ColdDeletionPolicy as JxColdDeletion
from repro.core.hotcold import MigrationPolicy as JxMigration
from repro.data import pipeline as jx_pipeline
from repro.data import tiered_store as jx_store
from repro.launch.train import make_store as jx_make_store
from repro.models import model as jx_model
from repro.sim.cloud import GCSCostModel as JxGCS
from repro.train import optimizer as jx_opt
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager, ElasticPlanner, FailureDetector
from repro_torch.core.hotcold import ColdDeletionPolicy, MigrationPolicy
from repro_torch.data import pipeline
from repro_torch.data import tiered_store as store_mod
from repro_torch.launch.train import make_store
from repro_torch.models import init_params, loss_fn
from repro_torch.models.convert import (
    params_from_numpy,
    stack_layers,
    tree_leaves,
    tree_map,
)
from repro_torch.parallel.sharding import ParallelPlan
from repro_torch.sim.cloud import GCSCostModel
from repro_torch.train import optimizer
from repro_torch.train.train_step import make_train_step
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "hymba_1_5b"


def _port_state(seed: int = 0, dtype=torch.bfloat16):
    """hymba's smoke weights (the port's layout) and fresh AdamW state."""
    cfg = configs.get_smoke_config(ARCH).replace(dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, params, optimizer.adamw().init(params)


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# --------------------------------------------------- the port's own round trip
def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    _, params, opt = _port_state(0)
    opt = tree_map(lambda t: t + 1, opt)
    cm.save(7, params, opt, extra={"pipeline": {"position": 3}})
    restored, step, extra = cm.restore({"params": params, "opt": opt})
    assert step == 7
    assert extra["pipeline"]["position"] == 3
    for a, b in zip(tree_leaves(restored), tree_leaves({"params": params,
                                                        "opt": opt})):
        assert _same(a, b)
    assert isinstance(restored["params"]["layers"], list)


def test_no_tmp_dirs_after_save(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _port_state(1)[1])
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_gc_keeps_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    _, params, _ = _port_state(0)
    for s in (1, 2, 3, 4):
        cm.save(s, params)
    assert cm.steps() == [3, 4]
    assert cm.latest_step() == 4


def test_async_save_then_restore(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    _, params, opt = _port_state(2)
    cm.save_async(5, params, opt)
    cm.wait()
    restored, step, _ = cm.restore({"params": params})
    assert step == 5
    assert _same(restored["params"]["layers"][1]["attn"]["wq"],
                 params["layers"][1]["attn"]["wq"])


def test_restore_missing_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cm.restore({"params": _port_state(0)[1]})


def test_async_write_failure_is_raised_by_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    # a list inside a layer: not a tree of the port's layout
    cm.save_async(1, {"layers": [{"w": [torch.zeros(2)]}]})
    with pytest.raises(RuntimeError, match="asynchronous"):
        cm.wait()


# ------------------------------------------------ across the two packages
@pytest.fixture(scope="module")
def repro_state():
    """``repro``'s bf16 smoke weights and its AdamW state after one step
    (nonzero moments), as ``repro``'s trees."""
    jcfg = jx_configs.get_smoke_config(ARCH)
    assert jcfg.dtype == jnp.bfloat16
    params = jax.jit(jx_model.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    opt = jx_opt.adamw()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state = jax.jit(opt.update)(grads, opt.init(params), params)
    return jcfg, params, state


def _batch(vocab: int, seed: int = 5):
    toks = np.random.default_rng(seed).integers(0, vocab, (2, 13),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_repro_checkpoint_restores_in_the_port(tmp_path, repro_state):
    jcfg, jparams, jstate = repro_state
    JxCheckpointManager(str(tmp_path)).save(
        4, jparams, jstate, extra={"pipeline": {"position": 4}})
    cfg, params, opt = _port_state(9)
    restored, step, extra = CheckpointManager(str(tmp_path)).restore(
        {"params": params, "opt": opt})
    assert step == 4 and extra == {"pipeline": {"position": 4}}
    want = {"params": jparams, "opt": jstate}
    got = stack_layers(restored)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16)), path
        else:
            assert np.array_equal(g.numpy(), w), path
    # the same weights: both packages' float32 loss on them
    f32 = cfg.replace(dtype=torch.float32)
    batch = _batch(cfg.vocab_size)
    got_loss, _ = loss_fn(f32, tree_map(lambda t: t.float(),
                                        restored["params"]),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    want_loss, _ = jx_model.loss_fn(
        jcfg.replace(dtype=jnp.float32),
        jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


def test_port_checkpoint_restores_in_repro(tmp_path, repro_state):
    jcfg, jparams, jstate = repro_state
    cfg = configs.get_smoke_config(ARCH)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    opt = optimizer.adamw().init(params)
    opt = optimizer.adamw().update(
        tree_map(lambda p: torch.full_like(p, 0.01), params), opt, params)[1]
    CheckpointManager(str(tmp_path)).save(2, params, opt,
                                          extra={"pipeline": {"position": 2}})
    restored, step, extra = JxCheckpointManager(str(tmp_path)).restore(
        {"params": jparams, "opt": jstate})
    assert step == 2 and extra == {"pipeline": {"position": 2}}
    want = jax.tree.map(np.asarray, stack_layers(
        tree_map(lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16
                 else t, {"params": params, "opt": opt})))
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                            jax.tree.leaves(want)):
        g = np.asarray(g)
        assert g.shape == w.shape, path
        if g.dtype.name == "bfloat16":
            assert np.array_equal(g.view(np.int16), w), path
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), path


# ----------------------------------------------------------------- resume
def test_resume_equals_an_uninterrupted_run(tmp_path):
    """2 steps, save (with the pipeline's position), restore into a fresh
    state, 2 steps: equal to 4 steps, losses and weights bitwise."""
    cfg, params0, opt0 = _port_state(6, dtype=torch.float32)
    step = make_train_step(cfg, ParallelPlan())
    corpus = pipeline.SyntheticCorpus(cfg.vocab_size, 12, 2, n_shards=16)

    def run(params, opt, pipe, n):
        losses = []
        for _ in range(n):
            b = {k: torch.from_numpy(v) for k, v in next(pipe).items()}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
        return params, opt, losses

    full_p, _, full = run(params0, opt0, pipeline.TokenPipeline(
        corpus, store=make_store(), epochs=1), 4)
    pipe = pipeline.TokenPipeline(corpus, store=make_store(), epochs=1)
    p, o, first = run(params0, opt0, pipe, 2)
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(2, p, o, extra={"pipeline": pipe.state()})
    cm.wait()
    _, fresh_p, fresh_o = _port_state(1, dtype=torch.float32)
    state, at, extra = cm.restore({"params": fresh_p, "opt": fresh_o})
    assert at == 2
    pipe = pipeline.TokenPipeline(corpus, store=make_store(), epochs=1)
    pipe.restore(extra["pipeline"])
    p, _, rest = run(state["params"], state["opt"], pipe, 2)
    assert first + rest == full
    for a, b in zip(tree_leaves(p), tree_leaves(full_p)):
        assert torch.equal(a, b)


# --------------------------------------------------------------- failover
def test_failure_detector_timeout():
    det = FailureDetector(timeout_s=5.0)
    det.heartbeat("w0", 0.0)
    det.heartbeat("w1", 0.0)
    det.heartbeat("w0", 8.0)
    assert det.failed_workers(9.0) == ["w1"]
    assert det.healthy(9.0) == ["w0"]
    # failed workers stay failed even if they come back
    det.heartbeat("w1", 10.0)
    assert "w1" in det.failed_workers(11.0)


@pytest.mark.parametrize("chips,batch,pods", [(192, 256, 1), (256, 256, 1),
                                              (100, 96, 2), (15, 8, 1)])
def test_elastic_planner_matches_repro(chips, batch, pods):
    from repro.ckpt.failover import ElasticPlanner as JxPlanner

    got = ElasticPlanner(model_tp=16).plan(chips, batch, pods)
    want = JxPlanner(model_tp=16).plan(chips, batch, pods)
    assert vars(got) == vars(want)
    assert got.devices == want.devices <= max(chips, 16 * pods)
    assert batch % (got.data * got.pods) == 0


# -------------------------------------------------------------------- data
def test_corpus_batches_bitwise_repro():
    args = dict(vocab_size=32001, seq_len=33, batch=3, n_shards=7)
    mine, theirs = (pipeline.SyntheticCorpus(**args),
                    jx_pipeline.SyntheticCorpus(**args))
    for sid in range(7):
        a, b = mine.materialize(sid), theirs.materialize(sid)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert [(s.sid, s.size) for s in mine.shard_sizes()] == \
        [(s.sid, s.size) for s in theirs.shard_sizes()]


def _stores(hot_limit, cold_limit, migrate_min=0):
    def build(mod, Migration, Cold, GCS):
        return mod.TieredStore(
            archival=mod.TierSpec("tape", None, latency_s=10.0,
                                  bandwidth=10.0),
            cold=mod.TierSpec("gcs", cold_limit, latency_s=1.0,
                              bandwidth=100.0, cost_model=GCS()),
            hot=mod.TierSpec("ssd", hot_limit, latency_s=0.0,
                             bandwidth=1000.0),
            migration=Migration(min_popularity=migrate_min),
            cold_deletion=Cold(0.9), clock=lambda: 0.0)
    return (build(store_mod, MigrationPolicy, ColdDeletionPolicy,
                  GCSCostModel),
            build(jx_store, JxMigration, JxColdDeletion, JxGCS))


@pytest.mark.parametrize("hot,cold,migrate_min", [
    (1000.0, 5000.0, 0), (350.0, 5000.0, 0), (1000.0, 250.0, 0),
    (450.0, 1200.0, 3)])
def test_tiered_store_matches_repro(hot, cold, migrate_min):
    """Two epochs over 20 shards of mixed sizes and popularity: every
    prefetch's shard and wait, and the stats, equal to ``repro``'s."""
    rng = np.random.default_rng(int(hot + cold))
    sizes = rng.uniform(50.0, 150.0, 20)
    pops = rng.integers(0, 6, 20)
    schedule = list(rng.permutation(20)) + list(rng.permutation(20))
    runs = []
    for mod, st in zip((store_mod, jx_store), _stores(hot, cold,
                                                      migrate_min)):
        st.register([mod.Shard(i, float(s), popularity=int(p))
                     for i, (s, p) in enumerate(zip(sizes, pops))])
        pf = mod.SlidingWindowPrefetcher(st, schedule)
        waits = [pf.next_shard() for _ in schedule]
        runs.append((waits, pf.drain(), st.stats, sorted(
            st.cold_window._members)))
    assert runs[0] == runs[1]
    assert runs[0][1]["archival_reads"] > 0


def test_pipeline_with_default_store_matches_repro():
    """The train driver's store and pipeline over 3 epochs, and a restore
    mid-way, against ``repro``'s: batches bitwise, stats and waits equal."""
    args = dict(vocab_size=500, seq_len=16, batch=2, n_shards=8)
    mine = pipeline.TokenPipeline(pipeline.SyntheticCorpus(**args),
                                  store=make_store(), epochs=3, seed=2)
    theirs = jx_pipeline.TokenPipeline(jx_pipeline.SyntheticCorpus(**args),
                                       store=jx_make_store(), epochs=3, seed=2)
    assert mine.schedule == theirs.schedule
    for a, b in zip(mine, theirs):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert mine.store.stats == theirs.store.stats
    assert mine.prefetcher.total_wait_s == theirs.prefetcher.total_wait_s
    mine.restore({"position": 5})
    theirs.restore({"position": 5})
    assert np.array_equal(next(mine)["tokens"], next(theirs)["tokens"])
