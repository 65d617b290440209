"""The port's examples (``examples/*_torch.py``) against the JAX package's
on the CPU.

- ``quickstart_torch``'s standard output line for line equal to
  ``examples/quickstart.py``'s (a subprocess, run while the port's runs in
  this process): both are the event engine at the same sizes;
- ``serve_small_torch.run`` fed ``repro``'s weights (``init_params`` at
  ``PRNGKey(0)``, carried over by ``models.convert``) and ``repro``'s
  prompts (``PRNGKey(100 + i)``) gives ``repro``'s ``ServeLoop`` tokens at
  the example's settings (4 slots, ``max_len`` 128, 6 requests of 12
  tokens, 8 new) on hymba_1_5b's smoke config in float32 (the example's
  bf16 is held by a logits bar in ``tests/test_torch_serving.py``, not by
  its tokens); ``main`` on the CPU prints the example's lines;
- the train example for 3 steps on the CPU: finite losses and the store
  statistics ``examples/train_with_hcdc_pipeline.py`` prints. Its losses
  are not held to ``repro``'s: ``repro``'s training driver with the tiered
  store is itself a failing reference
  (``tests/test_system.py::test_train_driver_with_hcdc_store_runs``).

``sweep_decision_torch`` is held to ``repro``'s decision in
``tests/test_torch_examples_decision.py``.
"""

import math
import os
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro import configs as jx_configs
from repro.models import init_params as jx_init_params
from repro.serve.engine import Request as JxRequest
from repro.serve.engine import ServeLoop as JxServeLoop
from repro_torch import configs
from repro_torch.models.convert import params_from_numpy
from torch_entry_points import ROOT, load
from torch_threads import one_torch_thread  # noqa: F401

STORE_KEYS = ("archival_reads", "cold_hits", "hot_hits", "migrated_bytes",
              "cold_egress_usd", "straggler_refetches")


def test_quickstart_prints_the_reference_lines(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "examples/quickstart.py"],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        got = load("examples/quickstart_torch.py").main([])
        out = capsys.readouterr().out
        want, err = ref.communicate(timeout=120)
    finally:
        ref.kill()
    assert ref.returncode == 0, err
    assert out.splitlines() == want.splitlines()
    assert got["recommended_disk_tb"] == 50.0
    assert len(got["sweep"]) == 3 and got["sweep"][0]["jobs_done"] > 0


def test_serve_small_run_matches_repro_serve_loop():
    ex = load("examples/serve_small_torch.py")
    jcfg = jx_configs.get_smoke_config("hymba_1_5b").replace(
        dtype=jnp.float32)
    cfg = configs.get_smoke_config("hymba_1_5b").replace(dtype=torch.float32)
    params = jax.jit(jx_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    prompts = [jax.random.randint(jax.random.PRNGKey(100 + i),
                                  (ex.PROMPT_LEN,), 0, jcfg.vocab_size)
               for i in range(6)]
    want = JxServeLoop(jcfg, params, batch_slots=ex.BATCH_SLOTS,
                       max_len=ex.MAX_LEN).run(
        [JxRequest(rid=i, prompt=p, max_new=8)
         for i, p in enumerate(prompts)])
    got, seconds = ex.run(
        cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                               device="cpu"),
        [torch.from_numpy(np.array(p)) for p in prompts], max_new=8)
    assert got == want
    assert [len(got[i]) for i in range(6)] == [8] * 6
    assert seconds > 0


def test_serve_small_main_on_the_cpu(capsys):
    got = load("examples/serve_small_torch.py").main(
        ["--device", "cpu", "--requests", "5", "--max-new", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert got["total_tokens"] == 15 and sorted(got["tokens"]) == list(range(5))
    assert lines[:5] == [f"request {i}: {got['tokens'][i]}" for i in range(5)]
    assert lines[-1].startswith("5 requests, 15 tokens in ")
    assert lines[-1].endswith(" tok/s on CPU, reduced config)")


def test_train_example_three_steps_on_the_cpu(tmp_path, capsys):
    out = load("examples/train_with_hcdc_pipeline_torch.py").main(
        ["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert len(out["losses"]) == 3
    assert all(math.isfinite(v) for v in out["losses"])
    assert out["final_loss"] == out["losses"][-1]
    assert set(STORE_KEYS) <= set(out["store_stats"])
    assert out["store_stats"]["archival_reads"] > 0
    assert "step     0 loss" in text
    assert "final loss: " in text and "HCDC store: archival_reads=" in text
    assert "data wait total: " in text
