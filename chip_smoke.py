#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--days D]

Phases, in order; any failure exits nonzero without the final ``ok`` line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from the sources in this checkout (``nvcc`` into
   ``build/repro_torch/``), print the build seconds and each kernel's
   registers and spill bytes from ``ptxas``;
   then the serve phase: hymba_1_5b at its published widths and depth (32
   layers, d_model 1,600, 25 heads, 5 kv heads, hd 64, window 1,024 but
   layers 0, 15 and 31 global, state 16, d_inner 3,200; about 1.66 B
   parameters from a seeded generator) served through the port's
   ``ServeLoop(batch_slots=4, max_len=2048)``: 8 requests of 1,280-1,536
   seeded tokens in 2 waves (each left-padded to its longest, so every
   local layer's ring buffer is shorter than the prompt), 32 new tokens
   each; in float32 (the ``tf32x3`` attention kernel) and in bf16 (the
   ``wgmma`` one, TMA loader), each once through the kernels
   (``impl="cuda"``) and once through their plain versions on the card:
   every float32 token equal and the prefill logits within
   ``SERVE_LOGIT_BARS``, ``flash_attention`` and the scan's fused entry
   ``selective_scan`` each launched once a layer a wave and its contract
   entry ``mamba_scan`` never (counts set to 0 just before each run);
   the inputs the served prefill gave layer 0 (global) and layer 1
   (windowed) attention and layer 0's scan, held to the plain versions at
   the kernel bars (the scan's final state too; the scan also through
   ``mamba_scan`` on the dA and dBu its plain version forms), timed
   beside SDPA and the bound; prefill ms a wave and decode ms a step (CUDA events),
   tokens/s, the prefill's device time by kernel (``torch.profiler``:
   attention, scan, matrix products, the rest), the weights' and caches'
   bytes and the peak device memory, each beside the card; then ``python
   -m repro_torch.launch.serve --arch hymba-1.5b`` as a subprocess (exit
   0, its tok/s line);
   then the family serve phase (``FAMILY_SERVE``): olmoe_1b_7b (MoE, 64
   experts top-8), phi_3_vision_4_2b (256 seeded patch embeddings ahead
   of the text, hd 96) and seamless_m4t_large_v2 (the encoder over seeded
   frames, cross-attention) at their published widths and depth, and
   arctic_480b (MoE, 128 experts top-2 with its dense residual MLP, a GQA
   group of 7) at its published widths cut to 1 of its 35 layers (the
   model does not fit one card), each in bf16 from a seeded generator on
   the card: one wave of 4 seeded prompts (left-padded to the longest)
   through ``prefill`` and 16 greedy ``decode_step``s, once through the
   attention kernel and once through the plain versions, that run fed the
   kernel run's tokens and, at each MoE layer, dispatching the kernel
   run's expert choices (where its own router would choose otherwise is
   counted: the share of (token, layer) top-k sets that differ, printed,
   as is the prefill's dropped share at capacity factor 1.25; decode is
   dropless); ``flash_attention`` launched once an attention call
   (decoder layers, and for seamless the 24 encoder layers, bidirectional,
   and 24 cross-attentions, T decoder queries against S frames), the scan
   never; the prefill logits of the two runs within ``SERVE_LOGIT_BARS``;
   the inputs the served prefill gave layer 0's attention (seamless also
   encoder layer 0 and cross-attention 0) held to the plain version at the
   kernel bars and timed beside SDPA and the bound; prefill ms, decode ms a
   step, tokens/s, the weights' bytes and the peak device memory (the
   draw's too), each config's wall seconds, each beside the card; then
   ``python -m repro_torch.launch.serve`` for olmoe-1b-7b and
   phi-3-vision-4.2b as subprocesses (exit 0, their tok/s lines);
   then the train phase (``train_phase``): hymba_1_5b at its published
   widths and depth, remat on, bf16, AdamW (``parallel.plan_for``), seeded
   weights, batches of 2 x 2,048 tokens from ``SyntheticCorpus`` through
   ``TokenPipeline`` on ``launch.train.make_store()``, through
   ``train.train_step.make_train_step(impl="cuda")``: one untimed step
   (layers 0 and 1's attention inputs and layer 0's scan inputs kept),
   three timed by CUDA events (step ms, tokens/s, every loss and grad
   norm finite, peak device memory beside the weights' and optimizer's
   bytes; attention and the fused scan each launched 2 x 32 times a step,
   the forward and remat's recompute, ``mamba_scan`` never), a
   ``save_async`` of the state after step 2 (snapshot and write seconds);
   then one more step profiled (the device's activity, read from the
   profiler's own Chrome trace, ``trace_kernels``) in the two halves
   ``make_train_step`` runs, the loss and gradients and the optimizer's
   update, with the plain backward of one global and one windowed
   attention layer and of one scan layer profiled alone at the kept
   inputs: device ms by group (the two kernels, the plain backward of
   each, the optimizer, matrix products, the rest) and the idle share;
   the plain route from that state and batch against the profiled kernel
   route (``TRAIN_BARS``: the loss, each gradient leaf's relative L2);
   layer 1's attention and layer 0's scan at the kept inputs held to the
   plain versions and timed; the checkpoint restored into a fresh state,
   whose step 3 gives step 3's loss again (``TRAIN_RESUME_RTOL``), then
   removed; float32 at full width cut to 4 layers, the kernel route
   against the plain route (``TRAIN_BARS``); the store's statistics;
3. kernel phase: each hand-written kernel against its plain PyTorch version
   on the card, at the main path's shapes (8 lanes x 2 sites x 1,000,000
   files; both candidate windows of a tick, the grid's K and W = 4, in
   one launch, some heads stale because a K slot started their file,
   also timed replayed from a CUDA graph of 20 calls), with a
   finite-limit GCS admission
   case whose every admission difference must be a tie within 16 ulps
   of the limit and whose migration rank must be bitwise the plain one,
   a dense unlimited case, and the dense candidates (share 0.3) under
   finite limits, held to the same tie bar; prints the differences, the
   kernel's and the plain version's milliseconds (CUDA events, after
   warm-up), the kernel's device time (``torch.profiler``) and the bound:
   the bytes the function needs at these inputs (dense planes once,
   sparse reads by the 32-byte sectors they touch) over the memory rate
   (for ``gcs_admit`` also the bound of the function without its rank
   plane);
   then the tick-glue kernels (``kernels.tick_glue``: ``glue_begin``,
   ``glue_complete``, ``glue_link_admit``, ``glue_migrate``,
   ``glue_wait_select``): the sweep
   grid's ``cuda`` tick with them, captured and replayed, against the
   same tick with the plain glue (eager, the same lane-tick kernels),
   every state tensor bitwise after 600 ticks and after 200 more (at
   most half the horizon, and the rest of it); on the fused loop's state
   at tick 600 and on a dense synthetic state (about
   0.3 of the planes completing, queued, migrating and waiting) each glue
   kernel against its plain version, every state tensor and output
   (``disk_used``, the wait-queue heads) bitwise after each step, with
   its milliseconds (CUDA events around each call,
   its state restored before it), device microseconds (profiler), the
   plain version's milliseconds and the bound of the bytes it needs;
   ``torch.topk`` of the wait tickets timed beside ``glue_wait_select``
   (its library call), and a copy of ``glue_complete``'s bytes (what the
   card streams at that size) beside ``glue_complete``;
4. small reference: a 1,000-file grid on the CPU's plain path against the
   card's kernel path, at the Table-2 5% bar;
5. sweep phase: the 216-config pricing grid (Config III; cache 10/20/40/80
   TB; 3 egress options; 9 storage prices; 2 seeds; 8 dynamics lanes) at
   the paper's full catalogue of 1,000,000 files per site through
   ``run_sweep_torch`` with ``tick_impl="cuda"`` (the tick replayed
   from a CUDA graph), each kernel (the three lane-tick and the five glue
   kernels) launched once a tick, replays counted; then the same grid cut
   to ``PARITY_DAYS`` of horizon once with ``"cuda"`` and once with
   ``"torch"`` on the card (the plain tick runs some 45 ticks/s, so its
   whole horizon would take 190 s): per-spec agreement at the Table-2 5%
   bar, equal jobs submitted; then
   ``simulate_packed`` on the packed grid with the ``cuda`` tick eager
   and replayed, every output bitwise equal;
6. profile, for the eager and the replayed ``cuda`` tick
   (``sim.batched.TickLoop``): 40 ticks on the host clock, 40 more under
   ``torch.profiler`` — wall and device time per tick, the top kernels,
   the lane-tick and each glue kernel's device
   time per tick, ``torch.cumsum``'s calls and device time per tick,
   ``torch.topk``'s kernels (none: the run fails on any), PyTorch's
   reductions per tick and the wait queue's files after the profiled
   ticks (what ``glue_wait_select`` reads); for
   the replayed tick the capture's host time and the graph
   pool's bytes; for the eager one, traced (its times hold the trace
   library's, printed apart), the mean and most GCS candidates and
   admissions a lane on each counted tick (every
   ``trace_tick.COUNT_STRIDE``-th, the loop's counters read around each)
   from the profiled ticks to half-way through the horizon, and on 8
   counted ticks from there;
6b. trace phase (``trace_phase``), the tick's tracing
   (``kernels.trace_tick``) on the sweep grid: a traced captured loop,
   launch counts set to 0 after its warm-up ticks, replayed to the counted
   tick nearest half the horizon: each lane-tick and glue kernel launched
   once a replayed tick, ``trace_stamp`` once a segment of each
   (``len(SEGMENTS)``), ``trace_count`` once; its ``sweep.torch.tick``
   instant stamps every replayed tick on ``globaltimer`` and counts the
   lanes of every counted tick, its stamped time beside the replays' CUDA
   event time; then an eager traced loop on a copy of its state runs the
   next tick (a counted one) beside its replay, every state tensor bitwise
   and the counts added equal, and ``trace_tick.count`` on that tick's
   planes held exactly to the plain ``ref.count`` on the same inputs;
   ``trace_count``'s and ``trace_stamp``'s ms, device µs, ms in a graph,
   plain ms and bound (the count's: its two flag planes, 2 B a file, and
   the per-lane counters, at 3.35 TB/s), and the count's device µs on a
   tick it skips;
7. execution phase, on the same grid through the normal entry points on
   ``cuda``, each run held bitwise to the sweep phase's captured
   ``simulate_packed`` outputs or ``run_sweep_torch`` results:
   ``record_series=360`` (every output of capture off unchanged, each
   kernel still launched once a tick; on a 0.25-day cut of the grid the
   replayed tick's series bitwise to the eager tick's; the profiled
   replayed tick at strides 1 and 360 beside capture off), ``lane_chunk=2``
   (peak device memory allocated, ``torch.cuda.max_memory_allocated``,
   below the unchunked run's), ``devices=["cuda:0", "cuda:0"]`` with
   ``lane_chunk=2``, retryable chunk jobs under injected crashes, hangs
   and transient faults (0.3 each, traced loops; retries scheduled; device
   memory back
   within half a chunk's graph pool), and a fleet of two worker processes
   on the card (``transport="subprocess"``, ``lane_chunk=2``: each
   worker's chunks and busy seconds, the dispatcher's device memory
   unchanged);
7b. mesh phase (``mesh_phase``): (a) the dry run
   (``repro_torch.launch.dryrun``) of ``MESH_DRYRUN``'s four cells at full
   width and depth on the 16x16 fake backend with fake ``cuda`` tensors
   (qwen3_4b and arctic_480b ``train_4k``, olmoe_1b_7b ``prefill_32k``,
   hymba_1_5b ``long_500k``), each ``ok``, with its trace seconds, one
   rank's argument and peak GB beside the card's 80 GB, FLOPs, wire bytes
   by kind and roofline terms (H100 datasheet figures); (b) on a one-rank
   NCCL ``DeviceMesh`` of the card, real DTensors: olmoe_1b_7b's prefill
   at full width and depth (one ``FAMILY_SERVE`` wave) against the
   no-mesh prefill, logits bitwise or within ``SERVE_LOGIT_BARS``, and
   one hymba_1_5b ``value_and_grad`` at full width and
   ``MESH_TRAIN_LAYERS`` layers against PR 31's route from one state,
   loss and every gradient bitwise or within ``TRAIN_BARS``, the kernels
   on the ``cuda`` route with their launches counted (the kernels line's
   rows of the same kernel at the same shapes, the family serve phase's
   olmoe row and the train phase's rows, carry each run's as
   ``launches_mesh_prefill`` and ``launches_mesh_train``), then one
   ``make_train_step(mesh=...)`` step; (c) ``run_sweep(...,
   shard=True)`` over the lane mesh of the visible cards on the sweep's
   grid, every result bitwise the sweep phase's;
8. decide phase, the §5.3 decision workflow through the port's front door
   (``sim.decide.decide`` on ``sim.sweep.SweepDriver(backend="torch",
   tick=10.0, tick_impl="cuda", device="cuda", cache=<dir>)``, the cache
   in a fresh directory under ``build/``; the tracer on, so the loops are
   traced): the pricing grid's axes (2
   seeds) at the sweep's horizon and catalogue, ``max_rounds=2``, cold
   (each lane-tick, glue and trace kernel launched, counts reset just
   before;
   device memory back within half a graph pool of where it was, so each
   sweep call's pool is released), then warm with a fresh driver on the
   same cache (0 lanes simulated, the report equal outside its stats);
   then a small grid (2 caches x 2 egress x 2 prices x 2 seeds, 20,000
   files, 0.25 days, tick 60 s) on the kernels and on the plain
   ``torch`` path with one cache directory (their keys differ): equal
   decisions (the chosen
   point, the frontier's labels, the trimmed cache TB, the break-even
   bracket, the claim) and every point's jobs and cost, and the displaced
   TB, within the Table-2 bar (both reports printed where not); prints
   ``claim_holds``, ``refine.lane_fraction`` and
   ``displaced_disk.displaced_tb``, per sweep call the specs, lanes, pack
   s, ``TickLoop.capture_s``, graph pool bytes, sweep s and ticks/s (the
   ``sweep.torch`` trace events), and the phase's wall s;
9. CLI phase, the port's two commands as a user runs them, each a
   subprocess (``python -m repro_torch.cli.decide`` / ``.run_sweep``,
   failures not caught): ``decide --tick-impl cuda --tick 10
   --cross-check --json`` on the pricing grid at the sweep's catalogue and
   horizon, ``--max-rounds 2``, a fresh ``--cache-dir`` (cold: exit 0, its
   decision points re-run on the event engine within the CLI's 0.10 jobs /
   0.20 cost bars; decisions, displaced TB and break-even bracket equal to
   the decide phase's in-process ``decide()``), then again on the same
   cache (warm: 0 lanes simulated, the same decision); then ``run_sweep
   --backend process --workers 3`` on a JSON ``--spec`` of Table 5's I, II
   and III with ``curves: true`` and III over twice the horizon (specs the
   batched program refuses), and the same specs on a 2-worker fleet of the
   ``"scenario"`` kind (``transport="subprocess"``), every row and curve
   digest bitwise the CLI's; prints each run's wall s, the cross-check's
   configs and wall s, the event engine's events and events/s per config
   (host CPU), and the device memory before and after, each beside the
   card's name and power limit;
9b. examples phase (``examples_phase``), the port's examples and crash
   soak as a user runs them, each ``main`` in this process (its printed
   lines kept, the counts set to 0 just before each run and read just
   after): ``examples/sweep_decision_torch.py`` at its defaults with
   ``--tick-impl cuda`` and with ``torch`` on the card (each lane-tick and
   glue kernel launched on the first, none on the second; equal decisions,
   every point within the Table-2 bar); ``examples/serve_small_torch.py``
   at its bf16 defaults (6 requests of 8 tokens; attention and the fused
   scan launched), then its ``run`` in float32 on the kernels and on the
   plain route from one set of seeded weights (every token equal, the
   ``tf32x3`` attention and the scan launched only on the first; on a
   mismatch the first differing step's top-2 logit gap is printed);
   ``examples/train_with_hcdc_pipeline_torch.py`` at its 200 steps
   (losses finite and falling, the store statistics, attention launched),
   then 3 steps on each route (losses within ``TRAIN_BARS``);
   ``scripts/crash_soak_torch.py`` as a subprocess at ``SOAK_FILES``
   files a site (12 configs in lane chunks of 2), its kill timed from an
   uninterrupted run of the same ``run_sweep`` command: the victim dies
   of SIGKILL mid-run (the resume serves at least one config from the
   journal and simulates at least one lane), the resumed rows bitwise the
   uninterrupted run's (``wall_s`` aside), the fault soak exits 0 with
   every config; prints each run's wall s, the soak's kill time, resumed
   share and wall s, and the in-process runs' launches by kernel variant
   on one line (no row of the kernels line);
10. carousel phase: ``carousel_tick`` over 1,000,000 transfers (one site's
   catalogue, every file in flight) on 6 links (Config III's 2 sites x 3
   link types) and on 512, half shared and half per-transfer, dt = 10 s,
   then ``simulate_ticks`` for 1,000 ticks on 6 links through the tick
   engine (one count, then one kernel launch a tick on carried link
   counts, replayed from CUDA graphs) and through the plain loop:
   ``new_done``/``completed`` bitwise, counts exact, the engine's final
   state bitwise and its completions equal; ticks/s of both, the engine's
   with its capture and without, its launches a tick (replays counted),
   and over 128 steady ticks its wall and device microseconds a tick
   (``torch.profiler``), idle share and bound;
11. attention phase: ``flash_attention`` at qwen3_4b widths (nh 32, nkv 8,
   hd 128, T = S = 4096, bf16, causal), gemma3_27b's local layers (nh 32,
   nkv 16, published head_dim 128, T = S = 4096, bf16, causal, window
   1024), the same at hd 168 (the width ``repro``'s gemma3_27b config
   derives as 5376/32 — not the published head_dim — kept as a width that
   is not a power of two) in bf16 and in float32 (T = S = 2048), and
   hymba_1_5b in float32 (nh 25, nkv 5, hd 64, T = S = 2048, causal,
   window 1024), and bf16 at hd 100 (nh 32, nkv 16, T = S = 2048,
   causal, window 1024), a width that is not a multiple of 8; the bf16
   cases through the ``wgmma`` tensor-core kernel (``loader``: TMA at a
   multiple of 8, hd 100 through the producer's threads, ``cp.async``),
   the float32 ones through the ``tf32x3`` one (each product in three
   TF32 terms of split operands), each case checked to launch its
   route's kernel exactly once, and the thread loader exactly when its
   width needs it; each against the
   plain version at atol 4e-3 / rtol 8e-3 in bf16 (one bf16 ulp, and at
   most 1% of the elements unequal) or 2e-5 in float32, with PyTorch's
   ``scaled_dot_product_attention`` timed beside it as the yardstick
   (never on the port's path), its elements outside the same bar and
   each side's elements not equal to the plain version counted; each
   case's device time from 10 calls replayed in one CUDA graph
   (``graph_ms``), and from ``torch.profiler`` (``device_us``; ``None``,
   "not measured", where its reading is more than 5% off the graph's, as
   when it records too few kernels or none); a float32 case's bound is
   12*hd flops per unmasked pair at dense TF32's 495 TFLOP/s (the split
   design's own least time), printed beside the SIMT ceiling, 4*hd flops
   at 67 TFLOP/s (``bound_ms_simt``);
12. Mamba phase: both scan entries at falcon_mamba_7b widths (B 1, T
    2048, d_inner 8192, state 16) with the final state, against the plain
    versions at 1e-4 atol/rtol: ``mamba_scan`` on seeded dA and dBu (1.07
    GB each), ``selective_scan`` on seeded bf16 u, B and C (slices of a
    projection at dt rank 256), float32 dt and A; each with its ms (CUDA
    events), in a graph of 10 calls, device us (profiler), the plain
    version's ms and the bound: bytes for ``mamba_scan``, for
    ``selective_scan`` the larger of its bytes and its state-steps times
    the operations a state-step needs, the float32 and ``MUFU``
    instructions of the recurrence and its ``expf`` in the built kernel's
    hot loop (SASS, ``cuobjdump``), at one a lane and clock (the loop's
    whole count a state-step is printed beside it);
13. the ``kernels`` JSON line: one entry per kernel and case (``case``
    names it; the serve phase adds bf16 and float32 attention at served
    layer 1 and ``selective_scan`` at served layer 0, each with its 64
    launches on the served path, and ``mamba_scan`` on that layer's dA and
    dBu with its 1; the family serve phase bf16 attention at olmoe's and
    phi_3_vision's layer 0, seamless's encoder layer 0 and cross-attention
    0 and arctic's layer 0, each with its config's launches; the train
    phase bf16 attention at layer 1 and ``selective_scan`` at layer 0 of
    the train step, each with its 192 launches over the timed steps),
    each with its launches on its own path (counts
    reset just before the path runs, read just after each case; the
    lane-tick, glue and trace entries also with ``launches_decide``, their
    launches in the cold decide run); the glue kernels, which replace
    no Pallas kernel, name the lines of ``repro``'s tick that XLA fuses
    as what they replace, the trace kernels none; attention entries
    also name their route (``variant``: ``wgmma`` or ``tf32x3``, each at
    least once; the ``wgmma`` ones their ``loader``, ``tma`` or
    ``threads``, each at least once) and that kernel's source; then the
    ``ok`` line.

Phases 3, 8, 10 and 11 print the kernel's and the plain version's
milliseconds (CUDA events after warm-up) and the bound: the larger of the
bytes the function needs over the memory rate and its operations over the
card's peak for their type (float32 outside the tensor cores, bf16 on
them), from the data sheet of an H100 SXM.

The horizon is cut from the paper's 90 days to ``--days`` (default 1 day,
8,641 ticks of 10 s) to fit the run's time limit; the catalogue is not cut.
Imports nothing of JAX and nothing of the JAX package. Exits nonzero when
CUDA is not available or when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data sheet: device-memory bandwidth, float32 peak outside the
#: tensor cores and dense bf16 and TF32 tensor-core peaks, the rates the
#: bounds are computed against.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
#: Thread instructions a second: one a lane and clock on 132 SMs x 128
#: lanes at 1.98 GHz (the float32 peak over two, since it counts an FMA as
#: two operations); the fused scan's instructions are held to it.
INSTR_PER_S = F32_OPS_PER_S / 2

TOL = 0.05  # Table 2 validation tolerance (fractional)
#: The sweep phase's plain-path parity horizon (days), cut from the main
#: path's to keep the smoke inside its time limit.
PARITY_DAYS = 0.25
_LANE_TICK = "src/repro_torch/kernels/lane_tick/csrc/lane_tick.cu"
_CAROUSEL = "src/repro_torch/kernels/carousel_update/csrc/carousel_update.cu"
_TICK_GLUE = "src/repro_torch/kernels/tick_glue/csrc/tick_glue.cu"
_TRACE_TICK = "src/repro_torch/kernels/trace_tick/csrc/trace_tick.cu"
KERNEL_SOURCE = {
    "transfer_tick": _LANE_TICK,
    "gcs_admit": _LANE_TICK,
    "window_admit": _LANE_TICK,
    "glue_begin": _TICK_GLUE,
    "glue_complete": _TICK_GLUE,
    "glue_link_admit": _TICK_GLUE,
    "glue_migrate": _TICK_GLUE,
    "glue_wait_select": _TICK_GLUE,
    "trace_stamp": _TRACE_TICK,
    "trace_count": _TRACE_TICK,
    "carousel_tick": _CAROUSEL,
    "engine_count": _CAROUSEL,
    "engine_tick": _CAROUSEL,
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_wgmma.cu",
    "mamba_scan": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
    "selective_scan":
        "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
}
#: The attention kernel each route launches (``flash_attention.ops._route``:
#: float32 -> ``tf32x3``, bfloat16 -> ``wgmma``).
ATTENTION_SOURCE = {
    "tf32x3": "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_tf32x3.cu",
    "wgmma": KERNEL_SOURCE["flash_attention"],
}
#: The wgmma kernel's loaders (``flash_attention.ops._loader``: TMA at hd a
#: multiple of 8, else the producer's threads), each on some case.
ATTENTION_LOADERS = ("tma", "threads")
REPLACES = {
    "transfer_tick": "src/repro/kernels/lane_tick/lane_tick.py:81",
    "gcs_admit": "src/repro/kernels/lane_tick/lane_tick.py:194",
    "window_admit": "src/repro/kernels/lane_tick/lane_tick.py:292",
    # no Pallas kernel: XLA fuses these lines of the jitted tick
    "glue_begin": "src/repro/sim/batched.py:205-206 (XLA-fused)",
    "glue_complete": "src/repro/sim/batched.py:195,227-279,287,295-300,"
                     "332-333 (XLA-fused)",
    "glue_link_admit": "src/repro/sim/batched.py:280-286 (XLA-fused)",
    "glue_migrate": "src/repro/sim/batched.py:331,336-353 (XLA-fused)",
    "glue_wait_select": "src/repro/sim/batched.py:473-475 (jax.lax.top_k)",
    # no counterpart: the port's tracing of its own replayed tick
    "trace_stamp": "none (the port's tick tracing)",
    "trace_count": "none (the port's tick tracing)",
    "carousel_tick":
        "src/repro/kernels/carousel_update/carousel_update.py:42",
    "engine_count":
        "src/repro/kernels/carousel_update/carousel_update.py:42",
    "engine_tick":
        "src/repro/kernels/carousel_update/carousel_update.py:58",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:28",
    "mamba_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:29",
    # the same Pallas kernel, with the lines that form its dA and dBu
    # (src/repro/models/ssm.py:67-69) fused into it
    "selective_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:29",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(torch, fn, n: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``n`` calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(torch, fn, n: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` with ``n`` calls captured in one
    CUDA graph and replayed (CUDA events around one replay, after a
    warm-up replay): the device's time for the calls without the host's
    Python between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_us(torch, fn, n: int = 20) -> float:
    """Device time per call of ``fn`` in microseconds: the device-side
    events ``torch.profiler`` records over ``n`` calls (after one warm-up
    call), summed and divided by ``n``. Unlike :func:`time_ms` it leaves
    out the host's gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time for the work: bytes over the memory rate against
    operations over the peak for their type (float32 outside the tensor
    cores unless ``ops_per_s`` says otherwise); returns (ms, bound_by)."""
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def n_outside(got, want, atol: float, rtol: float) -> int:
    """Elements of ``got`` farther from ``want`` than ``atol + rtol *
    |want|`` (both compared in float32)."""
    want = want.float()
    return int(((got.float() - want).abs() > atol + rtol * want.abs()).sum())


def sector_bytes(torch, mask, itemsize: int) -> int:
    """Bytes of the 32-byte sectors that a read of ``itemsize``-byte
    elements of a contiguous tensor at ``mask`` touches: what a sparse read
    costs in device memory."""
    per = 32 // itemsize
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return 32 * int(flat.view(-1, per).any(-1).sum())


def transfer_bound(torch, active, comp, n_months: int):
    """Bytes and operations ``transfer_tick`` needs at these inputs: the
    active flag, done and total in and new_done and the completion flag
    out for every file; the link id only of active transfers and the size
    only of completions (by the 32-byte sectors they touch); the per-link
    and per-lane vectors. Operations: a compare and a select per file, a
    rate, multiply, add and compare per active transfer, an add per
    completion."""
    L, S, _ = active.shape
    n = active.numel()
    need = (n * (1 + 4 + 4) + n * (4 + 1) + sector_bytes(torch, active, 4)
            + sector_bytes(torch, comp, 4) + L * 3 * S * 8
            + 3 * L * S * 4 + 3 * L * n_months * 4)
    return need, 2 * n + 4 * int(active.sum()) + int(comp.sum())


def gcs_tie_check(torch, want, sizes, used, limit, got, plain, n_passes,
                  ulps: int = 16):
    """Hold the kernel's GCS admission to the plain version's up to ties.

    Replays the plain passes (``ref.gcs_gate_distance``: the prefix and
    the gate in float64) and keeps, per candidate, the least distance of
    its gate value ``used + cumsum`` to the limit over the passes that
    still held it. A candidate the two admit differently must lie within
    ``ulps`` float32 ulps of a finite limit there: the kernel sums in
    another order than ``torch.cumsum``, and nothing else may differ.
    Returns the count of tied candidates and their bytes per lane."""
    from repro_torch.kernels.lane_tick import ref

    L = want.shape[0]
    sz = sizes.reshape(L, -1)
    adm, _, dist = ref.gcs_gate_distance(want, sizes, used, limit, n_passes)
    check(torch.equal(adm, plain.reshape(L, -1)),
          "gcs_admit: the replay of the plain passes disagrees with ref")
    diff = got.reshape(L, -1) != adm
    tol = torch.where(torch.isfinite(limit),
                      ulps * torch.finfo(torch.float32).eps
                      * limit.double().abs(),
                      torch.zeros_like(limit, dtype=torch.float64))
    bad = int((diff & ~(dist <= tol[:, None])).sum())
    check(bad == 0, f"gcs_admit: {bad} admission differences farther than "
                    f"{ulps} ulps from the limit")
    return int(diff.sum()), (sz * diff).sum(1)


def pricing_axes(days: float, n_files: int) -> dict:
    """The 216-config pricing grid's axes, seeds left out (2 of them)."""
    return {
        "base": "III",
        "cache_tb": [10.0, 20.0, 40.0, 80.0],
        "egress": ["internet", "direct", "interconnect"],
        "storage_price": [round(0.018 + 0.002 * i, 3) for i in range(9)],
        "days": days, "n_files": n_files,
    }


def pricing_specs(days: float, n_files: int):
    from repro_torch.core.scenarios import expand_grid, with_seeds

    specs = with_seeds(expand_grid(pricing_axes(days, n_files)), 2)
    check(len(specs) == 216, f"pricing grid has {len(specs)} specs")
    return specs


def lane_parity(ref, got) -> int:
    """``tests/test_batched.py``'s per-spec Table-2 bar; returns the count
    of specs checked."""
    def close(a, b, tol=TOL, floor=1.0):
        return abs(a - b) <= tol * max(abs(a), abs(b), floor)

    check(len(ref.results) == len(got.results), "result counts differ")
    for a, b in zip(ref.results, got.results):
        lbl = a.spec.label
        check(a.spec == b.spec, f"spec order differs at {lbl}")
        for r in (a, b):
            vals = [r.cost_usd, *r.metrics.values()]
            check(all(v == v and abs(v) != float("inf") for v in vals),
                  f"{lbl}: non-finite metric")
        check(close(a.jobs_done, b.jobs_done),
              f"{lbl}: jobs_done {a.jobs_done} vs {b.jobs_done}")
        check(close(a.cost_usd, b.cost_usd),
              f"{lbl}: cost {a.cost_usd} vs {b.cost_usd}")
        check(close(a.metrics["download_pb"], b.metrics["download_pb"],
                    floor=1e-6), f"{lbl}: download_pb")
        check(a.metrics["jobs_submitted"] == b.metrics["jobs_submitted"],
              f"{lbl}: jobs_submitted")
        check(abs(a.metrics["job_waiting_h_mean"]
                  - b.metrics["job_waiting_h_mean"]) <= 0.05,
              f"{lbl}: job_waiting_h_mean")
    return len(ref.results)


def kernel_phase(torch, grid, L_sweep: int) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.lane_tick import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20210507)
    L, S, F = L_sweep, len(grid.site_names), grid.sizes.shape[-1]
    K = grid.max_jobs_per_tick
    n_months = grid.n_months
    sizes = torch.as_tensor(grid.sizes[:L], device=dev)
    check(tuple(sizes.shape) == (L, S, F), f"sizes shape {sizes.shape}")
    dt = torch.tensor(10.0, dtype=torch.float32, device=dev)
    month = torch.tensor(0, dtype=torch.int32, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    results = {}

    # -- transfer_tick: ~1 in 3000 files in flight (the link slots' scale),
    # half of them within one step of completion; random link modes.
    site = torch.arange(S, device=dev).view(1, S, 1)
    ltype = torch.randint(0, 3, (L, S, F), generator=gen, device=dev)
    link_id = (3 * site + ltype).to(torch.int32)
    active = rand(L, S, F) < 3e-4
    total = sizes.clone()
    done = total * (1.0 - 0.01 * rand(L, S, F))
    bw = torch.as_tensor(grid.link_bw[:L], device=dev)
    mode = torch.randint(0, 2, (L, 3 * S), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (link_id, active, done, total, sizes, bw, mode, dt, month,
            n_months)
    got = ops.transfer_tick(*args)
    want = ref.transfer_tick(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), "transfer_tick: new_done not bitwise")
    check(torch.equal(got[1], want[1]), "transfer_tick: completion mask")
    rel = 0.0
    for g, w in zip(got[2:], want[2:]):
        err = (g - w).abs() / w.abs().clamp_min(1.0)
        rel = max(rel, float(err.max()))
    check(rel <= 1e-6, f"transfer_tick: billing rel err {rel}")
    n_comp = int(got[1].sum())
    check(n_comp > 0, "transfer_tick: no completion exercised")
    n = L * S * F
    n_act = int(active.sum())
    need, n_ops = transfer_bound(torch, active, got[1], n_months)
    nb, kind = bound_ms(need, n_ops)
    results["transfer_tick"] = dict(
        max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=time_ms(torch, lambda: ops.transfer_tick(*args)),
        device_us=device_us(torch, lambda: ops.transfer_tick(*args)),
        plain_ms=time_ms(torch, lambda: ref.transfer_tick(*args)),
        bound_ms=nb, bound_by=kind, library_ms=None)
    log(f"kernel transfer_tick: new_done/comp bitwise, billing max rel err "
        f"{rel:.3g}, {n_act} active, {n_comp} completions, bound counts "
        f"{need / 1e6:.2f} MB")
    del link_id, active, total, done, got, want

    # -- gcs_admit: sparse candidates as in the tick (files whose last
    # consumer just finished), half the lanes under a finite limit that
    # cuts through the candidates; plus a dense unlimited case.
    want_m = rand(L, S, F) < 2e-5
    used = 1e12 * rand(L)
    wanted = (sizes * want_m).sum((1, 2))
    finite = torch.arange(L, device=dev) % 2 == 0
    limit = torch.where(finite, used + 0.5 * wanted,
                        torch.tensor(float("inf"), device=dev))
    gargs = (want_m, sizes, used, limit, dt, month, n_months)
    got = ops.gcs_admit(*gargs)
    plain = ref.gcs_admit(*gargs)
    torch.cuda.synchronize()
    ties, tie_bytes = gcs_tie_check(torch, want_m, sizes, used, limit,
                                    got[0], plain[0], ref.GCS_ADMIT_PASSES)
    # the migration rank: bitwise the plain rank of the kernel's own mask,
    # and so the plain version's wherever the masks agree (no tie)
    check(torch.equal(got[3], ref.admission_rank(got[0])),
          "gcs_admit: rank differs from the per-site rank of its mask")
    check(ties > 0 or torch.equal(got[3], plain[3]),
          "gcs_admit: rank differs from the plain version's")
    check(torch.equal(got[0][~finite], want_m[~finite]),
          "gcs_admit: unlimited lanes must admit every candidate")
    check(bool((got[0] != want_m)[finite].any()),
          "gcs_admit: the finite limit did not bind")
    # every lane: rtol 1e-6, widened on a lane with ties by the tied bytes
    u_err = (got[1] - plain[1]).abs()
    check(bool((u_err <= 1e-6 * plain[1].abs() + tie_bytes).all()),
          f"gcs_admit: used' differs by {u_err.tolist()}")
    g_tol = 1e-6 * plain[2].abs() + (tie_bytes / 1e9 * dt)[:, None]
    check(bool(((got[2] - plain[2]).abs() <= g_tol).all()),
          "gcs_admit: gbsec differs")
    dense = rand(L, S, F) < 0.3
    inf_limit = torch.full((L,), float("inf"), device=dev)
    dg = ops.gcs_admit(dense, sizes, used, inf_limit, dt, month, n_months)
    dp = ref.gcs_admit(dense, sizes, used, inf_limit, dt, month, n_months)
    torch.cuda.synchronize()
    check(torch.equal(dg[0], dp[0]), "gcs_admit: dense unlimited mask")
    check(torch.equal(dg[3], dp[3]), "gcs_admit: dense unlimited rank")
    torch.testing.assert_close(dg[1], dp[1], rtol=1e-6, atol=0.0)
    dense_ms = time_ms(torch, lambda: ops.gcs_admit(
        dense, sizes, used, inf_limit, dt, month, n_months), n=5)
    # the same dense candidates under finite limits on half the lanes:
    # about 600k candidates a lane summed in two orders, each difference a
    # tie within 16 ulps of the limit
    dense_limit = torch.where(finite, used + 0.5 * (sizes * dense).sum(
        (1, 2)), inf_limit)
    dl = ops.gcs_admit(dense, sizes, used, dense_limit, dt, month, n_months)
    dlp = ref.gcs_admit(dense, sizes, used, dense_limit, dt, month,
                        n_months)
    torch.cuda.synchronize()
    dense_ties, _ = gcs_tie_check(torch, dense, sizes, used, dense_limit,
                                  dl[0], dlp[0], ref.GCS_ADMIT_PASSES)
    check(bool((dl[0] != dense)[finite].any()),
          "gcs_admit: the dense finite limit did not bind")
    del dl, dlp
    n_cand = int(want_m.sum())
    # needed: the candidate flag in and the admission out for every file,
    # the size only of candidates; per-lane scalars and the month row; the
    # migration rank out for every file (int32) since the kernel returns it
    need = (n * (1 + 1) + sector_bytes(torch, want_m, 4) + L * 4 * 3
            + L * n_months * 4)
    n_ops = 3 * n_cand * ref.GCS_ADMIT_PASSES
    nb_old, _ = bound_ms(need, n_ops)
    nb, kind = bound_ms(need + 4 * n, n_ops)
    results["gcs_admit"] = dict(
        max_abs_err=float(u_err.max()),
        ms=time_ms(torch, lambda: ops.gcs_admit(*gargs)),
        device_us=device_us(torch, lambda: ops.gcs_admit(*gargs)),
        plain_ms=time_ms(torch, lambda: ref.gcs_admit(*gargs)),
        bound_ms=nb, bound_by=kind, bound_ms_without_rank=nb_old,
        library_ms=None)
    log(f"kernel gcs_admit: {n_cand} candidates, {ties} boundary ties "
        f"(each within 16 ulps of the limit), rank bitwise, used'/gbsec on "
        f"every lane, dense unlimited case ({int(dense.sum())} candidates) "
        f"exact in {dense_ms:.4f} ms, dense case with finite limits on half "
        f"the lanes: {dense_ties} boundary ties (each within 16 ulps of the "
        f"limit), bound counts {(need + 4 * n) / 1e6:.2f}"
        f" MB ({need / 1e6:.2f} MB without the rank plane: bound "
        f"{nb_old:.4f} ms)")
    del want_m, dense, got, plain, dg, dp

    # -- window_admit: both candidate windows of a tick in one launch, the
    # K job window and the W = 4 wait-queue heads, some heads holding a
    # file of a K slot, against disk headroom that some candidates fill
    W = 4
    absent = rand(L, S, K) < 0.7
    size_k = sizes[:, :, :K].contiguous()
    fid_k = torch.randint(0, 64, (L, S, K), generator=gen, device=dev)
    valid_w = rand(L, S, W) < 0.8
    present_w = rand(L, S, W) < 0.2
    size_w = sizes[:, :, K:K + W].contiguous()
    idx_w = torch.where(rand(L, S, W) < 0.5,
                        fid_k[..., torch.arange(W, device=dev) % max(K, 1)],
                        torch.randint(64, F, (L, S, W), generator=gen,
                                      device=dev))
    limit_d = torch.full((L, S), 1e13, device=dev)
    used_d = limit_d - (size_k.sum(-1) + size_w.sum(-1)) * rand(L, S)
    wargs = (absent, size_k, fid_k, valid_w, present_w, size_w, idx_w,
             used_d, limit_d)
    before = ops.launch_counts()["window_admit"]
    got = ops.windows_admit(*wargs)
    check(ops.launch_counts()["window_admit"] == before + 1,
          "window_admit: not one launch for both windows")
    plain = ref.windows_admit(*wargs)
    torch.cuda.synchronize()
    for name, g, w in zip(("started", "admitted", "stale", "disk_used"),
                          got, plain):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"window_admit: {name} not bitwise")
    n_jump = int((plain[2] & ~present_w).sum())
    check(n_jump > 0 and bool(plain[0].any()) and bool(plain[1].any()),
          "window_admit: no started, admitted or jumped head exercised")
    live_w = valid_w & ~plain[2]
    # needed: the K and W masks in and out per slot (absent, started;
    # valid, present, stale, admitted), the size of absent slots and live
    # heads, the fid of started slots and the head index of valid heads
    # (by the sectors they touch); used, limit and used' per row
    need = (L * S * (2 * K + 4 * W) + sector_bytes(torch, absent, 4)
            + sector_bytes(torch, live_w, 4)
            + sector_bytes(torch, plain[0], 8)
            + sector_bytes(torch, valid_w, 8) + L * S * 12)
    nb, kind = bound_ms(need, 0.0)
    results["window_admit"] = dict(
        max_abs_err=float((got[3] - plain[3]).abs().max()),
        ms=time_ms(torch, lambda: ops.windows_admit(*wargs)),
        graph_ms=graph_ms(torch, lambda: ops.windows_admit(*wargs)),
        device_us=device_us(torch, lambda: ops.windows_admit(*wargs)),
        plain_ms=time_ms(torch, lambda: ref.windows_admit(*wargs)),
        bound_ms=nb, bound_by=kind, library_ms=None)
    log(f"kernel window_admit: K={K} and W={W} windows in one launch, "
        f"started/admitted/stale/disk_used bitwise, {n_jump} heads stale "
        f"because a K slot started their file; {need} bytes needed; "
        f"{results['window_admit']['graph_ms']:.4f} ms a call replayed "
        f"from a graph of 20 calls")
    for name, r in results.items():
        log(f"  {name}: ms {r['ms']:.4f} device_us {r['device_us']:.1f} "
            f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return results


GLUE_STEPS = ("begin", "complete", "link_admit", "migrate", "wait_select")

#: Ticks of the sweep grid before the glue kernels are checked on its
#: state (the first ticks complete and migrate little), and the ticks
#: compared after it; both cut to fit a shorter horizon.
GLUE_STATE_TICK = 600
GLUE_WINDOW_TICKS = 200


@contextlib.contextmanager
def plain_glue():
    """The ``cuda`` tick with the plain glue (``tick_glue.ref``) in place
    of the glue kernels, the lane-tick kernels unchanged."""
    from repro_torch.kernels.tick_glue import ops, ref

    saved = {step: getattr(ops, step) for step in GLUE_STEPS}
    try:
        for step in GLUE_STEPS:
            setattr(ops, step, getattr(ref, step))
        yield
    finally:
        for step, fn in saved.items():
            setattr(ops, step, fn)


def same_state(torch, got, want, what: str) -> None:
    """Every tensor of two state dicts bitwise equal (floats by their
    bits)."""
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{what}: {key} not bitwise")


def restored_ms(torch, fn, restore, n: int = 10, warm: int = 2,
                key: str = None):
    """``fn``'s milliseconds per call by CUDA events recorded around each
    call, its state restored before each (``restore``, outside the
    events); with ``key``, also the device microseconds per call of the
    kernels whose name holds ``key`` (``torch.profiler`` over ``n`` more
    calls). Returns (ms, device_us or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pairs = []
    for i in range(warm + n):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        if i >= warm:
            pairs.append((a, b))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in pairs) / n
    if key is None:
        return ms, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            restore()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key) / n
    return ms, us


def glue_bytes(torch, pre, post, x, work_ints: int) -> dict:
    """Bytes each glue step needs at these inputs: the planes every
    element needs once (dense), the others by the 32-byte sectors that
    the step's masks touch, and the [L, 3S] vectors. ``pre`` and ``post``
    map each step to the state before and after it; ``x`` holds the
    tick's values (``now``, ``comp``, ``mig``, ``W``)."""
    from repro_torch.kernels.tick_glue.ref import ABSENT, PRESENT

    def sec(mask, itemsize):
        return sector_bytes(torch, mask, itemsize)

    st0 = pre["begin"]
    n = st0["tr_slot"].numel()
    R = st0["disk_used"].numel()
    out = {"begin": 2 * n + sec(st0["tr_slot"], 4) + 4 * work_ints}
    s, comp = pre["complete"], x["comp"]
    lt = torch.remainder(s["tr_link"], 3)
    inb, cm = comp & (lt != 2), comp & (lt == 2)
    no_cons = (s["pend_cnt"] == 0) & (s["fin_max"] <= x["now"])
    d1 = torch.where(inb, PRESENT, s["disk_state"])
    drop = cm & no_cons & (d1 == PRESENT)
    d2 = torch.where(drop, ABSENT, d1)
    cand = no_cons & (d2 == PRESENT) & x["limited"]
    dele = cand & (post["complete"]["disk_state"] == ABSENT)
    changed = post["complete"]["disk_state"] != s["disk_state"]
    out["complete"] = (
        23 * n + sec(s["tr_slot"] | comp, 4) + sec(comp, 1)
        + 2 * sec(comp, 4) + sec(cand, 4) + sec(cm, 4) + sec(cand, 1)
        + sec(drop | dele, 4) + sec(changed, 4) + 3 * sec(inb, 4)
        + sec(inb & (s["pend_cnt"] > 0), 4) + 5 * 4 * 3 * R + 8 * R)
    s, q = pre["link_admit"], pre["link_admit"]["lq_queued"]
    adm = q & ~post["link_admit"]["lq_queued"]
    out["link_admit"] = (n + 2 * sec(q, 4) + 2 * sec(adm, 1)
                         + sec(adm, 4) + 2 * 4 * 3 * R)
    s, m = pre["migrate"], x["mig"]
    queued = m & post["migrate"]["lq_queued"] & ~s["lq_queued"]
    direct = m & ~queued
    out["migrate"] = (n + 6 * sec(m, 4) + sec(direct, 1) + sec(direct, 4)
                      + sec(queued, 4) + sec(queued, 1) + 5 * 4 * 3 * R)
    # the wait flags dense, the ticket where a file waits; lowest and idx
    # out
    s = pre["wait_select"]
    out["wait_select"] = (n + sec(s["wq_wait"], 4)
                          + R * x["W"] * (4 + 8))
    return out


def glue_check(torch, label: str, st0, c, now, dt, month, n_months,
               tt=None, ga=None) -> dict:
    """One tick's glue from state ``st0`` through the kernels
    (``tick_glue.ops``) and the plain versions (``tick_glue.ref``) side by
    side, each step from the same state and inputs, every state tensor
    and output bitwise after each. The lane-tick kernels between the
    steps run once on the kernel side's values and feed both sides
    (``tt``: ``(new_done, comp)`` in place of ``transfer_tick``'s, ``ga``:
    ``(mig, rank)`` in place of ``gcs_admit``'s). Then each step is timed
    from its own state (restored before each call), the kernel and the
    plain version, beside the bound of the bytes it needs. Returns a
    result dict per step."""
    from repro_torch.kernels.lane_tick import ops as lt_ops
    from repro_torch.kernels.lane_tick.ref import GCS_ADMIT_PASSES
    from repro_torch.kernels.tick_glue import ops, ref
    from repro_torch.kernels.tick_glue.ref import BIG_TICKET
    from repro_torch.sim.batched import WAIT_ADMITS_PER_TICK as W

    def clone(s):
        return {k: v.clone() for k, v in s.items()}

    sizes = c["sizes"]
    k, p = clone(st0), clone(st0)
    pre, post, calls = {}, {}, {}
    x = {"now": now, "limited": c["limited"], "W": W}
    # begin
    pre["begin"] = clone(k)
    a_k, w_k = ops.begin(k, now, dt)
    a_p, w_p = ref.begin(p, now, dt)
    calls["begin"] = (lambda s, w: ops.begin(s, now, dt),
                      lambda s, w: ref.begin(s, now, dt))
    check(torch.equal(a_k, a_p), f"glue_begin ({label}): t_active")
    same_state(torch, k, p, f"glue_begin ({label})")
    post["begin"] = clone(k)
    if tt is None:
        tt = lt_ops.transfer_tick(k["tr_link"], a_k, k["tr_done"],
                                  k["tr_total"], sizes, c["bw"], c["mode"],
                                  dt, month, n_months)[:2]
    new_done, comp = tt
    x["comp"] = comp
    # complete
    pre["complete"] = clone(k)
    want_k, occ_k = ops.complete(k, c, now, new_done, comp, w_k)
    want_p, occ_p = ref.complete(p, c, now, new_done, comp, w_p)
    calls["complete"] = (
        lambda s, w: ops.complete(s, c, now, new_done, comp, w),
        lambda s, w: ref.complete(s, c, now, new_done, comp, w))
    check(torch.equal(want_k, want_p), f"glue_complete ({label}): want_mig")
    check(torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32)),
          f"glue_complete ({label}): occ3")
    same_state(torch, k, p, f"glue_complete ({label})")
    post["complete"] = clone(k)
    # link_admit
    pre["link_admit"] = clone(k)
    ops.link_admit(k, c, now, w_k)
    ref.link_admit(p, c, now, w_p)
    calls["link_admit"] = (lambda s, w: ops.link_admit(s, c, now, w),
                           lambda s, w: ref.link_admit(s, c, now, w))
    same_state(torch, k, p, f"glue_link_admit ({label})")
    post["link_admit"] = clone(k)
    if ga is None:
        ga = lt_ops.gcs_admit(want_k, sizes, k["gcs_used"], c["gcs_limit"],
                              dt, month, n_months, GCS_ADMIT_PASSES)
        ga = (ga[0], ga[3])
    mig, rank = ga
    x["mig"] = mig
    # migrate (occ3 is updated in place: each side its own copy)
    occ_k0 = occ_k.clone()
    pre["migrate"] = clone(k)
    ops.migrate(k, c, now, mig, rank, occ_k, w_k)
    ref.migrate(p, c, now, mig, rank, occ_p, w_p)
    occ_t = occ_k0.clone()
    calls["migrate"] = (
        lambda s, w: ops.migrate(s, c, now, mig, rank, occ_t, w),
        lambda s, w: ref.migrate(s, c, now, mig, rank, occ_t, w))
    check(torch.equal(occ_k.view(torch.int32), occ_p.view(torch.int32)),
          f"glue_migrate ({label}): occ3")
    same_state(torch, k, p, f"glue_migrate ({label})")
    post["migrate"] = clone(k)
    # wait_select (reads the wait queue, which no glue step writes)
    pre["wait_select"] = clone(k)
    sel_k = ops.wait_select(k, W, w_k)
    sel_p = ref.wait_select(p, W, w_p)
    calls["wait_select"] = (lambda s, w: ops.wait_select(s, W, w),
                            lambda s, w: ref.wait_select(s, W, w))
    for name, g, w in zip(("lowest", "idx"), sel_k, sel_p):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"glue_wait_select ({label}): {name} not bitwise")
    same_state(torch, k, p, f"glue_wait_select ({label})")
    post["wait_select"] = clone(k)
    need = glue_bytes(torch, pre, post, x, int(w_k.numel()))
    stats = dict(
        completions=int(comp.sum()), want_mig=int(want_k.sum()),
        admitted=int((pre["link_admit"]["lq_queued"]
                      & ~post["link_admit"]["lq_queued"]).sum()),
        migrations=int(mig.sum()),
        queued=int((post["migrate"]["lq_queued"]
                    & ~pre["migrate"]["lq_queued"]).sum()),
        waiting=int(k["wq_wait"].sum()),
        heads=int((sel_k[0] < BIG_TICKET).sum()))

    # timing: each step from its own state, restored before each call;
    # the kernels' work buffer zeroed as begin leaves it
    out = {}
    for step in GLUE_STEPS:
        s = clone(pre[step])
        w_kt = torch.zeros_like(w_k)
        w_pt = ref.begin(s, now, dt)[1]

        def restore(step=step, s=s, w=w_kt):
            for key, v in pre[step].items():
                s[key].copy_(v)
            w.zero_()
            if step == "migrate":
                occ_t.copy_(occ_k0)

        kern, plain = calls[step]
        ms, dev_us = restored_ms(torch, lambda: kern(s, w_kt), restore,
                                 key=f"tg_{step}_kernel")
        plain_ms, _ = restored_ms(torch, lambda: plain(s, w_pt), restore,
                                  n=5)
        nb, kind = bound_ms(need[step], 0.0)
        out[step] = dict(max_abs_err=0.0, ms=ms, device_us=dev_us,
                         plain_ms=plain_ms, bound_ms=nb, bound_by=kind,
                         library_ms=None, bytes=need[step])
    # the library call of the selection: torch.topk of the tickets, as
    # the tick took it before tg_wait_select (never on the port's path)
    s = pre["wait_select"]

    def topk():
        tickets = torch.where(s["wq_wait"], s["wq_ticket"], BIG_TICKET)
        return torch.topk(tickets, W, dim=-1, largest=False,
                          sorted=True)

    out["wait_select"]["library_ms"] = time_ms(torch, topk, n=10)
    out["wait_select"]["library_device_us"] = device_us(torch, topk, n=10)
    # what the card streams at tg_complete's bytes: a copy of half of
    # them (read once, written once), the dense floor beside its bound
    half = torch.empty(need["complete"] // 8, dtype=torch.float32,
                       device=sizes.device)
    dst = torch.empty_like(half)
    out["complete"]["copy_device_us"] = device_us(
        torch, lambda: dst.copy_(half), n=10)
    del half, dst
    log(f"glue kernels ({label}): every state tensor and output bitwise "
        f"after each step; {stats}; a copy of glue_complete's bytes "
        f"{out['complete']['copy_device_us']:.1f} us of device time; "
        f"torch.topk of the wait tickets {out['wait_select']['library_ms']:.4f}"
        f" ms, device {out['wait_select']['library_device_us']:.1f} us")
    for step, r in out.items():
        log(f"  glue_{step}: ms {r['ms']:.4f} device_us "
            f"{r['device_us']:.1f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}, {r['bytes'] / 1e6:.1f} "
            f"MB)")
    return out


def dense_glue_state(torch, st, c, now, share: float = 0.3):
    """A synthetic state at the sweep's shapes on the sweep's constants:
    about ``share`` of the planes completing, queued on a link and
    migrating, file states drawn from all three, half the files with
    pending jobs, busy link queues, about ``share`` of the files waiting
    in the wait queue. Returns ``(state, (new_done, comp), (mig,
    rank))``."""
    from repro_torch.kernels.lane_tick.ref import admission_rank

    dev = st["tr_slot"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(2020)
    L, S, F = st["tr_slot"].shape

    def rand():
        return torch.rand((L, S, F), generator=gen, device=dev)

    def ints(hi):
        return torch.randint(0, hi, (L, S, F), generator=gen, device=dev,
                             dtype=torch.int32)

    s = {k: v.clone() for k, v in st.items()}
    site = torch.arange(S, device=dev, dtype=torch.int32).view(1, S, 1)
    slot = rand() < 2 * share
    comp = slot & (rand() < 0.5)
    s["tr_slot"].copy_(slot)
    s["tr_link"].copy_(3 * site + ints(3))
    s["tr_total"].copy_(torch.where(slot, c["sizes"], float("inf")))
    s["tr_done"].copy_(torch.where(slot, c["sizes"] * rand(), 0.0))
    s["tr_start"].copy_(torch.where(slot, now - 30.0 * rand(),
                                    float("inf")))
    new_done = torch.where(comp, s["tr_total"], s["tr_done"])
    queued = ~slot & (rand() < share / (1 - 2 * share))
    s["lq_queued"].copy_(queued)
    busy = torch.rand(s["lq_next"].shape, generator=gen, device=dev) < 0.5
    s["lq_next"].copy_(s["lq_serve"] + torch.where(busy, 1000, 0))
    serve = torch.gather(s["lq_serve"].view(L, S, 3), -1,
                         (s["tr_link"] % 3).long())
    s["lq_ticket"].copy_(torch.where(queued, serve + ints(200) - 100, 0))
    s["disk_state"].copy_(ints(3))
    s["gcs_state"].copy_(ints(3))
    s["pend_cnt"].copy_(torch.where(rand() < 0.5, 0, ints(3) + 1))
    s["fin_max"].copy_(now + 100.0 * (rand() - 0.5))
    s["pend_tail"].copy_(1e3 * rand())
    mig = rand() < share
    s["wq_wait"].copy_(rand() < share)
    s["wq_ticket"].copy_(ints(1000))  # tied tickets: the index breaks ties
    return s, (new_done, comp), (mig, admission_rank(mig))


def glue_phase(torch, grid) -> dict:
    """The tick-glue kernels on the sweep grid. The ``cuda`` tick with the
    glue kernels, captured and replayed, and the same tick with the plain
    glue (eager, the same lane-tick kernels) run side by side: every
    state tensor bitwise after :data:`GLUE_STATE_TICK` ticks and after
    :data:`GLUE_WINDOW_TICKS` more (at most half the horizon, and the
    rest of it). On the fused loop's state at that tick, and on a dense
    synthetic state (:func:`dense_glue_state`), each glue kernel against
    its plain version (:func:`glue_check`). Returns the per-step results
    on the sweep's state and the tick of that state."""
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    dev = torch.device("cuda")
    impl = resolve_tick_impl("cuda", dev)
    fused = TickLoop(grid, impl, dev, graph=True)
    plain = TickLoop(grid, impl, dev, graph=False)

    def advance_both(n):
        fused.advance(n)
        with plain_glue():
            plain.advance(n)
        torch.cuda.synchronize()
        same_state(torch, fused.st, plain.st,
                   f"fused against plain glue at tick {fused.t}")
        log(f"glue: the captured cuda tick with the glue kernels and the "
            f"eager one with the plain glue bitwise on all "
            f"{len(fused.st)} state tensors at tick {fused.t}")

    state_tick = min(GLUE_STATE_TICK, grid.n_ticks // 2)
    advance_both(state_tick)
    t = fused.st["tick"]
    c = fused.c
    now = c["times"].index_select(0, t).view(())
    dt = c["dts"].index_select(0, t).view(())
    month = c["month_idx"].index_select(0, t).view(())
    res = glue_check(torch, f"sweep state at tick {fused.t}", fused.st, c,
                     now, dt, month, grid.n_months)
    dense, tt, ga = dense_glue_state(torch, fused.st, c, now)
    glue_check(torch, "dense synthetic state, shares 0.3", dense, c, now,
               dt, month, grid.n_months, tt=tt, ga=ga)
    del dense, tt, ga
    advance_both(min(GLUE_WINDOW_TICKS, grid.n_ticks - state_tick))
    del fused, plain
    torch.cuda.empty_cache()
    return res, state_tick


def trace_phase(torch, grid) -> list:
    """The tick's tracing (``kernels.trace_tick``) on the sweep grid (see
    the module notes). Returns the kernels line's cases of ``trace_stamp``
    and ``trace_count``, each with its launches on the traced loop."""
    from repro_torch.kernels import trace_tick
    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.kernels.tick_glue import ops as glue_ops
    from repro_torch.kernels.trace_tick import ops as trk
    from repro_torch.kernels.trace_tick import ref as trk_ref
    from repro_torch.obs.trace import get_tracer
    from repro_torch.sim.batched import GRAPH_WARMUP_TICKS, TickLoop

    dev = torch.device("cuda")
    impl = resolve_tick_impl("cuda", dev)
    stride, n_seg = trace_tick.COUNT_STRIDE, len(trace_tick.SEGMENTS)
    L, S, F = grid.n_lanes, len(grid.site_names), grid.sizes.shape[-1]
    upto = max(grid.n_ticks // 2 // stride, 1) * stride
    check(upto < grid.n_ticks, f"trace: {grid.n_ticks} ticks reach no "
                               f"counted tick after the first")
    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        cap = TickLoop(grid, impl, dev, graph=True)
        eager = TickLoop(grid, impl, dev, graph=False)
        check(cap.trace and eager.trace, "trace: a loop built with the "
                                         "tracer on is not traced")
        cap.advance(GRAPH_WARMUP_TICKS)
        torch.cuda.synchronize()
        for lib in (ops, glue_ops, trk):
            lib.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        cap.advance(upto - cap.t)
        stop.record()
        torch.cuda.synchronize()
        replays = upto - GRAPH_WARMUP_TICKS
        launched = {**ops.launch_counts(), **glue_ops.launch_counts(),
                    **trk.launch_counts()}
        check(launched == {**{k: replays
                              for k in ops.KERNELS + glue_ops.KERNELS},
                           "trace_stamp": n_seg * replays,
                           "trace_count": replays},
              f"trace: launches {launched} over {replays} replayed ticks")
        cap.result()
        tick = [e["args"] for e in tracer.events
                if e["name"] == "sweep.torch.tick"][-1]
        stamped_ns = (sum(g["sum_ns"] for g in tick["segments"].values())
                      + tick["replay_gap"]["sum_ns"])
        event_ns = 1e6 * start.elapsed_time(stop)
        check(tick["clock"] == "globaltimer" and tick["ticks"] == replays
              and tick["lane_ticks"] == L * (upto // stride),
              f"trace: the tick instant stamps {tick['ticks']} ticks on "
              f"{tick['clock']} and counts {tick['lane_ticks']} lane-ticks "
              f"({replays} replayed, {upto // stride} counted, {L} lanes)")
        log(f"trace: {replays} replayed traced ticks to tick {upto}, "
            f"launches {launched}; stamped {stamped_ns / replays / 1e3:.1f} "
            f"us a tick against {event_ns / replays / 1e3:.1f} by CUDA "
            f"events ({stamped_ns / event_ns:.4f}); counts "
            f"{tick['counts']} over {tick['lane_ticks']} lane-ticks")

        # the next tick, a counted one: eager on a copy of the state, its
        # count's inputs kept, beside its replay
        for k, v in cap.st.items():
            eager.st[k].copy_(v)
        kept = {}
        count = trace_tick.count

        def keeping(counts, *args):
            kept["args"] = tuple(a.clone() for a in args)
            return count(counts, *args)

        trace_tick.count = keeping
        try:
            eager.advance(1)
        finally:
            trace_tick.count = count
        cap.advance(1)
        torch.cuda.synchronize()
        for k in cap.st:
            check(k == "trace_acc" or torch.equal(cap.st[k], eager.st[k]),
                  f"trace: eager and replayed traced tick {upto}: {k} "
                  f"differs")
    finally:
        tracer.disable()
        tracer.reset()
    # the count's inputs: tick, want, mig, occ3, lq_next, lq_serve,
    # wq_wait, work
    args = kept["args"]
    check(int(args[0][0]) - 1 == upto, f"trace: kept tick {args[0]}")
    got = torch.zeros((L, len(trace_tick.COUNTS)), dtype=torch.int64,
                      device=dev)
    trk.count(got, *args)
    plain = torch.zeros_like(got)
    trk_ref.count(plain, *args[:-1])
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"trace: trace_count {got.tolist()} "
                                   f"against the plain {plain.tolist()}")
    check(bool((plain[:, 2] > 0).all() and (plain[:, 3] > 0).any()),
          f"trace: tick {upto} has no active transfer or waiting file to "
          f"count ({plain.tolist()})")
    cap.close()
    eager.close()
    del cap, eager
    torch.cuda.empty_cache()
    scratch = torch.zeros_like(got)
    skipped = (args[0] + 1,) + args[1:]
    n = L * S * F
    need = 2 * n + L * S * (12 + 24 + 8) + 2 * L * 8 * len(trace_tick.COUNTS)
    nb, kind = bound_ms(need, 0.0)
    count_row = dict(
        max_abs_err=0,
        ms=time_ms(torch, lambda: trk.count(scratch, *args)),
        graph_ms=graph_ms(torch, lambda: trk.count(scratch, *args)),
        device_us=device_us(torch, lambda: trk.count(scratch, *args)),
        plain_ms=time_ms(torch, lambda: trk_ref.count(scratch, *args[:-1])),
        bound_ms=nb, bound_by=kind, library_ms=None)
    skip_us = device_us(torch, lambda: trk.count(scratch, *skipped))
    acc = torch.zeros((trk_ref.acc_size(),), dtype=torch.int64, device=dev)
    host_acc = torch.zeros((trk_ref.acc_size(),), dtype=torch.int64)
    nb_s, kind_s = bound_ms(64, 0.0)  # the last stamp and a row, in and out
    stamp_row = dict(
        max_abs_err=None,  # a clock: no plain value to hold it to
        ms=time_ms(torch, lambda: trk.stamp(acc, 1)),
        graph_ms=graph_ms(torch, lambda: trk.stamp(acc, 1)),
        device_us=device_us(torch, lambda: trk.stamp(acc, 1)),
        plain_ms=time_ms(torch, lambda: trk_ref.stamp(host_acc, 1)),
        bound_ms=nb_s, bound_by=kind_s, library_ms=None)
    log(f"trace: tick {upto}'s counts a lane {got.tolist()} exact to the "
        f"plain count on its planes; eager and replayed traced tick bitwise "
        f"on every state tensor but the stamps")
    for name, r in (("trace_count", count_row), ("trace_stamp", stamp_row)):
        log(f"  {name}: ms {r['ms']:.4f} graph_ms {r['graph_ms']:.4f} "
            f"device_us {r['device_us']:.2f} plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    log(f"  trace_count on a tick it skips: device_us {skip_us:.2f}")
    shapes = f"sweep shapes (L {L}, S {S}, F {F})"
    return [("trace_stamp", f"{shapes}, {n_seg} a replayed tick",
             launched["trace_stamp"], stamp_row),
            ("trace_count", f"{shapes}, tick {upto}'s planes (a counted "
             f"tick)", launched["trace_count"], count_row)]


def counted_ticks(torch, loop, upto: int):
    """Advance a traced loop to tick ``upto``, reading its counters
    (``kernels.trace_tick``) around each counted tick on the way: what each
    counted tick added a lane, ``[ticks, L, len(COUNTS)]`` (``None`` where
    no tick on the way is counted)."""
    from repro_torch.kernels.trace_tick import COUNT_STRIDE

    added = []
    while True:
        nxt = -(-loop.t // COUNT_STRIDE) * COUNT_STRIDE
        if nxt >= upto:
            break
        loop.advance(nxt - loop.t)
        before = loop.st["trace_counts"].clone()  # in stream order: no sync
        loop.advance(1)
        added.append(loop.st["trace_counts"] - before)
    loop.advance(upto - loop.t)
    return torch.stack(added).cpu() if added else None


def profile_phase(torch, grid, graph: bool, warm: int = 20,
                  n: int = 40, record_series=None) -> dict:
    """Where a tick's time goes on the ``cuda`` path, replayed from its
    CUDA graph (``graph``) or eager: after ``warm`` ticks, ``n`` ticks of
    the grid's loop (``sim.batched.TickLoop``, as ``simulate_packed``
    drives it, with series capture at ``record_series`` when given) timed
    on the host clock, then the next ``n`` under ``torch.profiler`` for
    device time by kernel. The eager loop is traced (built with the tracer
    on), so its times hold the trace library's launches (printed apart);
    its counters give the GCS candidates and admissions a lane on each
    counted tick (:func:`counted_ticks`) from the profiled ticks to
    half-way through the horizon, and on 8 counted ticks from there.
    Returns the wall and device-busy microseconds per tick (busy ``None``
    when the profiler saw no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.obs.trace import get_tracer
    from repro_torch.sim.batched import TickLoop

    dev = torch.device("cuda")
    kw = {}
    if record_series:  # (a parent checkout's loop may not take record=)
        from repro_torch.sim.batched import _normalize_record

        kw["record"] = _normalize_record(record_series, grid.n_ticks)
    tracer = get_tracer()
    if not graph:
        tracer.reset()
        tracer.enable()
    try:
        loop = TickLoop(grid, resolve_tick_impl("cuda", dev), dev,
                        graph=graph, **kw)
    finally:
        if not graph:
            tracer.disable()
            tracer.reset()
    name = ("captured" if graph else "eager") + (
        f", series every {record_series} ticks" if record_series else "")
    loop.advance(warm)
    torch.cuda.synchronize()
    # the same number of ticks once without the profiler: its own host
    # cost would inflate the wall time
    t0 = time.perf_counter()
    loop.advance(n)
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.advance(n)
        torch.cuda.synchronize()
        prof_wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (the operators that launched them carry the
    # same time again)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    ours_us = sum(r[1] for r in rows
                  if any(k in r[0] for k in ("tt_", "ga_", "wa_")))
    trace_us = sum(r[1] for r in rows if "trk_" in r[0])
    glue_us = {step: sum(r[1] for r in rows if f"tg_{step}_kernel" in r[0])
               for step in GLUE_STEPS}
    capture = (f"; capture {loop.capture_s * 1e3:.1f} ms, graph pool "
               f"{loop.pool_bytes} bytes" if graph else "")
    if not rows:
        log(f"profile {name} ({n} ticks after {warm + n}): wall "
            f"{wall_us / n:.1f} us/tick unprofiled ({prof_wall_us / n:.1f} "
            f"profiled); the profiler saw no kernel inside the replays"
            f"{capture}")
        return dict(wall_us=wall_us / n, busy_us=None)
    log(f"profile {name} ({n} ticks after {warm + n}): wall "
        f"{wall_us / n:.1f} us/tick unprofiled ({prof_wall_us / n:.1f} "
        f"profiled), device busy {busy_us / n:.1f} us/tick, lane-tick kernels "
        f"{ours_us / n:.1f} us/tick, glue kernels "
        f"{sum(glue_us.values()) / n:.1f} us/tick ("
        + ", ".join(f"{k} {v / n:.1f}" for k, v in glue_us.items())
        + f"), trace kernels {trace_us / n:.1f} us/tick (in the busy time), "
        f"{len(rows)} device kernels by name{capture}")
    for key, us, count in rows[:12]:
        log(f"  {us / n:9.1f} us/tick {count / n:6.1f}/tick  {key[:90]}")
    # the wait queue glue_wait_select reads, after the profiled ticks: its
    # files, the most in a row, and the 512-flag groups (a warp's flags of
    # one load) holding one or more, and 32 or more (keyed thread by thread)
    wait = loop.st["wq_wait"].reshape(-1, loop.st["wq_wait"].shape[-1])
    per_row = wait.sum(-1)
    groups = torch.nn.functional.pad(
        wait.to(torch.int32), (0, -wait.shape[-1] % 512)).reshape(
            wait.shape[0], -1, 512).sum(-1)
    wait_queue = dict(waiting=int(per_row.sum()), row_max=int(per_row.max()),
                      groups=int((groups > 0).sum()),
                      dense_groups=int((groups >= 32).sum()))
    log(f"  wait queue after the profiled ticks: {wait_queue}")
    # torch.topk's kernels (gatherTopK, computeBlockDigitCounts, radix
    # select) and PyTorch's reductions (reduce_kernel), a tick
    topk = [r for r in rows if any(k in r[0].lower() for k in (
        "topk", "digitcount", "radix"))]
    reduce = [r for r in rows if "reduce_kernel" in r[0]]
    topk_us = sum(r[1] for r in topk) / n
    log(f"  torch.topk kernels: {len(topk)} names, {topk_us:.1f} us/tick; "
        f"PyTorch reductions (reduce_kernel): "
        f"{sum(r[2] for r in reduce) / n:.1f} launches/tick, "
        f"{sum(r[1] for r in reduce) / n:.1f} us/tick")
    # torch.cumsum by its operator: calls and the device time under them
    # (a replay runs no operator, so only the eager ticks show them)
    cumsum = [e for e in prof.key_averages() if e.key == "aten::cumsum"]
    cs_calls = sum(e.count for e in cumsum)
    cs_us = sum(e.device_time_total for e in cumsum)
    log(f"  torch.cumsum: {cs_calls / n:.1f} calls/tick, {cs_us / n:.1f} "
        f"us/tick of device time")
    if not graph:
        # the same counts on each counted tick from the profiled ticks to
        # half-way through the horizon, then on 8 more from there, where
        # jobs have finished and files lose their last consumer
        from repro_torch.kernels.trace_tick import COUNT_STRIDE

        mid = max(warm + 2 * n, grid.n_ticks // 2)
        for upto in (mid, min(grid.n_ticks, mid + 8 * COUNT_STRIDE)):
            first = loop.t
            per = counted_ticks(torch, loop, upto)
            if per is None:
                continue
            cand, adm = per[..., 0].float(), per[..., 1].float()
            log(f"  GCS candidates a lane on the {per.shape[0]} counted ticks "
                f"of ticks {first}-{upto} (every {COUNT_STRIDE}th): mean "
                f"{float(cand.mean()):.2f} max {int(cand.max())}; "
                f"admissions: mean {float(adm.mean()):.2f} max "
                f"{int(adm.max())}")
    return dict(wall_us=wall_us / n, busy_us=busy_us / n, topk_us=topk_us,
                glue_us={k: v / n for k, v in glue_us.items()},
                wait_queue=wait_queue)


#: The execution phase's series-capture strides: every tick, and hourly at
#: a 10 s tick (the event engine's sampling, ``repro``'s parity test).
SERIES_STRIDES = (1, 360)
#: Its horizon for the replayed series against the eager tick's.
SERIES_EAGER_DAYS = 0.25


def same_outputs(got: dict, want: dict, what: str) -> int:
    """Check every output of ``want`` bitwise in ``got``; returns how many
    were compared."""
    for k in want:
        check(got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                               want[k]),
              f"{what}: {k} not bitwise")
    return len(want)


def same_results(got, want, what: str) -> int:
    """Check a sweep's results spec by spec: every metric and bill equal."""
    check(got.ok and len(got.results) == len(want.results),
          f"{what}: {len(got.results)} results of {len(want.results)}, "
          f"failures {got.failures}")
    for a, b in zip(got.results, want.results):
        check(a.spec == b.spec and a.metrics == b.metrics
              and (a.storage_usd, a.network_usd, a.ops_usd)
              == (b.storage_usd, b.network_usd, b.ops_usd),
              f"{what}: {a.spec.label} differs")
    return len(got.results)


def peak_bytes(torch, fn):
    """``fn()`` and the most device memory allocated while it ran, above
    what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def execution_phase(torch, grid, specs, days: float, n_files: int, captured,
                    swept, card: str) -> None:
    """The execution layer on the card, each run through the normal entry
    points on ``cuda`` and held bitwise to the sweep phase's captured
    ``simulate_packed`` outputs (``captured``) or ``run_sweep_torch``
    results (``swept``): series capture (capture off's outputs and launches
    unchanged, the replayed tick's series bitwise to the eager tick's on a
    shorter horizon, the profiled tick at each stride beside capture off),
    lane chunks (peak device memory below the unchunked run's), chunks
    round-robin over a device list, retryable chunk jobs under injected
    faults (device memory back where it was), and a fleet of two worker
    processes on the card."""
    from repro_torch.core.scenarios import pack_specs
    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.tick_glue import ops as glue_ops
    from repro_torch.obs.metrics import get_registry, split_series_name
    from repro_torch.obs.trace import get_tracer
    from repro_torch.sim.batched import run_sweep_torch, simulate_packed
    from repro_torch.sim.faults import FaultPlan
    from repro_torch.sim.jobs import RetryPolicy

    t_phase = time.perf_counter()
    kernels = ops.KERNELS + glue_ops.KERNELS
    log(f"execution phase ({card}): the sweep grid, {grid.n_lanes} lanes, "
        f"{n_files} files/site, {grid.n_ticks} ticks")

    # -- series capture on the main path
    stride = SERIES_STRIDES[-1]
    ops.reset_launch_counts()
    glue_ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = simulate_packed(grid, tick_impl="cuda", record_series=stride)
    wall = time.perf_counter() - t0
    launched = {**ops.launch_counts(), **glue_ops.launch_counts()}
    check(launched == {k: grid.n_ticks for k in kernels},
          f"series capture: launches {launched}, not one of each kernel a "
          f"tick")
    n = same_outputs(rec, captured, "series capture (off vs on)")
    n_samples = (grid.n_ticks - 1) // stride + 1
    check(rec["ser_disk"].shape == (grid.n_lanes, n_samples, 2)
          and all(np.isfinite(rec[k]).all() for k in rec if k.startswith(
              "ser_")) and rec["ser_run"].max() > 0,
          "series capture: series buffers malformed or empty")
    log(f"exec series (record_series={stride}): {wall:.2f} s wall, "
        f"{grid.n_ticks / wall:.1f} ticks/s; {n} outputs bitwise to capture "
        f"off, launches {launched} (one a tick each, unchanged); "
        f"{n_samples} samples; running jobs max {rec['ser_run'].max():g}, "
        f"waiting files max {rec['ser_queue'].max():g}")
    short = pack_specs(pricing_specs(min(days, SERIES_EAGER_DAYS), n_files),
                       tick=10.0)
    runs = {eager: simulate_packed(short, tick_impl="cuda", _eager=eager,
                                   record_series=stride)
            for eager in (True, False)}
    n = same_outputs(runs[False], runs[True], "series capture (replayed vs "
                                              "eager)")
    log(f"exec series: replayed tick bitwise to the eager tick on "
        f"{short.n_ticks} ticks ({n} outputs, series included)")
    del runs
    base = profile_phase(torch, grid, graph=True)
    for k in SERIES_STRIDES:
        p = profile_phase(torch, grid, graph=True, record_series=k)
        busy = (f"device busy {p['busy_us']:.1f} us/tick against "
                f"{base['busy_us']:.1f} off (+{p['busy_us'] - base['busy_us']:.1f})"
                if p["busy_us"] is not None and base["busy_us"] is not None
                else "device busy not measured")
        log(f"exec series capture cost, stride {k}: wall "
            f"{p['wall_us']:.1f} us/tick against {base['wall_us']:.1f} off "
            f"(+{p['wall_us'] - base['wall_us']:.1f}); {busy}")

    # -- lane chunks, and chunks round-robin over a device list
    whole, whole_peak = peak_bytes(torch, lambda: simulate_packed(
        grid, tick_impl="cuda"))
    same_outputs(whole, captured, "unchunked rerun")
    t0 = time.perf_counter()
    chunked, chunk_peak = peak_bytes(torch, lambda: simulate_packed(
        grid, tick_impl="cuda", lane_chunk=2))
    wall = time.perf_counter() - t0
    n = same_outputs(chunked, captured, "lane_chunk=2")
    log(f"exec lane_chunk=2: {wall:.2f} s wall, {n} outputs bitwise; peak "
        f"device memory allocated {chunk_peak} B chunked against "
        f"{whole_peak} B unchunked ({chunk_peak / whole_peak:.3f})")
    check(chunk_peak < whole_peak, "lane_chunk=2: peak device memory not "
                                   "below the unchunked run's")
    t0 = time.perf_counter()
    rr = simulate_packed(grid, tick_impl="cuda", lane_chunk=2,
                         devices=["cuda:0", "cuda:0"])
    wall = time.perf_counter() - t0
    n = same_outputs(rr, captured, "devices round-robin")
    log(f"exec devices=['cuda:0', 'cuda:0'], lane_chunk=2: {wall:.2f} s "
        f"wall, {n} outputs bitwise")
    del whole, chunked, rr

    # -- retryable chunk jobs under injected faults
    reg = get_registry()
    tracer = get_tracer()
    before = {k: reg.value(f"jobs.{k}") for k in ("retries", "crashes",
                                                 "timeouts")}
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    tracer.reset()
    tracer.enable()
    try:
        t0 = time.perf_counter()
        res = run_sweep_torch(
            specs, tick=10.0, tick_impl="cuda", lane_chunk=2,
            job_timeout=0.5,
            faults=FaultPlan(seed=11, crash=0.3, hang=0.3, transient=0.3,
                             hang_s=1.0, attempts=1),
            retry=RetryPolicy(max_attempts=3, base_delay_s=0.01,
                              max_delay_s=0.05))
        wall = time.perf_counter() - t0
        call = [e["args"] for e in tracer.events
                if e["name"] == "sweep.torch"][-1]
    finally:
        tracer.disable()
        tracer.reset()
    torch.cuda.synchronize()
    alloc1 = torch.cuda.memory_allocated()
    fired = {k: reg.value(f"jobs.{k}") - v for k, v in before.items()}
    n = same_results(res, swept, "faults")
    check(fired["retries"] > 0, "faults: no retry was scheduled")
    log(f"exec faults (crash/hang/transient 0.3 each, job_timeout 0.5 s, "
        f"lane_chunk=2, traced loops): {wall:.2f} s wall, {n} specs "
        f"bitwise to the unchunked sweep; {fired}; {call['chunks']} "
        f"chunks, graph pool {call['pool_bytes']} B; device memory allocated {alloc0} B "
        f"before, {alloc1} B after")
    check(alloc1 - alloc0 < call["pool_bytes"] // 2,
          "faults: device memory held after the sweep")

    # -- the worker fleet: two processes on this card
    reg.reset()
    t0 = time.perf_counter()
    fleet = run_sweep_torch(specs, tick=10.0, tick_impl="cuda",
                            transport="subprocess", workers=2, lane_chunk=2)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    alloc2 = torch.cuda.memory_allocated()
    n = same_results(fleet, swept, "fleet")
    counters = reg.snapshot()["counters"]
    per = {}
    for key, v in counters.items():
        name, labels = split_series_name(key)
        if name in ("worker.jobs", "worker.busy_s"):
            per.setdefault(labels["worker"], {})[name] = v
    log(f"exec fleet (subprocess, 2 workers, lane_chunk=2): {wall:.2f} s "
        f"wall, {n} specs bitwise to the unchunked sweep; "
        + "; ".join(f"worker {w}: {d.get('worker.jobs', 0):g} chunks, "
                    f"{d.get('worker.busy_s', 0.0):.2f} s busy"
                    for w, d in sorted(per.items()))
        + f"; startup s {reg.snapshot()['histograms'].get('workers.startup_s', {}).get('sum')}"
        f"; dispatcher device memory {alloc1} B before, {alloc2} B after")
    check(len(per) == 2 and sum(d.get("worker.jobs", 0)
                                for d in per.values()) == -(-grid.n_lanes
                                                             // 2),
          f"fleet: chunks by worker {per}")
    check(alloc2 <= alloc1, "fleet: the dispatcher's device memory grew")
    log(f"execution phase: {time.perf_counter() - t_phase:.2f} s wall")


#: The decide phase's small grid, run on the kernels and on the plain path:
#: 2 caches x 2 egress options x 2 storage prices (x 2 seeds), at a 60 s
#: tick: the plain tick is host-bound here (61–152 ticks/s on an H100 80GB
#: HBM3 at 700 W, by the host's speed), so the 10 s tick's 2,161 ticks a
#: call cost 166–329 s a decide.
SMALL_DECIDE_AXES = {
    "base": "III", "cache_tb": [5.0, 20.0],
    "egress": ["internet", "direct"], "storage_price": [0.02, 0.026],
    "days": 0.25, "n_files": 20_000,
}
SMALL_DECIDE_TICK = 60.0


def decisions(doc: dict) -> dict:
    """What a decision report decides: the chosen point, the frontier's
    labels, the displaced cache TB and the break-even bracket."""
    b = doc["break_even"]
    return {"chosen": doc["chosen"] and doc["chosen"]["label"],
            "frontier": [p["label"] for p in doc["frontier"]],
            "min_cache_tb": doc["displaced_disk"]["min_cache_tb"],
            "break_even": b and b["bracket"],
            "claim_holds": doc["claim_holds"]}


def points_beyond_bar(a: dict, b: dict) -> list:
    """What of two reports differs beyond the Table-2 bar: the points'
    (baseline, chosen, frontier) jobs and cloud cost, and the displaced
    on-prem TB."""
    def close(x, y, floor=1.0):
        if x is None or y is None:
            return x is y
        return abs(x - y) <= TOL * max(abs(x), abs(y), floor)

    rows = [(a["baseline"], b["baseline"])]
    if a["chosen"] and b["chosen"]:
        rows.append((a["chosen"], b["chosen"]))
    rows += list(zip(a["frontier"], b["frontier"]))
    off = [p["label"] for p, q in rows
           if not (close(p["jobs_mean"], q["jobs_mean"])
                   and close(p["cost_usd_mean"], q["cost_usd_mean"]))]
    if not close(a["displaced_disk"]["displaced_tb"],
                 b["displaced_disk"]["displaced_tb"]):
        off.append("displaced_disk.displaced_tb")
    return off


def run_decide(torch, axes: dict, tick_impl: str, cache, tick: float = 10.0,
               **kw):
    """``decide(axes, SweepDriver(backend="torch", ...))`` on the card
    with the tracer on, so its loops are traced (their times hold the
    trace library's launches); returns the report, the driver, the
    per-call ``sweep.torch`` records and the wall seconds."""
    from repro_torch.obs.trace import get_tracer
    from repro_torch.sim.decide import decide
    from repro_torch.sim.sweep import SweepDriver

    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv = SweepDriver(backend="torch", tick=tick, tick_impl=tick_impl,
                          device="cuda", cache=cache)
        report = decide(axes, drv, **kw)
        wall = time.perf_counter() - t0
        calls = [e["args"] for e in tracer.events
                 if e["name"] == "sweep.torch"]
    finally:
        tracer.disable()
        tracer.reset()
    return report, drv, calls, wall


def log_calls(what: str, calls) -> None:
    for i, c in enumerate(calls):
        log(f"  {what} call {i}: {c['specs']} specs, {c['lanes']} lanes, "
            f"pack {c['pack_s']:.2f} s, capture {c['capture_s']:.3f} s "
            f"(pool {c['pool_bytes']} B), sweep {c['sweep_s']:.2f} s, "
            f"{c['ticks'] / c['sweep_s']:.1f} ticks/s")


def decide_phase(torch, days: float, n_files: int):
    """The §5.3 decision workflow on the card (see the module notes);
    returns each lane-tick and glue kernel's launches in the cold run, and
    the cold report's JSON document."""
    import shutil
    import tempfile

    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.tick_glue import ops as glue_ops
    from repro_torch.kernels.trace_tick import ops as trk

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="decide_cache_", dir=ROOT / "build")
    try:
        axes = pricing_axes(days, n_files)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc0 = torch.cuda.memory_allocated()
        for lib in (ops, glue_ops, trk):
            lib.reset_launch_counts()
        cold, drv, calls, wall = run_decide(torch, axes, "cuda", cache_dir,
                                            max_rounds=2)
        launched = {**ops.launch_counts(), **glue_ops.launch_counts(),
                    **trk.launch_counts()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc1 = torch.cuda.memory_allocated()
        doc = cold.to_json_dict()
        log(f"decide cold (216-config grid, {n_files} files/site, "
            f"{days:g} days, max_rounds=2, cuda): {wall:.2f} s, "
            f"{drv.sweep_calls} sweep calls, {drv.configs_run} configs, "
            f"{drv.lanes_simulated} lanes simulated, launches {launched}")
        log_calls("decide cold", calls)
        check(len(calls) == drv.sweep_calls and calls,
              f"decide cold: {len(calls)} sweep records for "
              f"{drv.sweep_calls} calls")
        check(all(n > 0 for n in launched.values())
              and set(launched) == set(ops.KERNELS + glue_ops.KERNELS
                                       + trk.KERNELS),
              f"decide cold: a kernel was not launched ({launched})")
        log(f"decide cold: claim_holds {doc['claim_holds']}, "
            f"refine.lane_fraction {doc['refine']['lane_fraction']:.4f}, "
            f"displaced_disk.displaced_tb "
            f"{doc['displaced_disk']['displaced_tb']}, chosen "
            f"{doc['chosen'] and doc['chosen']['label']}, break-even "
            f"{doc['break_even'] and doc['break_even']['bracket']}")
        log(f"decide cold: device memory allocated {alloc0} B before, "
            f"{alloc1} B after (each sweep call's graph pool released)")
        check(alloc1 - alloc0 < max(c["pool_bytes"] for c in calls) // 2
              + (64 << 20), "decide cold: device memory held after the "
                            "workflow")
        for k in ("baseline", "chosen", "frontier"):
            rows = doc[k] if k == "frontier" else [doc[k]]
            check(all(r is None or all(
                v == v and abs(v) != float("inf")
                for v in r.values() if isinstance(v, float)) for r in rows),
                f"decide cold: non-finite number in {k}")

        warm, wdrv, wcalls, wwall = run_decide(torch, axes, "cuda",
                                               cache_dir, max_rounds=2)
        wdoc = warm.to_json_dict()
        log(f"decide warm (fresh driver, same cache): {wwall:.2f} s, "
            f"{wdrv.lanes_simulated} lanes simulated, {wdrv.configs_run} "
            f"configs run, {wdrv.cache_hits} cache hits, cache "
            f"{wdrv.cache.stats.as_dict()}")
        check(wdrv.lanes_simulated == 0 and not wcalls
              and wdrv.configs_run == 0, "decide warm: lanes simulated")
        check(wdrv.cache.stats.corrupt == 0, "decide warm: corrupt entries")
        cold_rest = {k: v for k, v in doc.items() if k != "stats"}
        warm_rest = {k: v for k, v in wdoc.items() if k != "stats"}
        check(json.dumps(cold_rest, sort_keys=True)
              == json.dumps(warm_rest, sort_keys=True),
              "decide warm: report differs from the cold run's")
        log("decide warm: report equal to the cold run's outside stats")

        small = {}
        for impl in ("cuda", "torch"):
            # one cache directory: the two engines' keys differ, so
            # neither run is served the other's entries
            rep, sdrv, scalls, swall = run_decide(
                torch, SMALL_DECIDE_AXES, impl, cache_dir,
                tick=SMALL_DECIDE_TICK, max_rounds=2)
            small[impl] = rep
            log(f"decide small ({impl}): {swall:.2f} s, "
                f"{sdrv.sweep_calls} sweep calls, {sdrv.lanes_simulated} "
                f"lanes simulated, cache {sdrv.cache.stats.as_dict()}")
            log_calls(f"decide small {impl}", scalls)
        a, b = (small[i].to_json_dict() for i in ("cuda", "torch"))
        off = points_beyond_bar(a, b)
        if decisions(a) != decisions(b) or off:
            for impl, rep in small.items():
                log(f"--- decide small report ({impl}) ---")
                log(rep.to_markdown())
        check(decisions(a) == decisions(b),
              f"decide small: cuda and plain decisions differ: "
              f"{decisions(a)} vs {decisions(b)}")
        check(not off, f"decide small: points beyond the Table-2 bar: {off}")
        log(f"decide small: cuda and plain decisions equal "
            f"{decisions(a)}; every point within the Table-2 bar")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    log(f"decide phase: {time.perf_counter() - t_phase:.2f} s wall")
    return launched, doc


#: The CLI phase's ``run_sweep --backend process`` specs: Table 5's three
#: configurations with their Fig. 6/8 curves at the sweep's catalogue and
#: horizon, and III over twice the horizon. None of them packs into the
#: batched program (``curves``, and two horizons in one grid).
def process_spec_doc(days: float, n_files: int) -> dict:
    return {"n_files": n_files,
            "scenarios": [{"base": b, "days": days, "curves": True}
                          for b in ("I", "II", "III")]
            + [{"base": "III", "days": 2 * days}]}


def run_cli(module: str, args, what: str, card: str):
    """``python -m repro_torch.cli.<module> args`` in a subprocess from
    this checkout; returns its exit code, wall seconds and stderr. Its
    output goes to files (a piped stream that fills would block it)."""
    import os
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-m", f"repro_torch.cli.{module}",
                             *map(str, args)], cwd=ROOT, env=env, stdout=out,
                            stderr=err, timeout=600).returncode
        wall = time.perf_counter() - t0
        err.seek(0)
        text = err.read().decode(errors="replace")
    log(f"cli {what}: exit {rc}, {wall:.2f} s wall [{card}]")
    if rc != 0:
        log(text[-6000:])
    return rc, wall, text


def smi_memory_used() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def cli_phase(torch, days: float, n_files: int, card: str,
              decided: dict) -> None:
    """The CLIs on the card, as a user runs them (see the module notes):
    ``decide --cross-check`` cold and warm on the pricing grid, decisions
    equal to the in-process decide phase's; ``run_sweep --backend
    process`` on specs the batched program refuses, bitwise equal to the
    same specs on a 2-worker fleet of the ``"scenario"`` kind."""
    import re
    import shutil
    import tempfile

    from repro_torch.core.scenarios import specs_from_mapping
    from repro_torch.sim.sweep import run_sweep

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    alloc0, smi0 = torch.cuda.memory_allocated(), smi_memory_used()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cli_phase_", dir=ROOT / "build"))
    try:
        cache = work / "cache"
        docs = {}
        for run in ("cold", "warm"):
            out = work / f"decide_{run}.json"
            rc, wall, err = run_cli(
                "decide", ["--tick-impl", "cuda", "--tick", 10.0,
                           "--days", days, "--files", n_files,
                           "--max-rounds", 2, "--cache-dir", cache,
                           "--cross-check", "--json", out, "--quiet"],
                f"decide {run} (216-config grid, {n_files} files/site, "
                f"{days:g} days, --cross-check)", card)
            check(rc == 0, f"cli decide {run}: exit {rc}")
            doc = docs[run] = json.loads(out.read_text())
            m = re.search(r"cross-check: (\d+) configs on backend=process "
                          r"in ([0-9.]+) s", err)
            check(m is not None, f"cli decide {run}: no cross-check line")
            log(f"cli decide {run}: {doc['stats']['lanes_simulated']} lanes "
                f"simulated, {doc['stats']['configs_run']} configs run; "
                f"cross-check {m.group(1)} configs on the event engine in "
                f"{m.group(2)} s [{card}]")
            check(decisions(doc) == decisions(decided)
                  and doc["displaced_disk"]["displaced_tb"]
                  == decided["displaced_disk"]["displaced_tb"],
                  f"cli decide {run}: decision {decisions(doc)} "
                  f"(displaced {doc['displaced_disk']['displaced_tb']} TB) "
                  f"differs from the in-process decide()'s "
                  f"{decisions(decided)}")
        check(docs["warm"]["stats"]["lanes_simulated"] == 0
              and docs["warm"]["stats"]["configs_run"] == 0,
              "cli decide warm: lanes simulated")
        log(f"cli decide: cold and warm decisions equal the in-process "
            f"decide()'s: claim_holds {decided['claim_holds']}, displaced "
            f"{decided['displaced_disk']['displaced_tb']} TB, break-even "
            f"{decided['break_even'] and decided['break_even']['bracket']}")

        spec_doc = process_spec_doc(days, n_files)
        spec_path = work / "process_specs.json"
        spec_path.write_text(json.dumps(spec_doc))
        out = work / "process.json"
        rc, wall, _ = run_cli(
            "run_sweep", ["--backend", "process", "--spec", spec_path,
                          "--workers", 3, "--json", out, "--quiet"],
            "run_sweep --backend process (I, II, III with curves, III at "
            f"{2 * days:g} days; {n_files} files/site, 3 workers)", card)
        check(rc == 0, f"cli run_sweep --backend process: exit {rc}")
        got = json.loads(out.read_text())
        for row in got["rows"]:
            log(f"  event engine {row['label']}, {row['days']:g} days: "
                f"{row['events']} events in {row['wall_s']:.3f} s, "
                f"{row['events'] / row['wall_s']:.0f} events/s on the host, "
                f"jobs {row['jobs_done']}, cost {row['cost_usd']:.2f} USD "
                f"[{card}]")
        check(len(got["series"]) == 3,
              f"cli run_sweep: {len(got['series'])} curve sets, not 3")
        specs = specs_from_mapping(spec_doc)
        t0 = time.perf_counter()
        fleet = run_sweep(specs, backend="process", transport="subprocess",
                          workers=2)
        log(f"fleet (scenario kind, 2 subprocess workers): "
            f"{time.perf_counter() - t0:.2f} s wall [{card}]")
        check(fleet.ok and len(fleet) == len(specs), "fleet: jobs lost")
        fleet.to_json(str(work / "fleet.json"))
        want = json.loads((work / "fleet.json").read_text())

        def bits(doc):
            return ([{k: v for k, v in r.items() if k != "wall_s"}
                     for r in doc["rows"]], doc["series"], doc["pareto"])

        check(bits(got) == bits(want),
              "fleet: scenario results not bitwise the CLI's")
        log("fleet: every row (metrics, bill, events) and curve digest "
            "bitwise the CLI's process backend")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    log(f"cli phase: device memory allocated {alloc0} B before, "
        f"{torch.cuda.memory_allocated()} B after; nvidia-smi memory.used "
        f"{smi0} before, {smi_memory_used()} after [{card}]")
    log(f"cli phase: {time.perf_counter() - t_phase:.2f} s wall [{card}]")


#: The examples phase's crash soak at the card's size: the sweep's
#: catalogue, 12 configs (6 cache sizes x 2 seeds: 12 dynamics lanes in 6
#: journaled chunks of 2), the soak's own horizon; the kill lands this far
#: into the sweep of an uninterrupted run of the same command, after its
#: start-up (its own ``done in`` line against its wall time).
SOAK_FILES, SOAK_DAYS, SOAK_KILL_AT = 1_000_000, 2.0, 0.5
#: The store statistics the train example prints.
TRAIN_STORE_KEYS = ("archival_reads", "cold_hits", "hot_hits",
                    "migrated_bytes", "cold_egress_usd",
                    "straggler_refetches")


def load_entry(relpath: str):
    """``ROOT / relpath`` (an example or script of the port) as a module,
    whose ``main`` the phase calls in this process."""
    import importlib.util

    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(f"entry_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quietly(fn, *args):
    """``fn(*args)`` with its standard output kept, not printed; returns
    the result and the text."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _count_modules():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lane_tick import ops as lt_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.tick_glue import ops as glue_ops

    return lt_ops, glue_ops, fa_ops, ms_ops


def reset_counts() -> None:
    for mod in _count_modules():
        mod.reset_launch_counts()


def read_counts() -> dict:
    """Every launch counted since :func:`reset_counts` on the lane-tick,
    glue, attention (by variant) and scan kernels, by name."""
    counts = {}
    for mod in _count_modules():
        counts.update(mod.launch_counts())
    return counts


def counted_run(torch, fn, *args):
    """``fn(*args)`` quietly on the card with the counts set to 0 just
    before and read just after; returns the result, its printed text, the
    wall seconds and the launches that are not 0."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out, text = quietly(fn, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, text, wall, {k: v for k, v in read_counts().items() if v}


def example_sweep_decision(torch, card: str, launches: dict) -> float:
    """``sweep_decision_torch.main`` at its defaults on the kernels and on
    the plain tick: equal decisions, every point within the Table-2 bar.
    Returns the seconds."""
    from repro_torch.kernels.lane_tick import ops
    from repro_torch.kernels.tick_glue import ops as glue_ops

    ex = load_entry("examples/sweep_decision_torch.py")
    t_part = time.perf_counter()
    runs, texts = {}, {}
    for impl in ("cuda", "torch"):
        got, texts[impl], wall, n = counted_run(torch, ex.main,
                                                ["--tick-impl", impl])
        runs[impl] = got["report"]
        launches[f"sweep_decision {impl}"] = n
        st = got["report"]["stats"]
        log(f"examples sweep_decision --tick-impl {impl}: {wall:.2f} s wall, "
            f"{st['sweep_calls']} sweep calls, {st['configs_run']} configs, "
            f"{st['lanes_simulated']} lanes simulated; {got['decision']} "
            f"[{card}]")
    tick_kernels = ops.KERNELS + glue_ops.KERNELS
    check(all(launches["sweep_decision cuda"].get(k, 0) > 0
              for k in tick_kernels),
          f"examples sweep_decision cuda: a kernel was not launched "
          f"({launches['sweep_decision cuda']})")
    check(not launches["sweep_decision torch"],
          "examples sweep_decision torch: a kernel was launched")
    a, b = runs["cuda"], runs["torch"]
    off = points_beyond_bar(a, b)
    if decisions(a) != decisions(b) or off:
        for impl, text in texts.items():
            log(f"--- sweep_decision report ({impl}) ---\n{text}")
    check(decisions(a) == decisions(b),
          f"examples sweep_decision: cuda and plain decisions differ: "
          f"{decisions(a)} vs {decisions(b)}")
    check(not off, f"examples sweep_decision: points beyond the Table-2 "
                   f"bar: {off}")
    same = ({k: v for k, v in a.items() if k != "stats"}
            == {k: v for k, v in b.items() if k != "stats"})
    log(f"examples sweep_decision: cuda and torch decisions equal "
        f"{decisions(a)}, every point within the Table-2 bar; the reports "
        f"outside their stats {'identical' if same else 'not identical'}")
    return time.perf_counter() - t_part


def serve_token_gap(torch, ex, cfg, params, prompts, got: dict,
                    want: dict) -> str:
    """Where two runs' tokens first differ (request, step) and each
    route's top-2 logit gap there, from a rerun of both routes with the
    loop's steps recording their logits."""
    from repro_torch.serve.engine import Request, ServeLoop

    rid, step = next((r, s) for r in sorted(got)
                     for s in range(len(got[r])) if got[r][s] != want[r][s])
    gaps = {}
    for impl in ("cuda", "torch"):
        loop = ServeLoop(cfg, params, batch_slots=ex.BATCH_SLOTS,
                         max_len=ex.MAX_LEN, impl=impl)
        steps = []

        def record(fn, i):
            def call(*args):
                out = fn(*args)
                steps.append(out[i].float())
                return out
            return call

        loop.prefill = record(loop.prefill, 0)
        loop.decode = record(loop.decode, 1)
        max_new = len(got[rid])
        loop.run([Request(rid=i, prompt=p, max_new=max_new)
                  for i, p in enumerate(prompts)])
        row = steps[(rid // ex.BATCH_SLOTS) * max_new + step][
            rid % ex.BATCH_SLOTS]
        top = row.topk(2).values
        gaps[impl] = float(top[0] - top[1])
    return (f"request {rid} step {step}: top-2 logit gap {gaps['cuda']:.3e} "
            f"(kernels), {gaps['torch']:.3e} (plain)")


def example_serve_small(torch, card: str, launches: dict) -> float:
    """``serve_small_torch.main`` at its bf16 defaults on the kernels;
    ``run`` in float32 on the kernels and on the plain route, tokens
    equal. Returns the seconds."""
    from repro_torch.configs import canonical, get_smoke_config
    from repro_torch.models import init_params

    ex = load_entry("examples/serve_small_torch.py")
    t_part = time.perf_counter()
    got, text, wall, n = counted_run(torch, ex.main, [])
    launches["serve_small bf16"] = n
    toks = got["tokens"]
    log(f"examples serve_small (bf16 defaults, kernel route): {wall:.2f} s "
        f"wall; {text.strip().splitlines()[-1]} [{card}]")
    check(sorted(toks) == list(range(6))
          and all(len(v) == 8 for v in toks.values()),
          f"examples serve_small: not 6 requests of 8 tokens ({toks})")
    check(n.get("flash_attention_wgmma", 0) > 0
          and n.get("selective_scan", 0) > 0,
          f"examples serve_small bf16: attention or scan not launched ({n})")

    cfg = get_smoke_config(canonical("hymba_1_5b")).replace(
        dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompts = [torch.randint(0, cfg.vocab_size, (ex.PROMPT_LEN,),
                             generator=torch.Generator().manual_seed(100 + i))
               for i in range(6)]
    outs = {}
    for impl in ("cuda", "torch"):
        (outs[impl], secs), _, wall, n = counted_run(
            torch, ex.run, cfg, params, prompts, 8, impl)
        launches[f"serve_small float32 {impl}"] = n
        log(f"examples serve_small run float32 impl={impl}: {wall:.2f} s "
            f"wall, {48 / secs:.1f} tok/s [{card}]")
    n_cu, n_pl = (launches[f"serve_small float32 {i}"]
                  for i in ("cuda", "torch"))
    check(n_cu.get("flash_attention_tf32x3", 0) > 0
          and n_cu.get("selective_scan", 0) > 0,
          f"examples serve_small float32: kernels not launched ({n_cu})")
    check(not n_pl, f"examples serve_small float32 plain: a kernel was "
                    f"launched ({n_pl})")
    if outs["cuda"] != outs["torch"]:
        log(f"examples serve_small float32: tokens differ at "
            + serve_token_gap(torch, ex, cfg, params, prompts, outs["cuda"],
                              outs["torch"]))
    check(outs["cuda"] == outs["torch"],
          "examples serve_small float32: kernel and plain tokens differ")
    log("examples serve_small float32: all 48 tokens equal on the kernel "
        "and plain routes")
    return time.perf_counter() - t_part


def example_train(torch, card: str, launches: dict, work: Path) -> float:
    """``train_with_hcdc_pipeline_torch.main`` at its 200 steps on the
    kernels (losses finite and falling, the store statistics), then 3
    steps on each route, losses within ``TRAIN_BARS``. Returns the
    seconds."""
    import math

    from repro_torch.configs import get_smoke_config

    ex = load_entry("examples/train_with_hcdc_pipeline_torch.py")
    t_part = time.perf_counter()
    out, text, wall, n = counted_run(torch, ex.main,
                                     ["--ckpt-dir", str(work / "ckpt")])
    launches["train 200 steps"] = n
    losses = out["losses"]
    lines = text.strip().splitlines()
    log(f"examples train (qwen3_4b smoke, 200 steps of 8 x 64 tokens, "
        f"kernel route): {wall:.2f} s wall, {1e3 * wall / len(losses):.1f} "
        f"ms a step; {lines[-3]} | {lines[-2]} | {lines[-1]} [{card}]")
    check(len(losses) == 200 and all(math.isfinite(v) for v in losses),
          "examples train: a loss is not finite")
    check(losses[-1] < losses[0],
          f"examples train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(set(TRAIN_STORE_KEYS) <= set(out["store_stats"]),
          f"examples train: store statistics {sorted(out['store_stats'])}")
    check(n.get("flash_attention", 0) > 0,
          f"examples train: attention not launched ({n})")

    arch = "qwen3_4b"
    dtype = str(get_smoke_config(arch).dtype).split(".")[-1]
    three = {}
    for impl in ("cuda", "torch"):
        three[impl], _, wall, n = counted_run(
            torch, ex.run, arch, 3, str(work / f"ckpt_{impl}"), None, impl)
        launches[f"train 3 steps {impl}"] = n
        log(f"examples train 3 steps impl={impl}: {wall:.2f} s wall, losses "
            f"{three[impl]['losses']} [{card}]")
    check(launches["train 3 steps cuda"].get("flash_attention", 0) > 0,
          "examples train 3 steps: attention not launched")
    check(not launches["train 3 steps torch"],
          "examples train 3 steps plain: a kernel was launched")
    bar = TRAIN_BARS[dtype][0]
    gaps = [abs(a - b) / abs(b) for a, b in zip(three["cuda"]["losses"],
                                                three["torch"]["losses"])]
    log(f"examples train 3 steps: loss relative differences {gaps} "
        f"({dtype}, bar {bar:g})")
    check(max(gaps) <= bar, f"examples train: kernel and plain losses "
                            f"beyond {bar:g} ({gaps})")
    return time.perf_counter() - t_part


def example_crash_soak(torch, card: str, work: Path) -> float:
    """``scripts/crash_soak_torch.py`` at ``SOAK_FILES`` files a site on
    the kernels, the kill timed from an uninterrupted run of the same
    command, whose rows the resumed run's must equal bitwise. Returns the
    seconds."""
    import os
    import re
    import signal

    soak = load_entry("scripts/crash_soak_torch.py")
    t_part = time.perf_counter()
    flags = ["--files", str(SOAK_FILES), "--days", str(SOAK_DAYS),
             "--tick-impl", "cuda"]
    args = soak.build_parser().parse_args(flags)
    n_expected = len(args.cache_tb.split(",")) * args.seeds
    full_json = work / "soak_full.json"
    cmd = soak._sweep_cmd(args, str(work / "soak_cache"), str(full_json), [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=soak._env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    full_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
    check(proc.returncode == 0, f"examples crash soak: the uninterrupted "
                                f"run exited {proc.returncode}")
    sweep_s = float(re.search(r"done in ([0-9.]+)s", proc.stderr).group(1))
    kill_after = round(full_wall - sweep_s + SOAK_KILL_AT * sweep_s, 1)
    log(f"examples crash soak: uninterrupted run ({n_expected} configs, "
        f"{SOAK_FILES} files/site, {SOAK_DAYS:g} days, tick 60 s, lane "
        f"chunks of 2, cuda) {full_wall:.2f} s wall, its sweep {sweep_s} s; "
        f"kill after {kill_after} s [{card}]")

    env = dict(os.environ, TMPDIR=str(work))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "crash_soak_torch.py"),
         *flags, "--kill-after", str(kill_after), "--keep"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    soak_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
    check(proc.returncode == 0,
          f"examples crash soak: the soak exited {proc.returncode}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"examples crash soak: {soak_wall:.2f} s wall; victim exit "
        f"{got['victim_rc']}; resume {got['resume_wall_s']:.2f} s, "
        f"{got['resume_rows']}/{n_expected} configs, {got['cache_hits']} "
        f"from the journal ({got['cache_hits'] / n_expected:.3f}), "
        f"{got['lanes_simulated']} lanes simulated; fault soak "
        f"{got['fault_wall_s']:.2f} s, exit {got['fault_rc']}, "
        f"{got['fault_rows']} configs [{card}]")
    check(got["victim_rc"] == -signal.SIGKILL,
          f"examples crash soak: the first run did not die from SIGKILL "
          f"(exit {got['victim_rc']})")
    check(got["resume_rows"] == n_expected and got["cache_hits"] >= 1
          and got["lanes_simulated"] >= 1,
          "examples crash soak: the kill did not land mid-run (no chunk "
          "journaled, or none left)")

    def bits(doc):
        return [{k: v for k, v in r.items() if k != "wall_s"}
                for r in doc["rows"]]

    resumed = json.loads(Path(got["resume_json"]).read_text())
    full = json.loads(full_json.read_text())
    check(not resumed.get("failures") and bits(resumed) == bits(full),
          "examples crash soak: the resumed rows are not bitwise the "
          "uninterrupted run's")
    check(got["fault_rc"] == 0 and got["fault_rows"] == n_expected,
          "examples crash soak: the fault soak lost configs")
    log(f"examples crash soak: resumed rows bitwise the uninterrupted "
        f"run's ({n_expected} rows, wall_s aside); fault soak complete")
    return time.perf_counter() - t_part


def examples_phase(torch, card: str) -> None:
    """The port's examples and its crash soak on the card (see the module
    notes), each kernel run's launches on one line."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="examples_phase_", dir=ROOT / "build"))
    launches: dict = {}
    try:
        secs = {"sweep_decision": example_sweep_decision(torch, card,
                                                         launches),
                "serve_small": example_serve_small(torch, card, launches),
                "train": example_train(torch, card, launches, work),
                "crash_soak": example_crash_soak(torch, card, work)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"examples launches: {json.dumps(launches, sort_keys=True)}")
    log(f"examples phase: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + f"; whole phase {time.perf_counter() - t_phase:.1f} s [{card}]")


def carousel_inputs(torch, gen, n: int, m: int):
    """``n`` transfers on ``m`` links, every one in flight, half the links
    shared and half per-transfer: a transfer's own rate is 10 kB/s to
    1 MB/s (log-uniform), so that completions spread over the ticks, and a
    shared link carries as much per transfer while it is full."""
    dev = torch.device("cuda")
    link_id = torch.randint(0, m, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    total = 1e6 + 1e9 * torch.rand(n, generator=gen, device=dev)
    done = total * torch.rand(n, generator=gen, device=dev)
    mode = (torch.arange(m, device=dev) % 2).to(torch.int32)
    bw = 10.0 ** (4.0 + 2.0 * torch.rand(m, generator=gen, device=dev))
    bw = torch.where(mode == 0, bw * (n / m), bw)
    return link_id, active, done, total, bw, mode


def engine_bound(torch, n_active0: int, n: int, m: int, completions):
    """Least time of the engine's ticks at this run's data, per tick:
    each tick reads every active flag, the link id, done and total of the
    active transfers, writes their done and the flags of the completed
    ones (the rates per link: bw, mode and count, 12 B a link); about five
    float operations an active transfer. Returns (ms per tick,
    bound_by)."""
    c = completions.to(torch.int64)
    active = n_active0 - torch.cumsum(c, 0) + c  # at the start of each tick
    n_ticks = int(c.numel())
    nb = (n * n_ticks + 16 * int(active.sum()) + int(c.sum())
          + 12 * m * n_ticks)
    ms, kind = bound_ms(nb, 5 * int(active.sum()))
    return ms / max(n_ticks, 1), kind


def engine_steady(torch, ops, args, dt: float, n_ticks: int,
                  want=None) -> dict:
    """A tick engine (``ops.CarouselEngine``, chunks of
    ``ops.ENGINE_CHUNK`` ticks) over ``n_ticks`` ticks of ``args``,
    measured in its steady state: after its warm-up and capture, a window
    of whole chunks, at least 100 ticks, on the host clock, the next
    window under ``torch.profiler`` (device time per tick, the idle share
    of the unprofiled wall), then the replays that remain timed with CUDA
    events and the host clock; the engine's final state is held bitwise
    to ``want`` (a plain engine's ``(active, done, completions)``) when
    given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = ops.CarouselEngine(*args, dt, n_ticks)
    chunk = engine.chunk
    window = -(-100 // chunk) * chunk
    lead = ops.ENGINE_WARMUP_TICKS + chunk
    engine.advance(lead)  # warm-up, capture and the first replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.advance(window)
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0) / window
    n_active = int(engine.active.sum())  # at the profiled window's start
    t_win = engine.t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.advance(window)
        torch.cuda.synchronize()
    win_bound = engine_bound(torch, n_active, engine.active.numel(),
                             engine.bw.numel(),
                             engine.completions[t_win:engine.t])[0]
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows) / window
    tick_us = sum(e.self_device_time_total for e in rows
                  if "engine_tick" in e.key) / window
    n_rep = (n_ticks - lead - 2 * window) // chunk * chunk
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    engine.advance(n_rep)
    stop.record()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    engine.advance(n_ticks - engine.t)
    if want is not None:
        got = (engine.active, engine.done, engine.completions)
        for g, w, name in zip(got, want, ("active", "done", "completions")):
            check(torch.equal(g, w), f"engine (chunk {chunk}): {name} not "
                                     f"bitwise to the plain engine")
    return dict(chunk=chunk, window=window, wall_us=wall_us,
                busy_us=busy_us, tick_us=tick_us,
                idle=1 - busy_us / wall_us, n_rep=n_rep,
                active_share=n_active / engine.active.numel(),
                window_bound_us=1e3 * win_bound,
                ticks_per_s=n_rep / steady_s,
                ms=start.elapsed_time(stop) / n_rep,
                capture_ms=1e3 * engine.capture_s,
                kernels=len(rows))


def carousel_phase(torch, n: int = 1_000_000, n_ticks: int = 1000):
    """The carousel's two paths. The one-tick ``carousel_tick`` over ``n``
    transfers, every file of one site's catalogue in flight, on 6 links
    (Config III's 2 sites x 3 link types) and on 512 (the Pallas design's
    ceiling), half of them shared and half per-transfer, dt = 10 s: bars
    ``new_done``/``completed`` bitwise and counts exact against the plain
    version. The tick engine ``simulate_ticks`` for ``n_ticks`` ticks on
    6 links (``ops.CarouselEngine``: one count, then one kernel launch a
    tick, replayed from CUDA graphs): its final state bitwise and its
    per-tick completions equal to the plain engine's, and a second engine
    over the same ticks measured in its steady state
    (:func:`engine_steady`). Each path runs with the launch counts reset
    just before and read just after. Returns one (kernel, case, launches,
    result) per case."""
    from repro_torch.kernels.carousel_update import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4101)
    cases = {m: carousel_inputs(torch, gen, n, m) for m in (6, 512)}
    dt = 10.0
    none = dict.fromkeys(ops.KERNELS, 0)
    got, launches = {}, {}
    for m, a in cases.items():
        ops.reset_launch_counts()
        got[m] = ops.carousel_tick(*a, dt)
        launches[m] = ops.launch_counts()
        check(launches[m] == {**none, "carousel_tick": 1},
              f"carousel_tick M={m}: launches {launches[m]}")

    # the engine's path, as a caller runs it
    args = cases[6]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sim_k = ops.simulate_ticks(*args, dt, n_ticks, tick_impl="cuda",
                               device=dev)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    eng_launches = ops.launch_counts()
    check(eng_launches == {**none, "engine_count": 1,
                           "engine_tick": n_ticks},
          f"simulate_ticks: launches {eng_launches} in {n_ticks} ticks")
    t0 = time.perf_counter()
    again = ops.simulate_ticks(*args, dt, n_ticks, tick_impl="cuda",
                               device=dev)
    torch.cuda.synchronize()
    wall_k2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_p = ops.simulate_ticks(*args, dt, n_ticks, tick_impl="torch",
                               device=dev)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    check(torch.equal(sim_k[0], sim_p[0]), "simulate_ticks: active differs")
    check(torch.equal(sim_k[1], sim_p[1]), "simulate_ticks: done differs")
    check(torch.equal(sim_k[2], sim_p[2]),
          "simulate_ticks: completions differ")
    check(all(torch.equal(x, y) for x, y in zip(again, sim_k)),
          "simulate_ticks: two calls differ")
    n_done = int(sim_k[2].sum())
    check(0 < n_done < n, f"simulate_ticks: {n_done} completions")
    log(f"carousel simulate_ticks: {n_ticks} ticks of {n} transfers on 6 "
        f"links, final state bitwise, {n_done} completions equal per tick; "
        f"engine {n_ticks / wall_k:.1f} ticks/s (the whole call: count, "
        f"warm-up, capture, replays; the engine's first call in this "
        f"process), {n_ticks / wall_k2:.1f} ticks/s a second call, plain "
        f"{n_ticks / wall_p:.1f} ticks/s; "
        f"launches {eng_launches} (replays counted): "
        f"{eng_launches['engine_tick'] / n_ticks:.3f} a tick after the "
        f"count")
    st = engine_steady(torch, ops, args, dt, n_ticks, want=sim_p)
    tick_bound, tick_kind = engine_bound(torch, n, n, 6, sim_p[2])
    log(f"carousel engine steady state (chunk {st['chunk']}): {st['n_rep']} "
        f"replayed ticks at {st['ticks_per_s']:.1f} ticks/s without the "
        f"capture ({st['ms']:.5f} ms a tick by events); capture "
        f"{st['capture_ms']:.2f} ms once; over {st['window']} ticks: wall "
        f"{st['wall_us']:.2f} us/tick unprofiled, device busy "
        f"{st['busy_us']:.2f} us/tick ({st['tick_us']:.2f} in the engine "
        f"kernel, {st['kernels']} device kernels by name), idle share "
        f"{st['idle']:.3f}, active share {st['active_share']:.4f} at its "
        f"start, bound {st['window_bound_us']:.2f} us/tick over it; bound "
        f"over all {n_ticks} ticks {1e3 * tick_bound:.2f} us/tick "
        f"({tick_kind}, this run's active transfers)")

    # plain versions of the engine's two kernels, on the same inputs
    link, act0 = args[0], args[1]
    cnt = torch.empty(6, dtype=torch.int32, device=dev)
    ops.engine_count(link, act0, cnt)
    plain_cnt = torch.bincount(link[act0].long(), minlength=6)
    check(torch.equal(cnt, plain_cnt.to(torch.int32)),
          "engine_count: counts differ from bincount")
    pa = [args[1].clone(), args[2].clone()]
    pc = torch.zeros((2, 6), dtype=torch.int32, device=dev)
    pc[1] = cnt
    ph = torch.zeros((3, 6), dtype=torch.int32, device=dev)
    pcomp = torch.zeros(n_ticks, dtype=torch.int32, device=dev)
    pt = [0]

    def plain_tick():
        ref.engine_tick(link, pa[0], pa[1], args[3], args[4], args[5], dt,
                        pt[0], pc, ph, pcomp)
        pt[0] += 1

    cnt_bound = bound_ms(n + 4 * int(act0.sum()) + 4 * 6, n)
    per_case = []
    for m, a in cases.items():
        want = ref.carousel_tick(*a, dt)
        torch.cuda.synchronize()
        for g, w, name in zip(got[m], want, ("new_done", "completed",
                                             "counts")):
            check(torch.equal(g, w), f"carousel_tick M={m}: {name} not "
                                     f"bitwise")
        n_comp = int(got[m][1].sum())
        check(0 < n_comp < n, f"carousel_tick M={m}: {n_comp} completions")
        # needed: link id, active, done and total in, new_done and the
        # completion flag out (18 B a transfer); bw, mode and counts per link
        nb, kind = bound_ms(18 * n + 12 * m, 5 * n)
        r = dict(max_abs_err=float((got[m][0] - want[0]).abs().max()),
                 ms=time_ms(torch, lambda: ops.carousel_tick(
                     *a, dt, tick_impl="cuda")),
                 plain_ms=time_ms(torch, lambda: ref.carousel_tick(*a, dt)),
                 bound_ms=nb, bound_by=kind, library_ms=None)
        dev_us = device_us(torch, lambda: ops.carousel_tick(
            *a, dt, tick_impl="cuda"))
        r["device_us"] = dev_us
        per_case.append(("carousel_tick", f"N=1M M={m}",
                         launches[m]["carousel_tick"], r))
        log(f"carousel_tick M={m}: new_done/completed bitwise, counts exact, "
            f"{n_comp} completions; ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {nb:.4f} ({kind}); device time "
            f"{dev_us:.1f} us per call (profiler: memset and both kernels)")
    r = dict(max_abs_err=float((sim_k[1] - sim_p[1]).abs().max()),
             ms=st["ms"], plain_ms=time_ms(torch, plain_tick),
             bound_ms=tick_bound, bound_by=tick_kind, library_ms=None,
             device_us=st["tick_us"], wall_us=st["wall_us"],
             idle_share=st["idle"], ticks_per_s=st["ticks_per_s"],
             ticks_per_s_with_capture=n_ticks / wall_k,
             ticks_per_s_second_call=n_ticks / wall_k2,
             capture_ms=st["capture_ms"], chunk=st["chunk"])
    per_case.append(("engine_tick", f"N=1M M=6, simulate_ticks {n_ticks} "
                     f"ticks, ms per tick", eng_launches["engine_tick"], r))
    r = dict(max_abs_err=0.0,
             ms=time_ms(torch, lambda: ops.engine_count(link, act0, cnt)),
             plain_ms=time_ms(torch, lambda: torch.bincount(
                 link[act0].long(), minlength=6)),
             bound_ms=cnt_bound[0], bound_by=cnt_bound[1], library_ms=None,
             device_us=device_us(torch, lambda: ops.engine_count(
                 link, act0, cnt)))
    per_case.append(("engine_count", f"N=1M M=6, simulate_ticks' first "
                     f"tick", eng_launches["engine_count"], r))
    log(f"carousel engine_tick: ms {per_case[-2][3]['ms']:.5f} a tick, "
        f"plain_ms {per_case[-2][3]['plain_ms']:.4f} (ref.engine_tick); "
        f"engine_count: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
        f"bound_ms {r['bound_ms']:.4f}, device {r['device_us']:.1f} us, "
        f"counts equal to bincount")
    return per_case


#: Attention cases: (label, B, nh, nkv, hd, T = S, dtype, causal, window).
#: Published widths, and hd 168: what ``repro``'s gemma3_27b config derives
#: (5376/32; the published head_dim is 128), kept as a width that is not a
#: power of two, with two query heads per kv head; hd 100 in bf16, a width
#: that is not a multiple of 8, goes through the wgmma kernel's thread
#: loader (8-byte ``cp.async``; TMA needs rows of a multiple of 16 bytes).
ATTENTION_CASES = (
    ("qwen3_4b", 1, 32, 8, 128, 4096, "bfloat16", True, 0),
    ("gemma3_27b local", 1, 32, 16, 128, 4096, "bfloat16", True, 1024),
    ("hd168 bf16", 1, 32, 16, 168, 4096, "bfloat16", True, 1024),
    ("hd168 f32", 1, 32, 16, 168, 2048, "float32", True, 1024),
    ("hymba_1_5b f32", 1, 25, 5, 64, 2048, "float32", True, 1024),
    ("hd100 bf16", 1, 32, 16, 100, 2048, "bfloat16", True, 1024),
)

#: (atol, rtol) against the plain version. Both sides compute in float32
#: and round the output once, so in bfloat16 they may differ by one ulp
#: (at most 2**-7 of the value), and only where the float32 value sits
#: next to a rounding boundary: at most ``BF16_UNEQUAL_SHARE`` of the
#: elements may differ at all. SDPA, which rounds its probabilities to
#: bfloat16, stays within the ulp but differs on about 40% of them.
ATTENTION_BARS = {"bfloat16": (4e-3, 8e-3), "float32": (2e-5, 2e-5)}
BF16_UNEQUAL_SHARE = 0.01


def unmasked_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: each costs 4*hd flops."""
    total = 0
    for t in range(T):
        lo = max(0, t - window + 1) if window > 0 else 0
        hi = min(S - 1, t) if causal else S - 1
        total += max(0, hi - lo + 1)
    return total


def sdpa(torch, q, k, v, causal: bool, window: int):
    """One call of PyTorch's ``scaled_dot_product_attention`` computing what
    ``flash_attention`` computes on these inputs (``is_causal`` or a
    boolean mask, ``enable_gqa``): the yardstick, never on the port's
    path."""
    import torch.nn.functional as F

    T, S = q.shape[2], k.shape[2]
    gqa = {"enable_gqa": True} if k.shape[1] != q.shape[1] else {}
    if not causal and window == 0:  # no mask: SDPA's flash backend
        return lambda: F.scaled_dot_product_attention(q, k, v, **gqa)
    rel = (torch.arange(T, device=q.device)[:, None]
           - torch.arange(S, device=q.device)[None, :])
    mask = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
    if window > 0:
        mask &= rel < window
    if causal and window == 0:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      **gqa)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  **gqa)


def attention_numbers(torch, label: str, q, k, v, kw: dict, out,
                      route: str, loader) -> dict:
    """One attention case's kernel output ``out`` against the plain
    version on the same inputs at ``ATTENTION_BARS`` (and, in bf16, at
    most ``BF16_UNEQUAL_SHARE`` of the elements unequal), then its times:
    the kernel by CUDA events, replayed in a graph and under the profiler,
    the plain version, SDPA (the yardstick) and the bound. Returns the
    kernels line's numbers."""
    from repro_torch.kernels.flash_attention import ops, ref

    B, nh, T, hd = q.shape
    dt_name = str(q.dtype).removeprefix("torch.")
    causal, window = kw["causal"], kw["window"]
    want = ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"attention {label}: output {out.dtype} {tuple(out.shape)}")
    atol, rtol = ATTENTION_BARS[dt_name]
    err = (out.float() - want.float()).abs()
    bad = n_outside(out, want, atol, rtol)
    check(bad == 0, f"attention {label}: {bad} elements outside atol "
                    f"{atol} rtol {rtol}, max abs err {float(err.max())}")
    lib = sdpa(torch, q, k, v, causal, window)
    lib_out = lib()
    lib_err = float((lib_out.float() - want.float()).abs().max())
    lib_bad = n_outside(lib_out, want, atol, rtol)
    # elements not equal to the plain version at all: the kernel differs
    # only where its float32 value sits next to an output rounding
    # boundary, SDPA also where its low-precision products move it
    ne, lib_ne = int((out != want).sum()), int((lib_out != want).sum())
    del lib_out
    check(dt_name != "bfloat16" or ne <= BF16_UNEQUAL_SHARE * out.numel(),
          f"attention {label}: {ne} of {out.numel()} elements differ "
          f"from the plain version")
    pairs = B * nh * unmasked_pairs(T, k.shape[2], causal, window)
    n_bytes = out.element_size() * (2 * q.numel() + 2 * k.numel())
    fa = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
    g_ms = graph_ms(torch, fa, n=10)
    # the profiler loses some or all of a profile's kernels (late in
    # this run every one, in a process of its own at times): a reading
    # more than 5% off the graph replay's device time is not a
    # measurement, None
    prof_us = device_us(torch, fa, n=10)
    dev_us = prof_us if abs(prof_us - 1e3 * g_ms) <= 50 * g_ms else None
    r = dict(max_abs_err=float(err.max()), ms=time_ms(torch, fa, n=10),
             graph_ms=g_ms, device_us=dev_us,
             plain_ms=time_ms(torch, lambda: ref.attention(q, k, v, **kw),
                              n=5),
             library_ms=time_ms(torch, lib, n=10),
             variant=route, source=ATTENTION_SOURCE[route])
    if loader is not None:
        r["loader"] = loader
    if dt_name == "bfloat16":
        flops = 4 * hd * pairs
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops,
                                                BF16_OPS_PER_S)
        bounds = f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}"
    else:
        # three TF32 products per multiply on the tensor cores, beside
        # the one float32 product any SIMT design is held to
        flops = 12 * hd * pairs
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops,
                                                TF32_OPS_PER_S)
        r["bound_ms_simt"] = bound_ms(n_bytes, 4 * hd * pairs)[0]
        bounds = (f"bound_ms {r['bound_ms']:.4f} (3xTF32 at 495 "
                  f"TFLOP/s, {r['bound_by']}), SIMT bound_ms "
                  f"{r['bound_ms_simt']:.4f} (67 TFLOP/s")
    dev_txt = (f"{dev_us:.1f}" if dev_us is not None else
               f"not measured (profiler read {prof_us:.1f})")
    log(f"attention {label} (B={B} nh={nh} nkv={k.shape[1]} hd={hd} "
        f"T={T} S={k.shape[2]} {dt_name} causal={causal} window={window}, "
        f"{route} kernel"
        f"{'' if loader is None else f', {loader} loader'}): "
        f"max abs err "
        f"{r['max_abs_err']:.3g} (bar atol {atol} rtol {rtol}; SDPA's "
        f"{lib_err:.3g}, {lib_bad} of {out.numel()} elements outside "
        f"the bar); elements not equal to the plain version: kernel "
        f"{ne}, SDPA {lib_ne}; ms "
        f"{r['ms']:.4f} graph_ms {g_ms:.4f} device_us {dev_txt} plain_ms "
        f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
        f"{bounds}, {flops / 1e9:.2f} GFLOP)")
    return r


def attention_phase(torch):
    """The attention path: ``flash_attention`` once per case of
    ``ATTENTION_CASES`` through the kernel, then each result against the
    plain version on the same inputs at ``ATTENTION_BARS``, and the times
    of the kernel, the plain version and PyTorch's
    ``scaled_dot_product_attention`` (the yardstick; the port never calls
    it). Returns one (case, launches, result) per case."""
    from repro_torch.kernels.flash_attention import ops

    # the plain version's products in full float32, as the kernel's
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2604)
    inputs = []
    for label, B, nh, nkv, hd, T, dt_name, causal, window in ATTENTION_CASES:
        dtype = getattr(torch, dt_name)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, nh, T, hd), (B, nkv, T, hd),
                                 (B, nkv, T, hd)))
        inputs.append((q, k, v, dict(causal=causal, window=window)))
    ops.reset_launch_counts()
    outs, launches, routes = [], [], []
    for q, k, v, kw in inputs:
        hd = q.shape[-1]
        route = ops._route(q.dtype, hd)
        loader = ops._loader(hd) if route == "wgmma" else None
        before = ops.launch_counts()
        outs.append(ops.flash_attention(q, k, v, **kw))
        after = ops.launch_counts()
        launches.append(after["flash_attention"] - before["flash_attention"])
        d = {key: after[key] - before[key] for key in after}
        check(d[f"flash_attention_{route}"] == 1,
              f"flash_attention: the {route} kernel launched "
              f"{d[f'flash_attention_{route}']} times for one call")
        check(d["flash_attention_wgmma_threads"] == (loader == "threads"),
              f"flash_attention: the wgmma thread loader launched "
              f"{d['flash_attention_wgmma_threads']} times for one call at "
              f"hd {hd} ({route}, loader {loader})")
        routes.append((route, loader))
    torch.cuda.synchronize()
    check(launches == [1] * len(inputs),
          f"flash_attention: {launches} launches per case")

    per_case = []
    for case, (q, k, v, kw), out, n_launch, (route, loader) in zip(
            ATTENTION_CASES, inputs, outs, launches, routes):
        label, B, nh, nkv, hd, T, dt_name, causal, window = case
        r = attention_numbers(torch, label, q, k, v, kw, out, route, loader)
        per_case.append((f"{label} (nh {nh} nkv {nkv} hd {hd} T=S {T} "
                         f"{dt_name} window {window})", n_launch, r))
    return per_case


@functools.lru_cache(maxsize=None)
def scan_sass_count(bf16: bool, N: int) -> dict:
    """Instructions a state-step of the fused scan's kernel instance for
    ``N`` (``bf16`` inputs, else float32), from its SASS (``cuobjdump``):
    the loop that holds the most ``MUFU.EX2`` (each state-step's ``expf``
    has one), its instructions, and over its ``MUFU.EX2`` count: all of
    them (``per_state_step``, a diagnostic: it grows with the kernel's own
    overheads), its float32 ones and the float32 and ``MUFU`` ones, which
    are the function's work (``operations_per_state_step``: the products
    and sums of dA, dBu, the recurrence and y, and ``expf``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import ops

    name = (f"ms_scan_kernel<1,{'__nv_bfloat16' if bf16 else 'f'},"
            f"{ops.group_log2(N)},{int(N % ops.STATES_PER_THREAD == 0)}>")
    funcs = _build.sass_functions(_build.sass("mamba_scan"))
    check(name in funcs, f"selective_scan: no SASS of {name} in "
                         f"{sorted(funcs)}")
    loop = _build.hot_loop(funcs[name], "MUFU.EX2")
    n = loop.get("MUFU.EX2", 0)
    check(n > 0, f"selective_scan: no loop of {name} holds MUFU.EX2")
    fp32 = sum(v for k, v in loop.items()
               if k.split(".")[0] in ("FADD", "FMUL", "FFMA", "FSETP",
                                      "FSEL", "FMNMX", "FRND"))
    mufu = sum(v for k, v in loop.items() if k.split(".")[0] == "MUFU")
    return dict(kernel=name, loop_instructions=sum(loop.values()),
                mufu_ex2=n, per_state_step=sum(loop.values()) / n,
                fp32_per_state_step=fp32 / n,
                operations_per_state_step=(fp32 + mufu) / n)


def scan_bound(torch, entry: str, args, y, h) -> dict:
    """The least time of one scan call (``entry`` and ``args`` as in
    :func:`scan_numbers`, ``y`` and ``h`` its outputs): its bytes, each
    input read once and y and h written once, at the memory rate, against
    its operations at their peak. ``mamba_scan``: 4 float32 operations a
    state and step (multiply, add, multiply by C, sum).
    ``selective_scan``: its state-steps times the operations a state-step
    of :func:`scan_sass_count`, at one instruction a lane and clock.
    Returns ``bound_ms``, ``bound_by``, ``n_bytes``, ``sass`` (None for
    ``mamba_scan``) and ``what``, a note for the log."""
    B, T, D = y.shape
    N = h.shape[2]
    out_bytes = 4 * (y.numel() + h.numel())
    sass = None
    if entry == "mamba_scan":
        dA, dBu, C = args
        n_bytes = (dA.numel() * dA.element_size()
                   + dBu.numel() * dBu.element_size()
                   + C.numel() * C.element_size() + out_bytes)
        nb, kind = bound_ms(n_bytes, 4 * dA.numel())
        what = f"dA/dBu {dA.numel() * dA.element_size() / 1e9:.2f} GB each"
    else:
        u, dt, A, Bm, Cm = args
        n_bytes = sum(x.numel() * x.element_size() for x in args) + out_bytes
        sass = scan_sass_count(u.dtype == torch.bfloat16, N)
        steps = B * T * D * N
        ops_each = sass["operations_per_state_step"]
        nb, kind = bound_ms(n_bytes, steps * ops_each, INSTR_PER_S)
        what = (f"u {str(u.dtype).split('.')[-1]}, {steps / 1e6:.1f} M "
                f"state-steps at {ops_each:.2f} "
                f"operations each (float32 and MUFU; "
                f"{sass['fp32_per_state_step']:.2f} float32) at "
                f"{INSTR_PER_S / 1e12:.2f} T/s; the hot loop of "
                f"{sass['kernel']} runs {sass['per_state_step']:.2f} "
                f"instructions a state-step ({sass['loop_instructions']} "
                f"with {sass['mufu_ex2']} MUFU.EX2, SASS)")
    return dict(bound_ms=nb, bound_by=kind, n_bytes=n_bytes, sass=sass,
                what=what)


def scan_numbers(torch, label: str, entry: str, args, y, h) -> dict:
    """One scan entry's ``y`` and final state ``h`` (``entry``:
    ``"mamba_scan"``, args dA, dBu, C; or ``"selective_scan"``, args u, dt,
    A, Bm, Cm) against its plain version on the same inputs at 1e-4
    atol/rtol, then its times with the state: the kernel by CUDA events,
    in a CUDA graph of 10 calls and by the profiler, the plain version and
    the bound (:func:`scan_bound`). Returns the kernels line's numbers."""
    from repro_torch.kernels.mamba_scan import ops, ref

    kernel, plain = getattr(ops, entry), getattr(ref, entry)
    want = plain(*args, return_state=True)
    torch.cuda.synchronize()
    errs = []
    for what, g, w in zip(("y", "h"), (y, h), want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{entry} {label}: {what} shape or finiteness")
        err = (g - w).abs()
        bad = int((err > 1e-4 + 1e-4 * w.abs()).sum())
        check(bad == 0, f"{entry} {label}: {bad} elements of {what} "
                        f"outside 1e-4 atol/rtol, max abs err "
                        f"{float(err.max())}")
        errs.append(float(err.max()))
    del want
    B, T, D = y.shape
    N = h.shape[2]
    bound = scan_bound(torch, entry, args, y, h)
    nb, kind, sass = bound["bound_ms"], bound["bound_by"], bound["sass"]
    fn = lambda: kernel(*args, return_state=True)  # noqa: E731
    g_ms = graph_ms(torch, fn, n=10)
    # a profiler reading more than 5% off the graph replay's device time
    # is not a measurement (see attention_numbers)
    prof_us = device_us(torch, fn, n=10)
    dev_us = prof_us if abs(prof_us - 1e3 * g_ms) <= 50 * g_ms else None
    r = dict(max_abs_err=max(errs), ms=time_ms(torch, fn, n=10),
             graph_ms=g_ms, device_us=dev_us,
             plain_ms=time_ms(torch, lambda: plain(*args, return_state=True),
                              n=2, warm=1),
             bound_ms=nb, bound_by=kind, library_ms=None)
    if sass is not None:
        r["operations_per_state_step"] = sass["operations_per_state_step"]
        r["instructions_per_state_step"] = sass["per_state_step"]
    dev_txt = (f"{dev_us:.1f}" if dev_us is not None else
               f"not measured (profiler read {prof_us:.1f})")
    log(f"{entry} {label} (B={B} T={T} D={D} N={N}, {bound['what']}, final "
        f"state): max abs err {errs[0]:.3g} (state {errs[1]:.3g}; bar "
        f"1e-4); ms {r['ms']:.4f} graph_ms {g_ms:.4f} device_us {dev_txt} "
        f"plain_ms {r['plain_ms']:.4f} bound_ms {nb:.4f} ({kind}, "
        f"{bound['n_bytes'] / 1e9:.3f} GB); {100 * nb / g_ms:.1f}% of the "
        f"bound")
    return r


def selective_inputs(torch, B: int, T: int, D: int, N: int, dtr: int,
                     dtype, gen):
    """Seeded inputs of the fused scan on the card: u, dt a softplus of
    normal values about the model's -4.6 bias, A = -(1..N) on every row,
    and B and C as the column slices ``models.ssm`` takes of one
    ``[B, T, dtr + 2N]`` projection."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    u = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((B, T, D), generator=gen, device=dev) - 4.6)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(D, 1)
    dbc = torch.randn((B, T, dtr + 2 * N), generator=gen,
                      device=dev).to(dtype)
    return u, dt, A, dbc[..., dtr:dtr + N], dbc[..., dtr + N:]


def mamba_phase(torch, B: int = 1, T: int = 2048, D: int = 8192,
                N: int = 16, dtr: int = 256):
    """The selective scan at falcon_mamba_7b's widths (d_inner 8192, state
    16, dt rank 256; T = 2048), both entries with the final state, each
    once through the kernel (counts reset just before) and held against
    the plain version at 1e-4 atol/rtol: ``mamba_scan`` on seeded dA and
    dBu, ``selective_scan`` on seeded bf16 u, B and C and float32 dt and A.
    Returns (kernel, case, launches, result) of each."""
    from repro_torch.kernels.mamba_scan import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7007)
    dA = torch.rand((B, T, D, N), generator=gen, device=dev).neg_().exp_()
    dBu = torch.randn((B, T, D, N), generator=gen, device=dev).mul_(0.1)
    C = torch.randn((B, T, N), generator=gen, device=dev)
    fused = selective_inputs(torch, B, T, D, N, dtr, torch.bfloat16, gen)
    cases = []
    for entry, args, what in (
            ("mamba_scan", (dA, dBu, C), "dA and dBu"),
            ("selective_scan", fused, "bf16 u, B and C")):
        ops.reset_launch_counts()
        y, h = getattr(ops, entry)(*args, return_state=True)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check(launches[entry] == 1 and sum(launches.values()) == 1,
              f"{entry}: launches {launches} on its path")
        r = scan_numbers(torch, "falcon_mamba_7b", entry, args, y, h)
        cases.append((entry, f"falcon_mamba_7b (B {B} T {T} D {D} N {N}, "
                             f"{what}, final state)", launches[entry], r))
    return cases


#: The serve phase: hymba_1_5b at its published widths and depth, its
#: weights from a seeded generator; 8 requests on 4 slots (2 waves), prompts
#: of 1,280-1,536 seeded tokens, each wave left-padded to its longest (so
#: every local layer's 1,024-slot ring buffer is shorter than the prompt),
#: 32 new tokens each, caches of 2,048 positions.
SERVE_ARCH = "hymba_1_5b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_MAX_NEW = 4, 2048, 8, 32
SERVE_PROMPT = (1280, 1536)
#: Largest difference of the prefill logits between the kernels and their
#: plain versions on the card. float32: the attention kernel is within
#: 2e-5 and the scan within 1e-4 of the plain versions at each of the 32
#: layers. bfloat16: every activation is rounded to bf16 (one ulp 2**-8 of
#: the value), and the attention kernel may differ by one ulp on up to 1%
#: of its outputs; the bar is set from the first float32 and bfloat16 runs
#: on the card (PERF.md).
SERVE_LOGIT_BARS = {"float32": 1e-3, "bfloat16": 0.25}
#: Calls of a served prefill whose kernel inputs the phase keeps: layer 0
#: (global attention) and layer 1 (a 1,024-key window), the scan of layer 0
#: (its fused entry, which ``models.ssm.gated_scan`` calls).
SERVE_KEEP = {"flash_attention": (0, 1), "selective_scan": (0,)}


def serve_requests(torch, vocab: int):
    from repro_torch.serve.engine import Request

    gen = torch.Generator().manual_seed(2828)
    lo, hi = SERVE_PROMPT
    lens = torch.randint(lo, hi + 1, (SERVE_REQUESTS,), generator=gen)
    lens[0] = hi  # the first wave reaches the longest prompt
    return [Request(rid=i, prompt=torch.randint(0, vocab, (int(n),),
                                                generator=gen),
                    max_new=SERVE_MAX_NEW) for i, n in enumerate(lens)]


@contextlib.contextmanager
def served_kernel_inputs(keep: dict):
    """Keep the arguments of the model's kernel calls whose index (in call
    order, one call a layer in a prefill) is in ``keep`` (a kernel it does
    not name: none), while the calls go on to the kernels as before."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod

    mods = {"flash_attention": attn_mod, "selective_scan": ssm_mod}
    orig = {name: getattr(mod, name) for name, mod in mods.items()}
    kept = {name: {} for name in mods}
    calls = dict.fromkeys(mods, 0)

    def recorder(name):
        def call(*args, **kw):
            if calls[name] in keep.get(name, ()):
                kept[name][calls[name]] = (args, kw)
            calls[name] += 1
            return orig[name](*args, **kw)
        return call

    for name, mod in mods.items():
        setattr(mod, name, recorder(name))
    try:
        yield kept
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])


def serve_run(torch, cfg, params, requests, impl: str, keep=None):
    """``ServeLoop(...).run(requests)`` with ``impl``: every wave's prefill
    and decode step timed by CUDA events (the loop's step functions
    wrapped; the timing synchronises after each), the prefill logits kept,
    both kernels' launch counts set to 0 just before and read just after,
    the peak device memory. ``keep``: see :func:`served_kernel_inputs`."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.serve.engine import ServeLoop

    loop = ServeLoop(cfg, params, batch_slots=SERVE_SLOTS,
                     max_len=SERVE_MAX_LEN, impl=impl)
    rec = {"prefill_ms": [], "decode_ms": [], "logits": []}

    def timed(fn, key, keep_logits):
        def step(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            torch.cuda.synchronize()
            rec[key].append(start.elapsed_time(stop))
            if keep_logits:
                rec["logits"].append(out[0].float())
            return out
        return step

    loop.prefill = timed(loop.prefill, "prefill_ms", True)
    loop.decode = timed(loop.decode, "decode_ms", False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launch_counts()
    ms_ops.reset_launch_counts()
    with (served_kernel_inputs(keep) if keep else
          contextlib.nullcontext({})) as kept:
        t0 = time.perf_counter()
        out = loop.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec.update(out=out, wall=wall, kept=kept,
               launches={**fa_ops.launch_counts(), **ms_ops.launch_counts()},
               peak=torch.cuda.max_memory_allocated())
    return rec


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def profiled_kernels(torch, fn):
    """``(name, device ms, calls)`` of every kernel one call of ``fn``
    runs (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def kernel_groups(kernels) -> dict:
    """Device ms of a ``(name, ms, calls)`` list by kernel name: the
    attention kernel, the scan kernel, matrix products, the rest."""
    groups = dict.fromkeys(("attention", "scan", "matmul", "rest"), 0.0)
    for name, ms, _ in kernels:
        low = name.lower()
        group = ("attention" if "fa_wgmma" in low or "fa_tf32x3" in low else
                 "scan" if "ms_scan_kernel" in low else
                 "matmul" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                                    "cutlass")) else "rest")
        groups[group] += ms
    return groups


def serve_profile(torch, cfg, params, requests) -> dict:
    """The first wave's prefill and one decode step after it, each after
    a warm-up call: by CUDA events without the profiler, then under
    ``torch.profiler``: the prefill's device time by kernel group
    (attention, scan, matrix products, the rest; the top kernels by name
    printed), the decode step's device time and kernel launches."""
    import torch.nn.functional as F

    from repro_torch.models import decode_step, init_cache, prefill

    wave = requests[:SERVE_SLOTS]
    T = max(r.prompt.shape[0] for r in wave)
    toks = torch.stack([F.pad(r.prompt, (T - r.prompt.shape[0], 0))
                        for r in wave]).cuda()
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(
            cfg, params, {"tokens": toks},
            init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN))

    def run_decode():
        decode_step(cfg, params, state["logits"].argmax(-1)[:, None],
                    state["cache"], T)

    out = {}
    for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
        out[f"{name}_ms"] = time_ms(torch, fn, n=1, warm=1)
        out[f"{name}_kernels"] = profiled_kernels(torch, fn)
    for name, ms, n in sorted(out["prefill_kernels"], key=lambda k: -k[1])[:8]:
        log(f"  prefill kernel {ms:9.3f} ms {n:5d} calls  {name[:110]}")
    out["prefill_groups"] = kernel_groups(out["prefill_kernels"])
    return out


def serve_phase(torch, card: str):
    """hymba_1_5b served at full width through ``ServeLoop`` (see the
    module notes). Returns the kernels line's cases: attention (float32,
    bf16) and the scan at the served shapes, with their launches on the
    served path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    from repro_torch.models import init_cache, init_params

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config(SERVE_ARCH)
    n_layers = base.n_layers
    requests = serve_requests(torch, base.vocab_size)
    log(f"serve: {base.name} ({base.n_layers} layers, d_model "
        f"{base.d_model}, {base.n_heads} heads, {base.n_kv_heads} kv heads, "
        f"hd {base.hd}, d_ff {base.d_ff}, vocab {base.vocab_size}, window "
        f"{base.sliding_window}, global layers {base.global_layers}, state "
        f"{base.ssm_state}, d_inner {base.d_inner}; "
        f"{base.param_count() / 1e9:.3f} B parameters); {len(requests)} "
        f"requests, prompts {[r.prompt.shape[0] for r in requests]} tokens, "
        f"{SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}, {SERVE_MAX_NEW} new "
        f"tokens each [{card}]")
    n_waves = -(-len(requests) // SERVE_SLOTS)
    want_launches = n_waves * n_layers
    cases = []
    for dt_name in ("float32", "bfloat16"):
        cfg = base.replace(dtype=getattr(torch, dt_name))
        gen = torch.Generator(device="cuda").manual_seed(1515)
        params = init_params(cfg, gen, "cuda")
        runs = {}
        for impl in ("cuda", "torch"):
            runs[impl] = r = serve_run(torch, cfg, params, requests, impl,
                                       SERVE_KEEP if impl == "cuda" else None)
            toks = sum(len(v) for v in r["out"].values())
            log(f"serve {dt_name} {impl}: {r['wall']:.2f} s wall, {toks} "
                f"tokens, {toks / r['wall']:.1f} tok/s; prefill ms a wave "
                f"{[round(x, 2) for x in r['prefill_ms']]}, decode ms a step "
                f"mean {np.mean(r['decode_ms']):.3f} (min "
                f"{min(r['decode_ms']):.3f}, max {max(r['decode_ms']):.3f}, "
                f"{len(r['decode_ms'])} steps); launches flash_attention "
                f"{r['launches']['flash_attention']} selective_scan "
                f"{r['launches']['selective_scan']} mamba_scan "
                f"{r['launches']['mamba_scan']}; peak device memory "
                f"{r['peak'] / 1e9:.3f} GB [{card}]")
            for logits in r["logits"]:
                check(bool(torch.isfinite(logits).all()),
                      f"serve {dt_name} {impl}: non-finite logits")
        cu, pl = runs["cuda"], runs["torch"]
        route = fa_ops._route(cfg.dtype, cfg.hd)
        for key, n in (("flash_attention", want_launches),
                       (f"flash_attention_{route}", want_launches),
                       ("selective_scan", want_launches), ("mamba_scan", 0)):
            check(cu["launches"][key] == n,
                  f"serve {dt_name}: {key} launched {cu['launches'][key]} "
                  f"times, not {n} ({n_waves} waves x {n_layers} layers)")
            check(pl["launches"][key] == 0,
                  f"serve {dt_name}: the plain run launched {key}")
        diff = max(float((a - b).abs().max())
                   for a, b in zip(cu["logits"], pl["logits"]))
        same = sum(a == b for rid in cu["out"]
                   for a, b in zip(cu["out"][rid], pl["out"][rid]))
        total = sum(len(v) for v in cu["out"].values())
        top = max(float(a.abs().max()) for a in pl["logits"])
        log(f"serve {dt_name}: prefill logits kernels vs plain max abs diff "
            f"{diff:.6g} (bar {SERVE_LOGIT_BARS[dt_name]}; largest |logit| "
            f"{top:.4g}); tokens equal {same} of {total} "
            f"({same / total:.4f})")
        check(diff <= SERVE_LOGIT_BARS[dt_name],
              f"serve {dt_name}: prefill logits {diff} from the plain path")
        if dt_name == "float32":
            check(cu["out"] == pl["out"],
                  "serve float32: the kernel path's tokens differ from the "
                  "plain path's")
        weights = tree_bytes(params)
        cache = tree_bytes(init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN))
        log(f"serve {dt_name}: weights {weights / 1e9:.3f} GB, cache "
            f"{cache / 1e6:.1f} MB ({SERVE_SLOTS} slots x {SERVE_MAX_LEN}), "
            f"peak device memory cuda {cu['peak'] / 1e9:.3f} GB, plain "
            f"{pl['peak'] / 1e9:.3f} GB [{card}]")
        prof = serve_profile(torch, cfg, params, requests)
        groups = prof["prefill_groups"]
        busy = sum(groups.values())
        log(f"serve {dt_name} prefill device ms by kernel (one wave, "
            f"profiler): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                       groups.items())
            + f"; total {busy:.3f}, the same wave {prof['prefill_ms']:.3f} "
              f"ms by events (idle share "
              f"{1 - busy / prof['prefill_ms']:.3f}) [{card}]")
        dec_busy = sum(ms for _, ms, _ in prof["decode_kernels"])
        dec_n = sum(n for _, _, n in prof["decode_kernels"])
        log(f"serve {dt_name} decode step: {prof['decode_ms']:.3f} ms by "
            f"events, device {dec_busy:.3f} ms in {dec_n} kernels "
            f"(profiler; idle share {1 - dec_busy / prof['decode_ms']:.3f})"
            f" [{card}]")
        # one served layer's own kernel inputs against the plain versions
        kept = cu["kept"]
        check(all(set(kept[k]) == set(v) for k, v in SERVE_KEEP.items()),
              "serve: kernel inputs not kept")
        loader = fa_ops._loader(cfg.hd) if route == "wgmma" else None
        for i in SERVE_KEEP["flash_attention"]:
            (q, k, v), kw = kept["flash_attention"][i]
            kw = {key: kw[key] for key in ("causal", "window")}
            layer = ("global" if kw["window"] == 0 else
                     f"window {kw['window']}")
            out = fa_ops.flash_attention(q, k, v, impl="cuda", **kw)
            r = attention_numbers(torch, f"served layer {i} {dt_name}",
                                  q, k, v, kw, out, route, loader)
            if kw["window"]:
                cases.append(("flash_attention",
                              f"{base.name} served layer {i} ({layer}; B "
                              f"{q.shape[0]} nh {q.shape[1]} nkv "
                              f"{k.shape[1]} hd {q.shape[3]} T=S "
                              f"{q.shape[2]} {dt_name})",
                              cu["launches"]["flash_attention"], r))
        if dt_name == "bfloat16":
            args, _ = kept["selective_scan"][0]
            u, dt, A, Bm, Cm = args
            shape = (f"B {u.shape[0]} T {u.shape[1]} D {u.shape[2]} N "
                     f"{A.shape[1]}")
            y, h = ms_ops.selective_scan(*args, return_state=True,
                                         impl="cuda")
            r = scan_numbers(torch, "served layer 0", "selective_scan", args,
                             y, h)
            cases.append(("selective_scan",
                          f"{base.name} served layer 0 ({shape}, bf16 u, B "
                          f"and C, final state)",
                          cu["launches"]["selective_scan"], r))
            # the contract entry on the same layer's dA and dBu, driven on
            # its own (the served path no longer launches it)
            dA, dBu = ms_ref.scan_inputs(u, dt, A, Bm)
            C = Cm.float().contiguous()
            ms_ops.reset_launch_counts()
            y, h = ms_ops.mamba_scan(dA, dBu, C, return_state=True,
                                     impl="cuda")
            n = ms_ops.launch_counts()["mamba_scan"]
            r = scan_numbers(torch, "served layer 0's dA and dBu",
                             "mamba_scan", (dA, dBu, C), y, h)
            cases.append(("mamba_scan",
                          f"{base.name} served layer 0's dA and dBu "
                          f"({shape}, final state)", n, r))
            del dA, dBu, C, y, h
        del params, runs, cu, pl, kept
        torch.cuda.empty_cache()
    # the launch command, as a user runs it, on the card
    launch_serve("hymba-1.5b", card)
    log(f"serve phase: {time.perf_counter() - t_phase:.2f} s")
    return cases


#: The family serve phase, after hymba: (arch, decoder layers kept, None
#: for all; prompt tokens, lowest and highest; encoder frames, lowest and
#: highest, for the enc-dec config). Published widths; arctic_480b's depth
#: cut from 35 layers to 1 (28.1 GB of bf16 weights a layer's worth of
#: experts and the rest; the whole model is some 960 GB). One wave of
#: FAMILY_SLOTS prompts, then FAMILY_DECODE greedy decode steps.
FAMILY_SERVE = (
    ("olmoe_1b_7b", None, (768, 1024), None),
    ("phi_3_vision_4_2b", None, (512, 768), None),
    ("seamless_m4t_large_v2", None, (64, 128), (1024, 1536)),
    ("arctic_480b", 1, (256, 384), None),
)
FAMILY_SLOTS, FAMILY_DECODE = 4, 16


def family_batch(torch, cfg, prompt, frames, seed: int):
    """One wave: FAMILY_SLOTS seeded prompts of ``prompt`` tokens (the
    first the longest), left-padded with token 0 as ``ServeLoop`` pads;
    the vision stub's patch embeddings or the audio stub's frames drawn
    by ``models.multimodal`` on the card. Returns (batch, prefix tokens)."""
    import torch.nn.functional as F

    from repro_torch.models import multimodal

    gen = torch.Generator().manual_seed(seed)
    lo, hi = prompt
    lens = torch.randint(lo, hi + 1, (FAMILY_SLOTS,), generator=gen)
    lens[0] = hi
    toks = torch.stack([F.pad(torch.randint(0, cfg.vocab_size, (int(n),),
                                            generator=gen), (hi - int(n), 0))
                        for n in lens]).cuda()
    batch = {"tokens": toks}
    dev_gen = torch.Generator(device="cuda").manual_seed(seed)
    fe = 0
    if cfg.frontend == "vision":
        batch["frontend"] = multimodal.synthetic_frontend(cfg, dev_gen,
                                                          FAMILY_SLOTS)
        fe = cfg.frontend_tokens
    if cfg.is_enc_dec:
        n = int(torch.randint(frames[0], frames[1] + 1, (1,), generator=gen))
        batch["enc_input"] = multimodal.synthetic_frames(cfg, dev_gen,
                                                         FAMILY_SLOTS, n)
    return batch, fe


@contextlib.contextmanager
def moe_routes(force=None):
    """Record each MoE layer call's routing in call order: the router's
    own top-k experts (``own``), the capacity and the slots
    (``p_sel``). With ``force`` (an earlier run's record) each call
    dispatches that run's experts instead of its own, with gates from its
    own probabilities at them (``router_topk``'s renormalisation): the
    plain run then follows the kernel run's routing, and each (token,
    layer) where its own router would choose otherwise shows in ``own``."""
    from repro_torch.models import moe as moe_mod

    orig_router, orig_dispatch = moe_mod.router_topk, moe_mod.moe_dispatch
    rec = []

    def router(logits, k):
        gates, idx, aux = orig_router(logits, k)
        rec.append({"own": idx})
        if force is not None:
            idx = force[len(rec) - 1]["own"]
            gates = logits.float().softmax(-1).gather(-1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return gates, idx, aux

    def dispatch(x, idx, capacity, n_experts):
        out = orig_dispatch(x, idx, capacity, n_experts)
        rec[-1].update(capacity=capacity, p_sel=out[2])
        return out

    moe_mod.router_topk, moe_mod.moe_dispatch = router, dispatch
    try:
        yield rec
    finally:
        moe_mod.router_topk, moe_mod.moe_dispatch = orig_router, orig_dispatch


def family_run(torch, cfg, params, batch, fe: int, impl: str, keep=None,
               feed=None, force=None):
    """``prefill`` then FAMILY_DECODE greedy ``decode_step``s through the
    model's entry points with ``impl``, each step timed by CUDA events;
    ``feed`` (an earlier run's tokens) is fed to decode in place of this
    run's own picks, ``force`` routes its MoE layers (:func:`moe_routes`).
    Both kernels' launch counts set to 0 just before and read just after;
    the peak device memory of the run."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.models import decode_step, init_cache, prefill

    T = batch["tokens"].shape[1]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launch_counts()
    ms_ops.reset_launch_counts()
    rec = {"decode_ms": [], "picks": [], "decode_logits": []}
    with served_kernel_inputs(keep or {}) as kept, moe_routes(force) as routes:
        t0 = time.perf_counter()
        cache = init_cache(cfg, FAMILY_SLOTS, fe + T + FAMILY_DECODE)
        (logits, cache), rec["prefill_ms"] = timed(
            lambda: prefill(cfg, params, batch, cache, impl=impl))
        rec["logits"] = logits.float()
        for i in range(FAMILY_DECODE):
            pick = logits.argmax(-1)[:, None]
            rec["picks"].append(pick)
            cur = pick if feed is None else feed[i]
            (logits, cache), ms = timed(
                lambda: decode_step(cfg, params, cur, cache, fe + T + i))
            rec["decode_ms"].append(ms)
            rec["decode_logits"].append(logits.float())
        rec["picks"].append(logits.argmax(-1)[:, None])
        torch.cuda.synchronize()
        rec["wall"] = time.perf_counter() - t0
    rec.update(kept=kept, routes=routes,
               launches={**fa_ops.launch_counts(), **ms_ops.launch_counts()},
               peak=torch.cuda.max_memory_allocated())
    del cache
    return rec


def routing_numbers(cu, pl, n_layers: int) -> dict:
    """The prefill's dropped share (assignments in the dead column) in
    the kernel run, decode's dropped assignments, and the share of
    (token, layer) top-k sets of the plain run's own router that differ
    from the kernel run's, in prefill and in decode (the plain run
    dispatched the kernel run's choices)."""
    def share(calls, key):
        diff = total = 0
        for a, b in calls:
            if key == "dropped":
                diff += int((a["p_sel"] == a["capacity"]).sum())
                total += a["p_sel"].numel()
            else:
                ne = (a["own"].sort(-1).values != b["own"].sort(-1).values)
                diff += int(ne.any(-1).sum())
                total += ne.shape[0]
        return diff, total

    pre = list(zip(cu["routes"][:n_layers], pl["routes"][:n_layers]))
    dec = list(zip(cu["routes"][n_layers:], pl["routes"][n_layers:]))
    return {"prefill_dropped": share(pre, "dropped"),
            "by_layer": [round(d / n, 4) for d, n in
                         (share([c], "dropped") for c in pre)],
            "decode_dropped": share(dec, "dropped"),
            "prefill_differ": share(pre, "own"),
            "decode_differ": share(dec, "own"),
            "capacity": cu["routes"][0]["capacity"]}


def family_serve_phase(torch, card: str):
    """The new families served at full width (see the module notes and
    ``FAMILY_SERVE``). Returns the kernels line's cases: bf16 attention on
    each config's kept calls, with the config's launches on the served
    path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_cache, init_params, prefill

    t_phase = time.perf_counter()
    cases = []
    bar = SERVE_LOGIT_BARS["bfloat16"]
    for n, (arch, depth, prompt, frames) in enumerate(FAMILY_SERVE):
        t_cfg = time.perf_counter()
        base = get_config(arch)
        cfg = base.replace(dtype=torch.bfloat16)
        if depth is not None:
            cfg = cfg.replace(n_layers=depth)
        enc = cfg.encoder_layers
        n_attn = cfg.n_layers + 2 * enc  # self, and encoder and cross
        # the kept calls (an enc-dec prefill calls the encoder's layers
        # first, then self- and cross-attention a decoder layer)
        names = ({0: "encoder layer 0 (bidirectional)",
                  enc: "layer 0 self-attention",
                  enc + 1: "cross-attention 0 (T decoder queries against "
                           "S frames)"} if enc else {0: "layer 0"})
        keep = {"flash_attention": tuple(names)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(3030 + n), "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        weights = tree_bytes(params)
        batch, fe = family_batch(torch, cfg, prompt, frames, 3030 + n)
        T = batch["tokens"].shape[1]
        shape = (f"{FAMILY_SLOTS} slots x {fe + T} positions"
                 + (f" ({fe} patch embeddings + {T} tokens)" if fe else "")
                 + (f", {batch['enc_input'].shape[1]} encoder frames of "
                    f"{cfg.frontend_dim}" if enc else ""))
        cut = ("" if depth is None else
               f"; depth cut from {base.n_layers} layers to {depth} (the "
               f"model does not fit one card)")
        log(f"family serve: {cfg.name} ({cfg.family}; {cfg.n_layers} "
            f"layer{'s' if cfg.n_layers > 1 else ''}"
            f"{f' + {enc} encoder layers' if enc else ''}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, "
            f"hd {cfg.hd}, d_ff {cfg.d_ff}"
            + (f", {cfg.n_experts} experts top-{cfg.top_k}"
               + (f", dense residual {cfg.moe_dense_ff}"
                  if cfg.moe_dense_ff else "") if cfg.n_experts else "")
            + f", vocab {cfg.vocab_size}{cut}); {cfg.param_count() / 1e9:.3f}"
              f" B parameters, weights {weights / 1e9:.3f} GB bf16, drawn "
              f"in {init_s:.2f} s at a peak of {init_peak / 1e9:.3f} GB; "
              f"{shape}, {FAMILY_DECODE} decode steps [{card}]")
        # a process's first prefill of a config pays one-off costs (the
        # products' first shapes, lazy module loads): time it apart
        cold = {}
        for impl in ("cuda", "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(cfg, params, batch, init_cache(
                cfg, FAMILY_SLOTS, fe + batch["tokens"].shape[1]), impl=impl)
            torch.cuda.synchronize()
            cold[impl] = 1e3 * (time.perf_counter() - t0)
        log(f"family serve {cfg.name}: first prefill {cold['cuda']:.2f} ms "
            f"(kernels), {cold['torch']:.2f} ms (plain), apart from the runs "
            f"below "
            f"[{card}]")
        cu = family_run(torch, cfg, params, batch, fe, "cuda", keep=keep)
        pl = family_run(torch, cfg, params, batch, fe, "torch",
                        feed=cu["picks"],
                        force=cu["routes"] if cfg.n_experts else None)
        for name, r in (("cuda", cu), ("torch", pl)):
            toks = FAMILY_SLOTS * (1 + FAMILY_DECODE)
            log(f"family serve {cfg.name} {name}: {r['wall']:.2f} s wall, "
                f"{toks} tokens, {toks / r['wall']:.1f} tok/s; prefill "
                f"{r['prefill_ms']:.2f} ms, decode ms a step mean "
                f"{np.mean(r['decode_ms']):.3f} (min {min(r['decode_ms']):.3f},"
                f" max {max(r['decode_ms']):.3f}); launches "
                f"flash_attention {r['launches']['flash_attention']} "
                f"selective_scan {r['launches']['selective_scan']} "
                f"mamba_scan {r['launches']['mamba_scan']}; peak device "
                f"memory {r['peak'] / 1e9:.3f} GB [{card}]")
            check(bool(torch.isfinite(r["logits"]).all())
                  and all(bool(torch.isfinite(x).all())
                          for x in r["decode_logits"]),
                  f"family serve {cfg.name} {name}: non-finite logits")
        route = fa_ops._route(cfg.dtype, cfg.hd)
        for key, want in (("flash_attention", n_attn),
                          (f"flash_attention_{route}", n_attn),
                          ("selective_scan", 0), ("mamba_scan", 0)):
            check(cu["launches"][key] == want,
                  f"family serve {cfg.name}: {key} launched "
                  f"{cu['launches'][key]} times, not {want} (one an "
                  f"attention call of the prefill, none in decode)")
            check(pl["launches"][key] == 0,
                  f"family serve {cfg.name}: the plain run launched {key}")
        diff = float((cu["logits"] - pl["logits"]).abs().max())
        dec = max(float((a - b).abs().max())
                  for a, b in zip(cu["decode_logits"], pl["decode_logits"]))
        same = sum(int((a == b).sum()) for a, b in zip(cu["picks"],
                                                         pl["picks"]))
        total = FAMILY_SLOTS * len(cu["picks"])
        top = float(pl["logits"].abs().max())
        msg = (f"family serve {cfg.name}: prefill logits kernels vs plain "
               f"max abs diff {diff:.6g} (bar {bar}; largest |logit| "
               f"{top:.4g}); decode logits {dec:.6g} (the plain run fed the "
               f"kernel run's tokens); greedy picks equal {same} of {total}")
        if cfg.n_experts:
            rt = routing_numbers(cu, pl, cfg.n_layers)
            d_pre, n_pre = rt["prefill_dropped"]
            d_dec, n_dec = rt["decode_dropped"]
            f_pre, t_pre = rt["prefill_differ"]
            f_dec, t_dec = rt["decode_differ"]
            msg += (f"; MoE capacity {rt['capacity']} a prefill expert (factor "
                    f"{cfg.capacity_factor}), prefill dropped {d_pre} of "
                    f"{n_pre} assignments ({d_pre / n_pre:.4f}; by layer "
                    f"{rt['by_layer']}), decode "
                    f"dropped {d_dec} of {n_dec}; (token, layer) top-k sets "
                    f"of the plain run's own router that differ from the "
                    f"kernel run's: prefill {f_pre} of {t_pre} "
                    f"({f_pre / t_pre:.6f}), decode {f_dec} of {t_dec} "
                    f"({f_dec / max(t_dec, 1):.6f}); the plain run "
                    f"dispatched the kernel run's")
            check(d_dec == 0, f"family serve {cfg.name}: decode dropped "
                              f"{d_dec} assignments")
        log(msg)
        check(diff <= bar, f"family serve {cfg.name}: prefill logits {diff} "
                           f"from the plain path")
        # the served prefill's own attention inputs against the plain
        # version, timed beside SDPA and the bound
        kept = cu["kept"]["flash_attention"]
        check(set(kept) == set(keep["flash_attention"]),
              f"family serve {cfg.name}: kernel inputs not kept")
        loader = fa_ops._loader(cfg.hd)
        for i in keep["flash_attention"]:
            (q, k, v), kw = kept[i]
            kw = {key: kw[key] for key in ("causal", "window")}
            out = fa_ops.flash_attention(q, k, v, impl="cuda", **kw)
            label = f"{cfg.name} served {names[i]}"
            r = attention_numbers(torch, label, q, k, v, kw, out, route,
                                  loader)
            cases.append(("flash_attention",
                          f"{label} (B {q.shape[0]} nh {q.shape[1]} nkv "
                          f"{k.shape[1]} hd {q.shape[3]} T {q.shape[2]} S "
                          f"{k.shape[2]} bf16 causal {kw['causal']}{cut})",
                          cu["launches"]["flash_attention"], r))
        del params, cu, pl, kept, batch
        torch.cuda.empty_cache()
        log(f"family serve {cfg.name}: {time.perf_counter() - t_cfg:.2f} s "
            f"wall [{card}]")
    # the launch command, as a user runs it, on the card
    for arch in ("olmoe-1b-7b", "phi-3-vision-4.2b"):
        launch_serve(arch, card)
    log(f"family serve phase: {time.perf_counter() - t_phase:.2f} s")
    return cases


#: The train phase: hymba_1_5b at its published widths and depth (remat
#: on, as its config says), bf16, AdamW (``parallel.plan_for``'s
#: single-card plan), seeded weights; batches of TRAIN_BATCH x TRAIN_SEQ
#: tokens (T twice the 1,024 window) from ``SyntheticCorpus`` through
#: ``TokenPipeline`` on ``launch.train.make_store()``; one untimed step,
#: then TRAIN_STEPS timed ones.
TRAIN_ARCH = "hymba_1_5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
#: The float32 comparison's depth: layer 0 (global) and three windowed.
TRAIN_F32_LAYERS = 4
#: One step on the kernel route against the same step on the plain route
#: from the same state: (relative difference of the loss, the largest
#: per-leaf relative L2 difference of the gradients). float32: the
#: attention kernel is within 2e-5 and the scan within 1e-4 of the plain
#: versions, and the backward is the plain one. bfloat16: every
#: activation rounds to bf16 and the embedding's backward accumulates
#: with atomics; set from the first two runs on the card (PERF.md §2:
#: loss 4.18e-6 and 1.32e-5 apart, the worst leaf 0.042 and 0.0851, a
#: layer's SSM projection), with a margin of three.
TRAIN_BARS = {"float32": (1e-4, 1e-3), "bfloat16": (1e-4, 0.25)}
#: The loss of the step after a restore against the same step before the
#: save (the restored state is bitwise the saved one; the forward has no
#: atomics).
TRAIN_RESUME_RTOL = 1e-6
#: Kernel calls of the first step whose inputs the phase keeps: layer 0
#: (global) and layer 1 (window) attention, layer 0's scan.
TRAIN_KEEP = {"flash_attention": (0, 1), "selective_scan": (0,)}


def grad_gap(torch, got, want):
    """The largest per-leaf relative L2 difference ``|got - want| /
    |want|`` (float32) and its leaf's name."""
    from repro_torch.models.convert import tree_leaves, tree_paths

    worst, where = 0.0, ""
    for path, g, w in zip(tree_paths(want), tree_leaves(got),
                          tree_leaves(want)):
        num = float((g.float() - w.float()).norm())
        den = float(w.float().norm())
        r = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
        if r > worst:
            worst, where = r, "/".join(map(str, path))
    return worst, where


def trace_kernels(torch, fn):
    """``(name, device ms, calls)`` of every kernel, copy and memset one
    call of ``fn`` runs, from ``torch.profiler``'s own Chrome trace of the
    device's activity (written under ``build/``, read, removed): a train
    step launches some 360,000 kernels, which the profiler's per-event
    Python processing takes minutes over."""
    import os

    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "build" / f"trace_{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    agg = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            ms, n = agg.get(e["name"], (0.0, 0))
            agg[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return [(name, ms, n) for name, (ms, n) in agg.items()]


def route_run(torch, cfg, params, batch, impl: str, trace: bool = False):
    """``value_and_grad`` on one route (``impl``), the launch counts set
    to 0 just before and read just after: its loss, gradients, host
    seconds, launches and, with ``trace``, its device kernels
    (:func:`trace_kernels`) and its ms by CUDA events."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.train.train_step import value_and_grad

    fa_ops.reset_launch_counts()
    ms_ops.reset_launch_counts()
    out = {}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        out["vg"] = value_and_grad(cfg, params, batch, impl)
        stop.record()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernels = trace_kernels(torch, run) if trace else run()
    torch.cuda.synchronize()
    loss, _, grads = out["vg"]
    return dict(loss=float(loss), grads=grads, s=time.perf_counter() - t0,
                ms=start.elapsed_time(stop), kernels=kernels,
                attention=fa_ops.launch_counts()["flash_attention"],
                scan=ms_ops.launch_counts())


def compare_routes(torch, cfg, cu: dict, pl: dict, what: str, card: str):
    """The kernel route's run ``cu`` against the plain route's ``pl``
    (:func:`route_run`, one step from the same state and batch): each
    kernel launched twice a layer on the kernel route (the forward and
    remat's recompute) and never on the plain one; the loss's relative
    difference and the gradients' largest per-leaf relative L2 difference
    held to ``TRAIN_BARS``."""
    dt_name = str(cfg.dtype).removeprefix("torch.")
    want = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    check(cu["attention"] == cu["scan"]["selective_scan"] == want
          and cu["scan"]["mamba_scan"] == 0,
          f"train {what}: kernel route launched attention "
          f"{cu['attention']} and the scan {cu['scan']} times, not {want} "
          f"each")
    check(pl["attention"] == pl["scan"]["selective_scan"]
          == pl["scan"]["mamba_scan"] == 0,
          f"train {what}: the plain route launched a kernel")
    loss_gap = abs(cu["loss"] - pl["loss"]) / abs(pl["loss"])
    g_gap, where = grad_gap(torch, cu["grads"], pl["grads"])
    loss_bar, g_bar = TRAIN_BARS[dt_name]
    log(f"train {what}: kernel route vs plain route, one step from the "
        f"same state: loss {cu['loss']:.6f} vs {pl['loss']:.6f} (relative "
        f"{loss_gap:.3g}, bar {loss_bar}); gradients' largest per-leaf "
        f"relative L2 {g_gap:.3g} at {where} (bar {g_bar}); launches "
        f"attention {cu['attention']} scan {cu['scan']['selective_scan']} "
        f"(plain 0); host s kernel route {cu['s']:.2f}, plain route "
        f"{pl['s']:.2f} [{card}]")
    check(loss_gap <= loss_bar and g_gap <= g_bar,
          f"train {what}: kernel and plain routes differ beyond the bars")


def train_phase(torch, card: str):
    """hymba_1_5b trained at full width and depth on the attention and
    scan kernels (see the module notes). Returns the kernels line's cases:
    the train step's windowed attention and scan, with their launches
    over the timed steps."""
    import shutil

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus, TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    from repro_torch.launch.train import make_store
    from repro_torch.models import init_params
    from repro_torch.parallel import plan_for
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_train_state, make_train_step

    t_phase = time.perf_counter()

    def lap(what: str) -> None:
        log(f"train phase: {what} at {time.perf_counter() - t_phase:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    plan = plan_for(cfg)
    L = cfg.n_layers
    check(cfg.remat and cfg.dtype == torch.bfloat16 and plan.optimizer ==
          "adamw", f"train: {cfg.name}'s config or plan changed")
    params, opt_state = init_train_state(
        cfg, plan, torch.Generator(device="cuda").manual_seed(3131), "cuda")
    w_bytes, o_bytes = tree_bytes(params), tree_bytes(opt_state)
    step_fn = make_train_step(cfg, plan, impl="cuda")
    opt = make_optimizer(plan.optimizer)
    corpus = SyntheticCorpus(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                             n_shards=4 * (TRAIN_STEPS + 4))
    pipe = TokenPipeline(corpus, store=make_store(), epochs=1)

    def next_batch(p=pipe):
        return {k: torch.from_numpy(v).cuda() for k, v in next(p).items()}

    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train: {cfg.name} ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads on {cfg.n_kv_heads}, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.sliding_window}, "
        f"global layers {cfg.global_layers}, state {cfg.ssm_state}, "
        f"remat {cfg.remat}; {cfg.param_count() / 1e9:.3f} B parameters), "
        f"bf16, {plan.optimizer}, {plan.microbatches} microbatch, batches "
        f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens; weights "
        f"{w_bytes / 1e9:.3f} GB, optimizer state {o_bytes / 1e9:.3f} GB "
        f"[{card}]")
    # step 1, untimed, keeping layers 0 and 1's attention and layer 0's
    # scan inputs
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with served_kernel_inputs(TRAIN_KEEP) as kept:
        params, opt_state, m = step_fn(params, opt_state, next_batch())
        metrics.append({k: float(v) for k, v in m.items()})
    first_s = time.perf_counter() - t0
    # steps 2..4 timed, the counts set to 0 just before; the state after
    # step 2 saved asynchronously (and waited for before step 3)
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt = CheckpointManager(str(ckdir), keep=1)
    fa_ops.reset_launch_counts()
    ms_ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(TRAIN_STEPS):
        batch = next_batch()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step_fn(params, opt_state, batch)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            t0 = time.perf_counter()
            ckpt.save_async(2, params, opt_state,
                            extra={"pipeline": pipe.state()})
            snap_s = time.perf_counter() - t0
            ckpt.wait()
            write_s = time.perf_counter() - t0 - snap_s
    launches = {**fa_ops.launch_counts(), **ms_ops.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    for n, m in enumerate(metrics, 1):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"train: step {n} loss {m['loss']} grad norm {m['grad_norm']}")
    want = TRAIN_STEPS * 2 * L
    for key in ("flash_attention", "flash_attention_wgmma",
                "selective_scan"):
        check(launches[key] == want,
              f"train: {key} launched {launches[key]} times in "
              f"{TRAIN_STEPS} steps, not {want} (2 a layer a step: the "
              f"forward and remat's recompute)")
    check(launches["mamba_scan"] == 0, "train: mamba_scan launched")
    mean_ms = float(np.mean(step_ms))
    log(f"train: first step {first_s:.2f} s (untimed); steps "
        f"{TRAIN_STEPS} timed: ms {[round(x, 2) for x in step_ms]}, mean "
        f"{mean_ms:.2f} ms, {tokens / (mean_ms / 1e3):.1f} tokens/s; loss "
        f"by step {[round(m['loss'], 5) for m in metrics]}, grad norm "
        f"{[round(m['grad_norm'], 4) for m in metrics]}; launches "
        f"attention {launches['flash_attention']} scan "
        f"{launches['selective_scan']} mamba_scan 0; peak device memory "
        f"{peak / 1e9:.3f} GB (weights {w_bytes / 1e9:.3f}, optimizer "
        f"{o_bytes / 1e9:.3f}); checkpoint after step 2: host snapshot "
        f"{snap_s:.2f} s, write {write_s:.2f} s, "
        f"{sum(f.stat().st_size for f in ckdir.rglob('*.npy')) / 1e9:.3f} "
        f"GB [{card}]")
    lap("timed steps")

    # step 5 profiled (the device's activity) in its two halves as
    # make_train_step runs them: the kernel route's loss and gradients,
    # then the optimizer's update; the plain backward of one global and
    # one windowed attention layer and of one scan layer profiled alone at
    # the step's kept inputs, counted per layer
    batch = next_batch()
    cu = route_run(torch, cfg, params, batch, "cuda", trace=True)
    upd = {}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def update():
        start.record()
        upd["out"] = opt.update(cu["grads"], opt_state, params)
        stop.record()

    opt_k = trace_kernels(torch, update)
    del upd
    wall = cu["ms"] + start.elapsed_time(stop)
    groups = kernel_groups(cu["kernels"] + opt_k)
    busy = sum(groups.values())
    n_kernels = sum(n for _, _, n in cu["kernels"] + opt_k)
    lap("profiled step")

    def alone(fn):
        g = kernel_groups(trace_kernels(torch, fn))
        return sum(g.values()), g["matmul"]

    def detached(args, grad: bool):
        return [a.detach().requires_grad_(grad) for a in args]

    (q0, k0, v0), kw0 = kept["flash_attention"][0]
    (q1, k1, v1), kw1 = kept["flash_attention"][1]
    u_args, _ = kept["selective_scan"][0]
    n_global = sum(cfg.layer_globals())
    regions = {}
    for name, args, fwd, n_calls in (
            ("attention plain backward, global",
             (q0, k0, v0), lambda *a: fa_ref.attention(
                 *a, causal=True, window=kw0["window"]), n_global),
            ("attention plain backward, window",
             (q1, k1, v1), lambda *a: fa_ref.attention(
                 *a, causal=True, window=kw1["window"]), L - n_global),
            ("scan plain backward", u_args,
             lambda *a: ms_ref.selective_scan(*a, return_state=True)[0], L)):
        ins = detached(args, True)
        gy = torch.randn_like(fwd(*detached(args, False)).float())
        fn = lambda f=fwd, x=ins, g=gy: torch.autograd.grad(  # noqa: E731
            f(*x).float(), x, g)
        regions[name] = (*alone(fn), n_calls)
    regions["optimizer"] = (sum(ms for _, ms, _ in opt_k),
                            kernel_groups(opt_k)["matmul"], 1)
    in_regions = sum(ms * n for ms, _, n in regions.values())
    mm_else = max(0.0, groups["matmul"]
                  - sum(mm * n for _, mm, n in regions.values()))
    rest = max(0.0, busy - groups["attention"] - groups["scan"] - in_regions
               - mm_else)
    log(f"train profiled step (device activity; {n_kernels} kernels): "
        f"{wall:.2f} ms by events ({cu['ms']:.2f} loss and gradients, "
        f"{wall - cu['ms']:.2f} the update), device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall:.4f}; by kernel name: "
        + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()) + f" [{card}]")
    for name, (ms, mm, n) in regions.items():
        log(f"  {name}: {ms:.3f} device ms a call ({mm:.3f} of it "
            f"matrix products) x {n} a step = {ms * n:.2f} ms [{card}]")
    log(f"train step device ms by group: attention kernel "
        f"{groups['attention']:.2f}, scan kernel {groups['scan']:.2f}, "
        + ", ".join(f"{name} {ms * n:.2f}"
                    for name, (ms, _, n) in regions.items())
        + f", matrix products elsewhere {mm_else:.2f}, the rest "
          f"{rest:.2f}; idle share {1 - busy / wall:.4f} [{card}]")

    # the plain route from the same state and batch (bf16, full depth)
    compare_routes(torch, cfg, cu, route_run(torch, cfg, params, batch,
                                             "torch"),
                   f"bf16, {L} layers", card)
    lap("bf16 comparison")

    # the kernels line's cases: layer 1's attention and layer 0's scan at
    # the step's inputs, against the plain versions and timed
    cases = []
    q, k, v = detached((q1, k1, v1), False)
    kwd = {key: kw1[key] for key in ("causal", "window")}
    out = fa_ops.flash_attention(q, k, v, impl="cuda", **kwd)
    r = attention_numbers(torch, "train step layer 1 bf16", q, k, v, kwd,
                          out, "wgmma", fa_ops._loader(cfg.hd))
    cases.append(("flash_attention",
                  f"{cfg.name} train step layer 1 (window {kwd['window']}; B "
                  f"{q.shape[0]} nh {q.shape[1]} nkv {k.shape[1]} hd "
                  f"{q.shape[3]} T=S {q.shape[2]} bf16; forward and remat "
                  f"recompute, {TRAIN_STEPS} steps)",
                  launches["flash_attention"], r))
    sargs = detached(u_args, False)
    y, h = ms_ops.selective_scan(*sargs, return_state=True, impl="cuda")
    r = scan_numbers(torch, "train step layer 0", "selective_scan", sargs,
                     y, h)
    u = sargs[0]
    cases.append(("selective_scan",
                  f"{cfg.name} train step layer 0 (B {u.shape[0]} T "
                  f"{u.shape[1]} D {u.shape[2]} N {sargs[2].shape[1]}, bf16 "
                  f"u, B and C, final state; forward and remat recompute, "
                  f"{TRAIN_STEPS} steps)", launches["selective_scan"], r))
    del kept, q0, k0, v0, q1, k1, v1, u_args, q, k, v, out, sargs, y, h
    del params, opt_state, batch, cu
    torch.cuda.empty_cache()
    lap("kernel cases")

    # restore the state after step 2 into a fresh state; step 3 again
    t0 = time.perf_counter()
    fresh = init_train_state(cfg, plan, torch.Generator(device="cuda")
                             .manual_seed(7), "cuda")
    restored, at, extra = ckpt.restore({"params": fresh[0],
                                        "opt": fresh[1]})
    del fresh
    restore_s = time.perf_counter() - t0
    pipe2 = TokenPipeline(corpus, store=make_store(), epochs=1)
    pipe2.restore(extra["pipeline"])
    _, _, m = step_fn(restored["params"], restored["opt"], next_batch(pipe2))
    again = float(m["loss"])
    gap = abs(again - metrics[2]["loss"]) / abs(metrics[2]["loss"])
    log(f"train checkpoint: restored step {at} into a fresh state in "
        f"{restore_s:.2f} s; step 3 again: loss {again:.6f} vs "
        f"{metrics[2]['loss']:.6f} (relative {gap:.3g}, bar "
        f"{TRAIN_RESUME_RTOL}) [{card}]")
    check(at == 2 and gap <= TRAIN_RESUME_RTOL,
          "train: the step after a restore differs from the step after "
          "the save")
    del restored, m
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    lap("restore")

    # float32 at full width, the depth cut to TRAIN_F32_LAYERS
    f32 = cfg.replace(dtype=torch.float32, n_layers=TRAIN_F32_LAYERS)
    p32 = init_params(f32, torch.Generator(device="cuda").manual_seed(3232),
                      "cuda")
    batch = next_batch()
    compare_routes(torch, f32, route_run(torch, f32, p32, batch, "cuda"),
                   route_run(torch, f32, p32, batch, "torch"),
                   f"float32, {TRAIN_F32_LAYERS} layers (layer 0 global)",
                   card)
    del p32, batch
    torch.cuda.empty_cache()
    log(f"train store: {pipe.store.stats}, data wait "
        f"{pipe.prefetcher.total_wait_s:.3f} s simulated")
    log(f"train phase: {time.perf_counter() - t_phase:.2f} s")
    return cases


#: The dry run's cells on the 16x16 fake backend (``launch.dryrun``), each
#: at full width and depth.
MESH_DRYRUN = (("qwen3_4b", "train_4k"), ("arctic_480b", "train_4k"),
               ("olmoe_1b_7b", "prefill_32k"), ("hymba_1_5b", "long_500k"))
#: The world-size-1 mesh path: olmoe_1b_7b's prefill at full width and
#: depth (one FAMILY_SERVE wave) and one hymba_1_5b train step at full
#: width and MESH_TRAIN_LAYERS layers, bf16.
MESH_PREFILL_ARCH = "olmoe_1b_7b"
MESH_TRAIN_LAYERS = 4
CARD_GB = 80.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_dryrun(card: str) -> None:
    """(a) The dry run's cells (``MESH_DRYRUN``) traced on the 16x16 fake
    backend with fake ``cuda`` tensors: each must end ``ok``; prints its
    trace seconds, one rank's argument and peak GB beside the card's 80
    GB, FLOPs, wire bytes by kind and roofline terms."""
    from repro_torch.launch import dryrun

    for arch, shape in MESH_DRYRUN:
        rec = dryrun.run_cell(arch, shape, False)
        log(f"mesh dry run: {dryrun.summary(rec)} (one rank of 256; the "
            f"card holds {CARD_GB:g} GB) [{card}]")
        check(rec["status"] == "ok",
              f"mesh dry run: {arch} {shape} ended {rec['status']}: "
              f"{rec.get('traceback', rec.get('error'))}")
        mem, rl = rec["memory"], rec["roofline"]
        log(f"  {arch} {shape}: plan {rec['plan']}; memory (bytes, one "
            f"rank) {mem}; kernels {rec['kernels']}; bytes accessed "
            f"{rec['cost']['bytes_accessed']:.4e}; collectives "
            f"{rec['collectives']['count']}; roofline {rl}")


def mesh_counts(fa_ops, ms_ops) -> dict:
    """Launches since the last reset by the kernels line's row key
    (:func:`row_key`)."""
    fa, ms = fa_ops.launch_counts(), ms_ops.launch_counts()
    threads = fa["flash_attention_wgmma_threads"]
    return {"flash_attention/tf32x3": fa["flash_attention_tf32x3"],
            "flash_attention/wgmma/tma": fa["flash_attention_wgmma"] - threads,
            "flash_attention/wgmma/threads": threads,
            "selective_scan": ms["selective_scan"],
            "mamba_scan": ms["mamba_scan"]}


def row_key(row: dict) -> str:
    """Which kernel a row of the kernels line times: its name, and for
    attention its variant and the wgmma kernel's loader."""
    if row["name"] != "flash_attention":
        return row["name"]
    if row["variant"] == "wgmma":
        return f"flash_attention/wgmma/{row['loader']}"
    return f"flash_attention/{row['variant']}"


def attach_mesh_launches(kernels: list, mesh_launches: dict) -> None:
    """Each mesh run's launches onto the rows of the same kernel at the
    same shapes, as ``launches_mesh_<run>``; fails if a kernel the run
    launched has no such row."""
    for run, (case, counts) in mesh_launches.items():
        for key, n in counts.items():
            rows = [k for k in kernels
                    if k["case"].startswith(case) and row_key(k) == key]
            check(n == 0 or rows, f"mesh {run}: {key} launched {n} times "
                                  f"and no row has its shapes")
            for k in rows:
                k[f"launches_mesh_{run}"] = n


def mesh_world_one(torch, card: str) -> dict:
    """(b) The mesh path on a one-rank NCCL ``DeviceMesh`` of the card with
    real DTensors, through the kernels on the ``cuda`` route: olmoe's
    prefill against the no-mesh path, logits bitwise or within
    ``SERVE_LOGIT_BARS``; one hymba train step's loss and gradients
    against PR 31's route from one state, bitwise or within
    ``TRAIN_BARS``. Returns each run's launches (:func:`mesh_counts`) with
    the start of the case of the kernels line's rows at the same shapes:
    ``{"prefill": (case, counts), "train": (case, counts)}``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.parallel import plan_for
    from repro_torch.parallel.ctx import sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings,
        cache_shardings,
        param_shardings,
        shard_tree,
    )
    from repro_torch.models.convert import tree_leaves, tree_map
    from repro_torch.serve.engine import make_prefill_step
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (
        make_train_step,
        shard_state,
        value_and_grad,
    )

    launches = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        # olmoe prefill, full width and depth, bf16
        cfg = get_config(MESH_PREFILL_ARCH).replace(dtype=torch.bfloat16)
        prompt = next(p for a, _, p, _ in FAMILY_SERVE
                      if a == MESH_PREFILL_ARCH)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(3232), "cuda")
        batch, _ = family_batch(torch, cfg, prompt, None, 3232)
        B, T = batch["tokens"].shape
        cache = init_cache(cfg, B, T + 8, "cuda")
        want, _ = prefill(cfg, params, batch, cache, impl="cuda")
        plan = plan_for(cfg, "prefill_32k", mesh)
        pd = shard_tree(params, mesh, param_shardings(mesh, plan, params))
        del params
        bd = shard_tree(batch, mesh, batch_shardings(mesh, batch))
        cd = shard_tree(cache, mesh, cache_shardings(mesh, plan, cfg, cache))
        del cache
        step = make_prefill_step(cfg, "cuda", mesh=mesh,
                                 moe_local_dispatch=plan.moe_local_dispatch,
                                 no_ep=plan.no_ep)
        torch.cuda.synchronize()
        fa_ops.reset_launch_counts()
        ms_ops.reset_launch_counts()
        t0 = time.perf_counter()
        got, _ = step(pd, bd, cd)
        got = got.full_tensor()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_attn = fa_ops.launch_counts()["flash_attention"]
        # the family serve phase's olmoe row has these shapes (one wave)
        launches["prefill"] = (f"{cfg.name} served layer 0 (",
                               mesh_counts(fa_ops, ms_ops))
        diff = float((got.float() - want.float()).abs().max())
        bar = SERVE_LOGIT_BARS["bfloat16"]
        log(f"mesh world 1: {cfg.name} prefill on a 1x1 DeviceMesh (DTensor "
            f"weights, batch and cache; plan {plan}), {B} x {T} tokens, "
            f"{wall:.2f} s: logits {'bitwise' if torch.equal(got, want) else f'max |diff| {diff:.6g} (bar {bar})'} "
            f"against the no-mesh prefill; flash_attention launched {n_attn} "
            f"times on the cuda route [{card}]")
        check(n_attn == cfg.n_layers,
              f"mesh world 1: attention launched {n_attn} times, not "
              f"{cfg.n_layers}")
        check(torch.equal(got, want) or diff <= bar,
              f"mesh world 1: prefill logits differ by {diff}")
        del pd, bd, cd, got, want
        torch.cuda.empty_cache()

        # one hymba train step, full width, MESH_TRAIN_LAYERS layers, bf16
        cfg = get_config(TRAIN_ARCH).replace(n_layers=MESH_TRAIN_LAYERS)
        plan = plan_for(cfg)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(3233), "cuda")
        gen = torch.Generator().manual_seed(3233)
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                             generator=gen).cuda()
        batch = {"tokens": toks[:, :-1].int().contiguous(),
                 "labels": toks[:, 1:].int().contiguous()}
        pl = route_run(torch, cfg, params, batch, "cuda")
        pd = shard_tree(params, mesh, param_shardings(mesh, plan, params))
        bd = shard_tree(batch, mesh, batch_shardings(mesh, batch))
        fa_ops.reset_launch_counts()
        ms_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sharding_ctx(mesh):
            loss, _, gd = value_and_grad(cfg, pd, bd, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_attn = fa_ops.launch_counts()["flash_attention"]
        n_scan = ms_ops.launch_counts()["selective_scan"]
        # the train phase's rows have these shapes (the batch, the sequence)
        launches["train"] = (f"{cfg.name} train step layer ",
                             mesh_counts(fa_ops, ms_ops))
        loss_f = float(loss.full_tensor())
        full = tree_map(lambda g: g.full_tensor(), gd)
        del gd
        bitwise = loss_f == pl["loss"] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                              tree_leaves(pl["grads"])))
        loss_gap = abs(loss_f - pl["loss"]) / abs(pl["loss"])
        g_gap, where = grad_gap(torch, full, pl["grads"])
        loss_bar, g_bar = TRAIN_BARS["bfloat16"]
        want_launch = 2 * cfg.n_layers  # the forward and remat's recompute
        log(f"mesh world 1: {cfg.name} ({cfg.n_layers} layers, full width) "
            f"value_and_grad on the 1x1 mesh, {TRAIN_BATCH} x {TRAIN_SEQ} "
            f"tokens, {wall:.2f} s: "
            + ("loss and every gradient leaf bitwise" if bitwise else
               f"loss {loss_f:.6f} vs {pl['loss']:.6f} (relative "
               f"{loss_gap:.3g}, bar {loss_bar}), gradients' largest "
               f"per-leaf relative L2 {g_gap:.3g} at {where} (bar {g_bar})")
            + f" against PR 31's route; launches attention {n_attn}, "
              f"selective_scan {n_scan} (want {want_launch} each) [{card}]")
        check(n_attn == n_scan == want_launch,
              f"mesh world 1: train launches attention {n_attn} scan "
              f"{n_scan}, not {want_launch}")
        check(bitwise or (loss_gap <= loss_bar and g_gap <= g_bar),
              "mesh world 1: the train step's loss or gradients beyond "
              "the bars")
        opt_step = make_train_step(cfg, plan, impl="cuda", mesh=mesh)
        pd, od = shard_state(params, make_optimizer(plan.optimizer)
                             .init(params), mesh, plan)
        _, _, m = opt_step(pd, od, bd)
        step_loss = float(m["loss"].full_tensor())
        log(f"mesh world 1: make_train_step(mesh=...) one step, loss "
            f"{step_loss:.6f} (value_and_grad's {loss_f:.6f})")
        check(np.isfinite(step_loss), "mesh world 1: train step loss")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def mesh_phase(torch, card: str, specs, sweep_result) -> dict:
    """The mesh phase: (a) the dry run, (b) the world-size-1 mesh path,
    (c) ``run_sweep(..., shard=True)`` over the lane mesh of the visible
    cards on the sweep's grid, bitwise to the sweep phase's results.
    Returns (b)'s launches."""
    from repro_torch.kernels.lane_tick import ops
    from repro_torch.parallel.sharding import lane_mesh
    from repro_torch.sim.sweep import run_sweep

    t_phase = time.perf_counter()
    mesh_dryrun(card)
    t_a = time.perf_counter() - t_phase
    launches = mesh_world_one(torch, card)
    t_b = time.perf_counter() - t_phase - t_a
    lanes = lane_mesh()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_sweep(specs, tick=10.0, tick_impl="cuda", device="cuda",
                    shard=True)
    wall = time.perf_counter() - t0
    n = same_results(res, sweep_result, "mesh shard=True sweep")
    counted = ops.launch_counts()
    log(f"mesh sweep: run_sweep(shard=True) over the lane mesh of "
        f"{lanes.size} card(s) ({[str(d) for d in lanes.devices]}), "
        f"{len(specs)} specs in {wall:.2f} s: {n} results bitwise to the "
        f"sweep phase's; lane-tick launches {counted} [{card}]")
    check(all(v > 0 for v in counted.values()),
          "mesh sweep: a lane-tick kernel was not launched")
    log(f"mesh phase: dry run {t_a:.1f} s, world 1 {t_b:.1f} s, sweep "
        f"{wall:.1f} s, whole phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def launch_serve(arch: str, card: str) -> None:
    """``python -m repro_torch.launch.serve --arch <arch>`` as a
    subprocess, as a user runs it: exit 0 and its tok/s line."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", arch], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"serve launch: python -m repro_torch.launch.serve --arch {arch}:"
        f" exit {proc.returncode}, {time.perf_counter() - t0:.2f} s wall: "
        f"{line} [{card}]")
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
    check(proc.returncode == 0 and "tok/s" in line,
          f"serve launch {arch}: the command failed or printed no tok/s line")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--days", type=float, default=1.0,
                    help="simulated horizon of the sweep phase (default 1)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: this run needs a GPU")
    try:
        from repro_torch.core.scenarios import pack_specs
        from repro_torch.kernels import _build
        from repro_torch.kernels.lane_tick import ops
        from repro_torch.kernels.tick_glue import ops as glue_ops
        from repro_torch.sim.batched import run_sweep_torch, simulate_packed
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable beside this script "
                           f"({e})") from None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for lib in secs:
        for kname, u in _build.ptxas_usage(lib).items():
            log(f"  ptxas {lib}/{kname}: {u.get('registers')} registers, "
                f"spill {u.get('spill_stores')}/{u.get('spill_loads')} B "
                f"stores/loads")
        for w in _build.ptxas_warnings(lib):
            log(f"  ptxas {lib}: {w}")

    served = serve_phase(torch, card)
    torch.cuda.empty_cache()  # the phase's weights and activations
    served += family_serve_phase(torch, card)
    torch.cuda.empty_cache()
    served += train_phase(torch, card)

    days, n_files = args.days, 1_000_000
    specs = pricing_specs(days, n_files)
    t0 = time.perf_counter()
    grid = pack_specs(specs, tick=10.0)
    log(f"pack: {time.perf_counter() - t0:.1f} s; {grid.n_specs} specs, "
        f"{grid.n_lanes} lanes, {len(grid.site_names)} sites x {n_files} "
        f"files, K={grid.max_jobs_per_tick}, T={grid.n_ticks} ticks")
    kern = kernel_phase(torch, grid, grid.n_lanes)
    glue, glue_tick = glue_phase(torch, grid)

    # -- small reference: CPU plain path against the card's kernels
    small = pricing_specs(0.1, 1000)
    cpu = run_sweep_torch(small, tick=60.0, tick_impl="torch", device="cpu")
    gpu = run_sweep_torch(small, tick=60.0, tick_impl="cuda", device="cuda")
    log(f"small reference: {lane_parity(cpu, gpu)} specs within the "
        f"Table-2 bar (CPU plain vs card kernels)")

    # -- sweep phase (the main path: run_sweep_torch, whose cuda tick
    # replays a CUDA graph), then the plain path against it on a shorter
    # horizon, then the cuda path replayed and eager on the packed grid,
    # bitwise to each other
    log(f"sweep: horizon cut from the paper's 90 days to {days:g} days "
        f"({grid.n_ticks} ticks of 10 s); catalogue {n_files} files/site")
    runs = {}
    parity_specs = pricing_specs(min(days, PARITY_DAYS), n_files)
    for impl, run_specs in (("cuda", specs), ("parity cuda", parity_specs),
                            ("parity torch", parity_specs)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        glue_ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_sweep_torch(run_specs, tick=10.0,
                              tick_impl=impl.split()[-1], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {**ops.launch_counts(), **glue_ops.launch_counts()}
        runs[impl] = res
        n_ticks = res.results[0].events  # the batched program's ticks
        log(f"sweep {impl}{' (captured)' if impl == 'cuda' else ''}: "
            f"{run_specs[0].days:g} days, {wall:.2f} s wall, "
            f"{n_ticks / wall:.1f} ticks/s, {len(res) / wall:.2f} "
            f"configs/s, launches {launched}")
        if impl == "cuda":
            counts = launched
    check(counts == {name: grid.n_ticks
                     for name in ops.KERNELS + glue_ops.KERNELS},
          f"main path launches {counts}, not one of each kernel in each of "
          f"{grid.n_ticks} ticks")
    n_ok = lane_parity(runs["parity torch"], runs["parity cuda"])
    log(f"sweep parity ({parity_specs[0].days:g} days): {n_ok} specs within "
        f"the Table-2 bar, jobs submitted equal")
    outs = {}
    for eager in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[eager] = simulate_packed(grid, tick_impl="cuda", device="cuda",
                                      _eager=eager)
        wall = time.perf_counter() - t0
        log(f"simulate_packed cuda {'eager' if eager else 'captured'}: "
            f"{wall:.2f} s wall, {grid.n_ticks / wall:.1f} ticks/s "
            f"(packing not included)")
    for key, want in outs[True].items():
        check(outs[False][key].dtype == want.dtype
              and np.array_equal(outs[False][key], want),
              f"sweep: captured and eager cuda {key} not bitwise")
    log(f"sweep: captured and eager cuda paths bitwise on all "
        f"{len(outs[True])} outputs")
    prof = {graph: profile_phase(torch, grid, graph) for graph in (False,
                                                                   True)}
    for graph, p in prof.items():
        which = "captured" if graph else "eager"
        check(p.get("topk_us", 0.0) == 0.0,
              f"profile {which}: torch.topk kernels in the cuda tick")
    traced = trace_phase(torch, grid)

    execution_phase(torch, grid, specs, days, n_files, outs[False],
                    runs["cuda"], card)
    mesh_launches = mesh_phase(torch, card, specs, runs["cuda"])

    decide_launches, decided = decide_phase(torch, days, n_files)
    cli_phase(torch, days, n_files, card, decided)
    examples_phase(torch, card)

    # one entry per kernel and case: the lane-tick kernels at the sweep's
    # shapes with their launches on the sweep, then the three further
    # kernel paths, each driven with its count reset just before and read
    # just after each case
    shapes = (f"sweep shapes (L {grid.n_lanes}, S {len(grid.site_names)}, "
              f"F {n_files})")
    cases = [(name, shapes + (", the K and W=4 windows in one launch"
                              if name == "window_admit" else ""),
              counts[name], {**kern[name],
                             "launches_decide": decide_launches[name]})
             for name in ops.KERNELS]
    cases += [(f"glue_{step}", f"{shapes}, the sweep's state at tick "
               f"{glue_tick}", counts[f"glue_{step}"],
               {**glue[step],
                "launches_decide": decide_launches[f"glue_{step}"]})
              for step in GLUE_STEPS]
    cases += [(name, case, n, {**r, "launches_decide": decide_launches[name]})
              for name, case, n, r in traced]
    cases += carousel_phase(torch)
    cases += [("flash_attention", *c) for c in attention_phase(torch)]
    cases += mamba_phase(torch)
    cases += served

    kernels = [dict(name=name, case=case, route="cuda",
                    source=r.get("source", KERNEL_SOURCE[name]),
                    replaces=REPLACES[name], launches=n,
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    **{k: r[k] for k in (
                        "variant", "loader", "device_us", "graph_ms",
                        "operations_per_state_step",
                        "instructions_per_state_step",
                        "bound_ms_without_rank", "bound_ms_simt",
                        "copy_device_us", "library_device_us",
                        "wall_us", "idle_share",
                        "ticks_per_s", "ticks_per_s_with_capture",
                        "ticks_per_s_second_call",
                        "capture_ms", "chunk", "launches_decide")
                       if k in r})
               for name, case, n, r in cases]
    attach_mesh_launches(kernels, mesh_launches)
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} ({k['case']}) was not "
                                 f"launched on its path")
    check({k["name"] for k in kernels} == set(KERNEL_SOURCE),
          "the kernels line misses a kernel")
    check({k["variant"] for k in kernels if k["name"] == "flash_attention"}
          == set(ATTENTION_SOURCE), "the kernels line misses an attention "
                                    "route")
    check({k.get("loader") for k in kernels if k.get("variant") == "wgmma"}
          == set(ATTENTION_LOADERS), "the kernels line misses a loader of "
                                     "the wgmma kernel")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
