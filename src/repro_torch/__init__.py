"""PyTorch / CUDA port of the batched HCDC sweep (paper §5.3).

A second package beside ``repro`` (the JAX reference). It imports
``torch`` and numpy and never ``jax`` or any ``repro`` module: what it
needs of the numpy-only modules (spec packing, pricing, distributions,
workloads) it keeps as its own copy, and ``tests/test_torch_*.py`` hold
the copies equal to the originals.

Module names mirror ``repro``'s:

- ``repro_torch.core.scenarios``: ``ScenarioSpec``, ``pack_specs`` and the
  ``PackedGrid`` the tick program consumes (bit-identical to ``repro``'s),
  ``specs_from_mapping`` for sweep documents;
- ``repro_torch.sim.batched``: the lane-per-scenario fixed-tick program
  (``simulate_packed``, ``run_sweep_torch``), lanes as an explicit leading
  tensor axis and a Python loop over ticks;
- ``repro_torch.kernels.lane_tick``: the three hand-written CUDA kernels of
  the tick (transfer advance, shared-GCS admission, candidate windows) and
  their plain PyTorch versions; ``repro_torch.kernels.tick_glue``: the
  state updates between them as five more;
- ``repro_torch.kernels.registry``: the ``tick_impl`` axis (``"torch"`` |
  ``"cuda"`` | ``"auto"``);
- ``repro_torch.sim.engine``, ``.infrastructure``, ``.transfer``,
  ``.cloud``, ``.output`` and ``repro_torch.core.{hcdc,carousel,
  validation,planner}``: the event-driven reference engine (the HCDC
  scenario of Tables 6-8, the §4.2 validation scenario, the §6 planner),
  host code on numpy draws, bitwise ``repro``'s;
- ``repro_torch.sim.sweep``: the front door (``run_sweep``,
  ``SweepDriver``; ``backend="torch"``, the batched program, or
  ``"process"``, the event engine) with the persistent result cache
  (``repro_torch.sim.cache``) in front of it, and its execution layer
  (``repro_torch.sim.{jobs,faults,runners}``: retryable jobs, the spawned
  process pool, the worker fleet);
- ``repro_torch.sim.decide``: the §5.3 decision workflow (``decide``);
- ``repro_torch.cli``: the ``run_sweep`` and ``decide`` commands
  (``python -m repro_torch.cli.run_sweep`` / ``...decide``);
- ``repro_torch.obs``: the metrics registry, the tracer and the logging
  setup those layers report through.

Entry points of the batched program run on the CUDA device unless the
caller passes ``device="cpu"``; without CUDA and without that argument
they raise. The event engine runs on the host and never touches the card.
"""
