"""PyTorch / CUDA port of the batched HCDC sweep (paper §5.3).

A second package beside ``repro`` (the JAX reference). It imports
``torch`` and numpy and never ``jax`` or any ``repro`` module: what it
needs of the numpy-only modules (spec packing, pricing, distributions,
workloads) it keeps as its own copy, and ``tests/test_torch_*.py`` hold
the copies equal to the originals.

Module names mirror ``repro``'s:

- ``repro_torch.core.scenarios``: ``ScenarioSpec``, ``pack_specs`` and the
  ``PackedGrid`` the tick program consumes (bit-identical to ``repro``'s);
- ``repro_torch.sim.batched``: the lane-per-scenario fixed-tick program
  (``simulate_packed``, ``run_sweep_torch``), lanes as an explicit leading
  tensor axis and a Python loop over ticks;
- ``repro_torch.kernels.lane_tick``: the three hand-written CUDA kernels of
  the tick (transfer advance, shared-GCS admission, candidate windows) and
  their plain PyTorch versions;
- ``repro_torch.kernels.registry``: the ``tick_impl`` axis (``"torch"`` |
  ``"cuda"`` | ``"auto"``);
- ``repro_torch.sim.sweep``: the front door (``run_sweep``,
  ``SweepDriver``) with the persistent result cache
  (``repro_torch.sim.cache``) in front of the batched program;
- ``repro_torch.sim.decide``: the §5.3 decision workflow (``decide``);
- ``repro_torch.obs``: the metrics registry, the tracer and the logging
  setup those layers report through.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA and without that argument they raise.
"""
