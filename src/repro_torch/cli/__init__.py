"""Command-line entry points of the port, copies of ``repro``'s
``scripts/run_sweep.py`` and ``scripts/decide.py`` with their flags,
outputs and exit codes:

- ``python -m repro_torch.cli.run_sweep``: a scenario grid on the batched
  program (``--backend torch``, the default, on the card) or on the
  event-driven reference engine (``--backend process``), with its cost vs.
  throughput table and Pareto front;
- ``python -m repro_torch.cli.decide``: the §5.3 decision report, with
  ``--cross-check`` re-running its decision points on the other backend.

Each has a ``main(argv)`` returning the exit code: 0 on success, 2 with
one ``ERROR`` line on a bad argument, 1 when the cross-check disagrees, 3
on a partial result.
"""
