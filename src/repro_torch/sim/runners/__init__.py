"""Worker-fleet execution for the port's registry jobs, copied from
``repro.sim.runners``.

- ``transport``: the pluggable seam between the dispatcher and one
  worker — a framed-pickle message protocol over a byte stream, the JAX
  package's frames. ``SubprocessTransport`` speaks it to a local worker
  process; ``LocalTransport`` runs the worker logic inline (tests,
  debugging).
- ``worker``: the worker-side main loop (``python -m
  repro_torch.sim.runners.worker``) — receives an init context, builds
  the lane-chunk runner once, then answers job frames with result frames
  carrying the worker's metrics snapshot delta.
- ``fleet``: ``run_fleet_jobs``, the dispatcher — assigns ready registry
  jobs to idle workers, polls for results, reaps deadline overruns by
  killing (and later respawning) the offending worker, and attributes a
  dead pipe to exactly the in-flight job it carried.
"""

from repro_torch.sim.runners.fleet import run_fleet_jobs
from repro_torch.sim.runners.transport import (LocalTransport,
                                               SubprocessTransport,
                                               Transport, TransportError,
                                               resolve_transport)

__all__ = [
    "LocalTransport", "SubprocessTransport", "Transport", "TransportError",
    "resolve_transport", "run_fleet_jobs",
]
