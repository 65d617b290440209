"""The batched sweep tick's tracing, hand-written in CUDA for Hopper: one
kernel that stamps the card's clock between the tick's phases, and one
that counts the tick's work, both launched inside the captured tick when
a loop is traced (``repro_torch.sim.batched.TickLoop`` built with the
tracer on) and never otherwise.

- :func:`stamp` — the time since the previous stamp into a segment's sum,
  maximum and count (:data:`SEGMENTS`);
- :func:`count` — on every :data:`COUNT_STRIDE`-th tick, the tick's GCS
  candidates, admitted migrations, active transfers, waiting files and
  queued link transfers a lane (:data:`COUNTS`).

``ops`` holds the wrappers (CPU state goes to the plain versions in
``ref``, which read the host clock, CUDA state to
``csrc/trace_tick.cu``) and their launch counts.
"""

from repro_torch.kernels.trace_tick.ops import (  # noqa: F401
    COUNT_STRIDE,
    COUNTS,
    KERNELS,
    LAYERS,
    ROW,
    SEGMENTS,
    add_launch_counts,
    count,
    launch_counts,
    reset_launch_counts,
    restart,
    stamp,
    state,
    summary,
)
