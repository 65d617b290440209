"""The batched sweep tick's glue, hand-written in CUDA for Hopper: the
state updates between the three lane-tick kernels, one pass over the
``[L, S, F]`` planes each, in the order the tick runs them:

- :func:`begin` — the transfers that advance this tick;
- :func:`complete` — the completions, pending-job resolution, link
  occupancy with the link-slot prologue, and the hot-tier deletions with
  the migration candidates;
- :func:`link_admit` — the link-slot FIFO admission;
- :func:`migrate` — the admitted migrations' submission;
- :func:`wait_select` — the wait-queue heads (the lowest tickets of the
  waiting files), which the JAX package takes with ``jax.lax.top_k``.

``ops`` holds the wrappers (CPU state goes to the plain versions in
``ref``, CUDA state to ``csrc/tick_glue.cu``) and their launch counts.
No TPU kernel holds this work: the JAX package leaves it to XLA's fusion
of its jitted tick.
"""

from repro_torch.kernels.tick_glue.ops import (  # noqa: F401
    KERNELS,
    begin,
    complete,
    launch_counts,
    link_admit,
    migrate,
    reset_launch_counts,
    wait_select,
)
