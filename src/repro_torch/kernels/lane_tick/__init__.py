"""The batched sweep tick's three kernels, hand-written in CUDA for Hopper.

- :func:`transfer_tick` — carousel transfer advance + completion billing;
- :func:`gcs_admit` — the shared-GCS prefix-sum admission passes fused with
  the GB-second storage integration and the per-site migration rank;
- :func:`window_admit` — the ``[L, S, C]`` candidate-window recurrences.

``ops`` holds the wrappers (CPU tensors go to the plain versions in
``ref``, CUDA tensors to ``csrc/lane_tick.cu``) and their launch counts.
"""

from repro_torch.kernels.lane_tick.ops import (  # noqa: F401
    KERNELS,
    gcs_admit,
    launch_counts,
    reset_launch_counts,
    transfer_tick,
    window_admit,
)
