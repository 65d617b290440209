"""The carousel tick (the paper's §4.1 transfer-manager update), with a
hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.carousel_update``:

- :func:`carousel_tick` — one tick over ``N`` transfers on ``M`` links
  (``repro``'s ``ops.py:38``, Pallas ``count_kernel`` + ``update_kernel``);
- :func:`simulate_ticks` — the tick engine over many ticks (``ops.py:50``).

``ops`` holds the entry points and the kernel's launch count, ``ref`` the
plain version, ``csrc/carousel_update.cu`` the kernel, built by ``nvcc``
at its first launch.
"""

from repro_torch.kernels.carousel_update.ops import (  # noqa: F401
    KERNELS,
    carousel_tick,
    launch_counts,
    reset_launch_counts,
    simulate_ticks,
)
