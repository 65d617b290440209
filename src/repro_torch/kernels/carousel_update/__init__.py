"""The carousel tick (the paper's §4.1 transfer-manager update), with a
hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.carousel_update``:

- :func:`carousel_tick` — one tick over ``N`` transfers on ``M`` links
  (``repro``'s ``ops.py:38``, Pallas ``count_kernel`` + ``update_kernel``);
- :func:`simulate_ticks` — the tick engine over many ticks (``ops.py:50``),
  run by :class:`CarouselEngine`: one kernel launch a tick on link counts
  carried from tick to tick, replayed from a CUDA graph.

``ops`` holds the entry points and the kernels' launch counts, ``ref`` the
plain versions, ``csrc/carousel_update.cu`` the kernels, built by ``nvcc``
at their first launch.
"""

from repro_torch.kernels.carousel_update.ops import (  # noqa: F401
    KERNELS,
    CarouselEngine,
    carousel_tick,
    engine_count,
    launch_counts,
    reset_launch_counts,
    simulate_ticks,
)
