"""Mamba-1 selective scan, with a hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.mamba_scan``: :func:`mamba_scan` is
``repro``'s ``ops.py:19`` (Pallas ``_scan_kernel``, ``mamba_scan.py:29``).
``ops`` holds the entry point and the kernel's launch count, ``ref`` the
plain version, and ``csrc/mamba_scan.cu`` the kernel, built by ``nvcc`` at
its first launch.
"""

from repro_torch.kernels.mamba_scan.ops import (  # noqa: F401
    KERNELS,
    launch_counts,
    mamba_scan,
    reset_launch_counts,
)
