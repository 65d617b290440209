"""Mamba-1 selective scan, with a hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.mamba_scan``: :func:`mamba_scan` is
``repro``'s ``ops.py:19`` (Pallas ``_scan_kernel``, ``mamba_scan.py:29``);
:func:`selective_scan` is the same scan from u, dt, A, B and C, with dA
and dBu formed in the kernel (what ``models.ssm.gated_scan`` calls).
``ops`` holds the entry points and their launch counts, ``ref`` the plain
versions, and ``csrc/mamba_scan.cu`` the kernel, built by ``nvcc`` at its
first launch.
"""

from repro_torch.kernels.mamba_scan.ops import (  # noqa: F401
    KERNELS,
    launch_counts,
    mamba_scan,
    reset_launch_counts,
    selective_scan,
)
