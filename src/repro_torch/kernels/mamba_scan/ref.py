"""Plain PyTorch Mamba-1 selective scan, on any device.

``h_t = dA_t * h_{t-1} + dBu_t`` from ``h_{-1} = 0``, and
``y_t = sum_n C_{t,n} * h_{t,n}``. The oracle of ``csrc/mamba_scan.cu``:
the CPU tests hold it against ``repro.kernels.mamba_scan.ref:10``
``mamba_scan_ref``, and ``chip_smoke.py`` holds the kernel against it on
the card. PyTorch has no associative scan, so this walks T in order; the
reference combines in a tree, so the two round differently (the tests'
bar is 1e-4).
"""

from __future__ import annotations

import torch


def mamba_scan(dA, dBu, C):
    """``dA, dBu [B, T, D, N] float32``, ``C [B, T, N] float32`` ->
    ``y [B, T, D] float32``."""
    B, T, D, N = dA.shape
    h = torch.zeros((B, D, N), dtype=torch.float32, device=dA.device)
    y = torch.empty((B, T, D), dtype=torch.float32, device=dA.device)
    for t in range(T):
        h = dA[:, t] * h + dBu[:, t]
        y[:, t] = (h * C[:, t, None, :]).sum(-1)
    return y
