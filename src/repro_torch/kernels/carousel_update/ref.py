"""Plain PyTorch version of the carousel tick (the paper's §4.1
transfer-manager update), on any device.

The oracle of ``csrc/carousel_update.cu``: the CPU tests hold it against
``repro.kernels.carousel_update`` (``ref.py:10`` ``carousel_tick_ref`` and
the Pallas kernel in interpret mode), and ``chip_smoke.py`` holds the CUDA
kernel against it on the card. It keeps the reference's operation order,
which the kernel repeats to the bit.
"""

from __future__ import annotations

import torch


def carousel_tick(link_id, active, done, total, bw, mode, dt):
    """One tick over ``N`` transfers on ``M`` links.

    ``link_id [N] int32`` (each in ``[0, M)``), ``active [N] bool``,
    ``done/total [N] float32``, ``bw [M] float32`` bytes/s, ``mode [M]
    int32`` (1 = per-transfer throughput, 0 = bandwidth shared by the
    link's active transfers), ``dt`` seconds. Returns ``(new_done [N] float32, completed [N] bool,
    counts [M] float32)``: ``counts`` the active transfers per link,
    ``new_done = min(total, done + active·rate·dt)`` and ``completed =
    (new_done >= total) & active``.
    """
    act = active.to(torch.float32)
    idx = link_id.long()
    counts = torch.zeros(bw.shape[0], dtype=torch.float32,
                         device=bw.device).index_add_(0, idx, act)
    bw_i, mode_i, counts_i = bw[idx], mode[idx], counts[idx]
    shared = bw_i / torch.clamp_min(counts_i, 1.0)
    rate = torch.where(mode_i > 0, bw_i, shared)
    new_done = torch.minimum(total, done + act * rate * dt)
    completed = (new_done >= total) & active
    return new_done, completed, counts
