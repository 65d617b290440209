"""Plain PyTorch version of the carousel tick (the paper's §4.1
transfer-manager update), on any device.

The oracle of ``csrc/carousel_update.cu``: the CPU tests hold it against
``repro.kernels.carousel_update`` (``ref.py:10`` ``carousel_tick_ref`` and
the Pallas kernel in interpret mode), and ``chip_smoke.py`` holds the CUDA
kernel against it on the card. It keeps the reference's operation order,
which the kernel repeats to the bit. :func:`engine_tick` is the plain
version of the tick engine's kernel: the same tick on counts carried from
the tick before (:func:`carry_counts`), in the kernel's buffers.
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


def carry_counts(counts, link_id, completed):
    """The active transfers per link after a tick, from those before it:
    ``counts`` less the tick's completions on each link (integers)."""
    done_by_link = torch.bincount(link_id[completed].long(),
                                  minlength=counts.shape[0])
    return counts - done_by_link.to(counts.dtype)


def engine_tick(link_id, active, done, total, bw, mode, dt, t, counts,
                hist, completions):
    """Tick ``t`` of the tick engine in place, as its kernel runs it.

    ``active`` and ``done`` advance in place (see :func:`carousel_tick`),
    ``completions[t]`` (int32) gains the tick's completions. The counts
    are carried, not recounted: ``counts [2, M]`` and ``hist [3, M]``
    (int32) rotate with the tick, ``counts[(t + 1) % 2] - hist[(t + 2) %
    3]`` is this tick's count (:func:`carry_counts` of the tick before),
    stored in ``counts[t % 2]``; ``hist[t % 3]`` gains the tick's
    completions by link and ``hist[(t + 1) % 3]``, the next tick's, is
    zeroed. Before tick 0, ``counts[1]`` holds the count of the active
    transfers and the rest is zero.
    """
    c = counts[(t + 1) % 2] - hist[(t + 2) % 3]
    counts[t % 2] = c
    hist[(t + 1) % 3] = 0
    idx = link_id.long()
    act = active.to(torch.float32)
    shared = bw / torch.clamp_min(c.to(torch.float32), 1.0)
    rate = torch.where(mode > 0, bw, shared)[idx]
    new_done = torch.minimum(total, done + act * rate * dt)
    completed = (new_done >= total) & active
    done.copy_(new_done)
    active &= ~completed
    hist[t % 3] += torch.bincount(idx[completed], minlength=bw.shape[0]).to(
        hist.dtype)
    completions[t] += completed.sum(dtype=completions.dtype)
