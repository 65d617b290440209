"""Seeded numpy inputs of the lane-tick kernels, shared by the CPU parity
tests (``test_torch_lane_tick.py``) and the CUDA tests
(``test_torch_kernels_cuda.py``). Built as ``tests/test_kernels.py``
builds them; imports neither JAX nor the JAX package, so the CUDA tests
run where only PyTorch is installed."""

import numpy as np
import torch

N_MONTHS, MONTH = 4, 1


def transfer_inputs(S=3, F=37, seed=0):
    """One lane's transfer planes: link_id, active, done, total, sizes,
    bw, mode."""
    rng = np.random.default_rng(seed)
    site = np.repeat(np.arange(S)[:, None], F, axis=1)
    link_id = (3 * site + rng.integers(0, 3, (S, F))).astype(np.int32)
    active = rng.random((S, F)) < 0.5
    total = (rng.exponential(1e8, (S, F)) + 1e3).astype(np.float32)
    done = (rng.random((S, F)).astype(np.float32)) * total
    sizes = total.copy()
    bw = rng.uniform(1e5, 1e7, 3 * S).astype(np.float32)
    mode = rng.integers(0, 2, 3 * S).astype(np.int32)
    return link_id, active, done, total, sizes, bw, mode


def stack_transfer(lanes, device="cpu"):
    """Stack per-lane ``transfer_inputs`` into lane-leading tensors."""
    return [torch.as_tensor(np.stack([lane[i] for lane in lanes]),
                            device=device) for i in range(7)]


def gcs_inputs(L=3, S=4, F=33, seed=7):
    """Candidates, sizes, occupancy and limits (the last lane unlimited)."""
    rng = np.random.default_rng(seed)
    want = rng.random((L, S, F)) < 0.4
    sizes = rng.uniform(1e6, 1e9, (L, S, F)).astype(np.float32)
    used0 = rng.uniform(1e9, 3e9, L).astype(np.float32)
    limit = np.asarray([2e10, 1.5e10, np.inf], np.float32)[:L]
    return want, sizes, used0, limit


def window_inputs(fifo, L=3, S=5, C=6):
    """A candidate window against disk headroom (one site unlimited)."""
    rng = np.random.default_rng(13 + fifo)
    live = rng.random((L, S, C)) < 0.7
    size = rng.uniform(1e6, 5e9, (L, S, C)).astype(np.float32)
    used = rng.uniform(0, 1e10, (L, S)).astype(np.float32)
    limit = np.full((L, S), 1e10, np.float32)
    limit[-1, 0] = np.inf
    return live, size, used, limit


def scalars(device="cpu", dt=50.0):
    """The tick length and month index as 0-d device tensors."""
    return (torch.tensor(dt, dtype=torch.float32, device=device),
            torch.tensor(MONTH, dtype=torch.int32, device=device))
