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


#: Cases of the tick's two candidate windows (``windows_inputs``).
WINDOW_CASES = ("random", "duplicate_fids", "head_started", "head_blocking",
                "k0", "nothing_fits", "sum_at_limit")


def windows_inputs(case, L=3, S=4, K=4, W=4):
    """Both candidate windows of a tick, against disk headroom (one site
    unlimited): ``absent``, ``size_k``, ``fid_k`` of the K job window,
    ``valid_w``, ``present_w``, ``size_w``, ``idx_w`` of the W wait-queue
    heads, ``used``, ``limit``. ``case`` (one of ``WINDOW_CASES``) shapes
    them: duplicate fids in the K window; heads whose file a K slot holds,
    started or not; a first head too big to fit, blocking the rest; K = 0;
    no candidate fitting; sums that meet the limit exactly (powers of
    two)."""
    rng = np.random.default_rng(WINDOW_CASES.index(case) + 41)
    if case == "k0":
        K = 0
    absent = rng.random((L, S, K)) < 0.7
    size_k = rng.uniform(1e6, 5e9, (L, S, K)).astype(np.float32)
    fid_k = rng.integers(0, 10, (L, S, K))
    valid_w = rng.random((L, S, W)) < 0.8
    present_w = rng.random((L, S, W)) < 0.2
    size_w = rng.uniform(1e6, 5e9, (L, S, W)).astype(np.float32)
    idx_w = rng.integers(0, 10, (L, S, W))
    used = rng.uniform(0, 1e10, (L, S)).astype(np.float32)
    limit = np.full((L, S), 1e10, np.float32)
    limit[-1, 0] = np.inf
    if case == "duplicate_fids":
        fid_k[..., 1::2] = fid_k[..., 0::2]
        absent[...] = True
        size_k[...] = 1e6
        used[...] = 1e9
        idx_w[..., 0] = fid_k[..., 0]
        valid_w[..., 0] = True
    elif case == "head_started":
        absent[..., :2] = [True, False]
        size_k[..., 0] = 1e6
        used[...] = 1e9
        fid_k[..., :2] = [11, 12]
        idx_w[..., :2] = [11, 12]  # the second's K slot did not start
        valid_w[...] = True
        present_w[...] = False
    elif case == "head_blocking":
        valid_w[...] = True
        present_w[...] = False
        idx_w = 20 + np.arange(W) + np.zeros((L, S, 1), np.int64)
        size_w[..., 0] = 2e10
        size_w[..., 1:] = 1e6
        limit[-1, 0] = 1e10
    elif case == "nothing_fits":
        used = (limit * 0.999).astype(np.float32)
        used[-1, 0] = 0.0
        limit[-1, 0] = 1e6
        size_k[...] = 2e7
        size_w[...] = 2e7
    elif case == "sum_at_limit":
        used[...] = 2.0 ** 32
        limit[...] = 2.0 ** 33
        size_k[...] = np.float32(2.0 ** 30) * np.array(
            [1, 2, 4, 1], np.float32)  # 2^32 + 2^30 + 2^31 (+ 2^32 skipped)
        absent[...] = True                # + 2^30 = 2^33 exactly
        absent[:, ::2] = False  # these rows leave the room to the W window
        size_w[...] = np.float32(2.0 ** 30) * np.array(
            [1, 2, 1, 1], np.float32)
        valid_w[...] = True
        present_w[...] = False
        idx_w = 20 + np.arange(W) + np.zeros((L, S, 1), np.int64)
    return (absent, size_k, fid_k, valid_w, present_w, size_w, idx_w, used,
            limit)
