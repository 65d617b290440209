"""The sweep tick's wait-queue selection (``tick_glue.ref.wait_select``)
against the JAX package's, on the CPU.

``repro``'s tick takes the wait-queue heads as ``jax.lax.top_k(-tickets,
W)`` over ``tickets = where(wq_wait, wq_ticket, BIG)``
(``src/repro/sim/batched.py:473-475``). ``top_k`` breaks ties by the lower
index, so the lexicographic order (ticket, index) defines its ``idx``
completely, the fill past the waiting files included; the port's plain
version keys each file ``ticket * F + index`` and takes the ``W`` lowest.
Both are held bitwise here on seeded numpy planes: rows with no waiting
file, fewer than ``W``, and every file waiting, tickets tied within a row,
``F`` not a multiple of 4. The kernel (``tg_wait_select``) is held to the
plain version on a card by ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.tick_glue import ref

BIG = 2 ** 30


def _planes(seed, L, S, F, W):
    """``(wq_wait, wq_ticket)`` of shape ``[L, S, F]``: row by row no
    waiting file, fewer than ``W``, a share of the row, or all of it, with
    tickets drawn from a range small enough to tie."""
    rng = np.random.default_rng(seed)
    wait = np.zeros((L, S, F), bool)
    rows = wait.reshape(-1, F)
    for r in range(rows.shape[0]):
        kind = r % 4
        if kind == 1:  # fewer than W waiting
            n = int(rng.integers(1, W)) if W > 1 else 0
            rows[r, rng.choice(F, size=n, replace=False)] = True
        elif kind == 2:
            rows[r] = rng.random(F) < 0.3
        elif kind == 3:
            rows[r] = True
    ticket = rng.integers(0, max(2, F // 3), (L, S, F)).astype(np.int32)
    return wait, ticket


def jax_wait_heads(wait, ticket, W):
    """``repro``'s selection: ``(lowest, idx)`` of ``jax.lax.top_k(-tickets,
    W)``."""
    tickets = jnp.where(jnp.asarray(wait), jnp.asarray(ticket), BIG)
    neg, idx = jax.lax.top_k(-tickets, W)
    return -np.asarray(neg), np.asarray(idx)


@pytest.mark.parametrize("W", [1, 4, 32])
@pytest.mark.parametrize("F", [33, 257, 1001])
def test_plain_wait_select_matches_jax_top_k(F, W):
    """``lowest`` and ``idx`` bitwise to ``jax.lax.top_k``'s, dtypes
    ``int32`` and ``int64`` as the tick takes them."""
    wait, ticket = _planes(F * W, 2, 4, F, W)
    st = {"wq_wait": torch.as_tensor(wait), "wq_ticket": torch.as_tensor(ticket)}
    lowest, idx = ref.wait_select(st, W)
    want_low, want_idx = jax_wait_heads(wait, ticket, W)
    assert lowest.dtype == torch.int32 and idx.dtype == torch.int64
    assert lowest.shape == idx.shape == (2, 4, W)
    assert np.array_equal(lowest.numpy(), want_low.astype(np.int32))
    assert np.array_equal(idx.numpy(), want_idx.astype(np.int64))
    # every kind of row was drawn: none, fewer than W, some, all waiting
    n_wait = wait.reshape(-1, F).sum(-1)
    assert n_wait.min() == 0 and n_wait.max() == F

