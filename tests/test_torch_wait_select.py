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
``F`` not a multiple of 4.

The kernel (``tg_wait_select``) cannot run here, so its partition is
modelled lane by lane (``torch_glue_inputs.kernel_wait_select``): the
runs of ``ops.flag_ranges``, each lane's C lowest keys (a lane keying
the files a warp gathers, or a thread's own where they are dense), the
keys of files that do not wait only from the block that takes run 0,
then the warp, block and row merges. The model is held bitwise to the
plain version under hypothesis (``F`` from 1 to three runs, every ``W``,
every block count, rows with 0, W - 1, W and all files waiting) and on
rows built so that the fill decides the answer; without the fill it
disagrees there.
The kernel itself is held to the plain version on a card by
``test_torch_kernels_cuda.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from repro_torch.kernels.tick_glue import ops, ref
from torch_glue_inputs import (
    WS_DENSE,
    WS_LOADS,
    WS_THREADS,
    WS_VEC,
    kernel_wait_select,
)
from torch_threads import one_torch_thread  # noqa: F401

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



# ------------------------------------------- the kernel's partition
RUN = ops.FLAG_RUN


def plain_rows(wait, ticket, W):
    """``ref.wait_select`` on rows ``[R, F]``, as numpy."""
    st = {"wq_wait": torch.as_tensor(wait)[None],
          "wq_ticket": torch.as_tensor(ticket)[None]}
    lowest, idx = ref.wait_select(st, W)
    return lowest[0].numpy(), idx[0].numpy()


def model_rows(wait, ticket, W, blocks, fill=True):
    return kernel_wait_select(wait, ticket, W, blocks, ops.flag_ranges,
                              fill=fill)


def test_model_mirrors_the_kernel_constants():
    """The model's threads, loads, flags a load and dense threshold are
    the kernel's, and a run of them is ``ops.FLAG_RUN``, at least
    ``MAX_WAIT`` flags."""
    text = (Path(ops.__file__).parent / "csrc" / "tick_glue.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert (const("kThreads"), const("kFlagLoads"), const("kFlagVec"),
            const("kDenseWait")) == (WS_THREADS, WS_LOADS, WS_VEC, WS_DENSE)
    assert WS_THREADS * WS_LOADS * WS_VEC == RUN >= ops.MAX_WAIT


def _rows(rng, F, W, kinds, front):
    """One row per kind: ``"none"``, ``"W-1"``, ``"W"``, ``"all"`` or
    ``"share"`` waiting; where ``front``, the waiting files of a row with
    fewer than ``W`` are its first ones (the fill then starts past them),
    else drawn anywhere. Tickets from a range small enough to tie."""
    wait = np.zeros((len(kinds), F), bool)
    for r, kind in enumerate(kinds):
        n = {"none": 0, "W-1": W - 1, "W": W, "all": F}.get(kind)
        if n is None:
            wait[r] = rng.random(F) < 0.3
        elif front and n < F:
            wait[r, :n] = True
        else:
            wait[r, rng.choice(F, size=n, replace=False)] = True
    ticket = rng.integers(0, max(2, F // 7), wait.shape).astype(np.int32)
    return wait, ticket


_KINDS = ("none", "W-1", "W", "all", "share")


@settings(max_examples=60, deadline=None)
@given(seed=hs.integers(0, 2 ** 32 - 1),
       F=hs.one_of(hs.integers(1, 64), hs.integers(1, 3 * RUN),
                   hs.sampled_from([RUN - 1, RUN, RUN + 1, 2 * RUN + 17,
                                    3 * RUN])),
       data=hs.data())
def test_kernel_model_is_the_plain_selection(seed, F, data):
    """The kernel's partition and fill, modelled lane by lane, bitwise to
    ``ref.wait_select`` at every ``W`` up to ``min(32, F)``, every block
    count a row from 1 to its runs, ``F`` below a run, not a multiple of
    16 and over several runs, and rows with 0, W - 1, W and all files
    waiting."""
    W = data.draw(hs.integers(1, min(ops.MAX_WAIT, F)), label="W")
    blocks = data.draw(hs.integers(1, -(-F // RUN)), label="blocks")
    front = data.draw(hs.booleans(), label="front")
    wait, ticket = _rows(np.random.default_rng(seed), F, W, _KINDS, front)
    got = model_rows(wait, ticket, W, blocks)
    want = plain_rows(wait, ticket, W)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


#: Rows where the fill decides: fewer than W waiting, at the front of run
#: 0, in thread 0's four words (files 0-15, 4096-4111, ...), or only in
#: the runs after run 0.
def _fill_rows(F, W):
    rows = np.zeros((3, F), bool)
    rows[0, :W - 1] = True
    words = np.concatenate([np.arange(u * WS_THREADS * WS_VEC,
                                      u * WS_THREADS * WS_VEC + WS_VEC)
                            for u in range(WS_LOADS)])
    rows[1, words[words < F][:W - 1]] = True
    late = np.arange(RUN, F)
    rows[2, late[:W - 1]] = True
    return rows


@pytest.mark.parametrize("W", [1, 4, 5, 32])
@pytest.mark.parametrize("F", [33, RUN, 3 * RUN + 5])
def test_the_fill_decides_rows_with_fewer_than_w_waiting(F, W):
    """On rows with W - 1 waiting files the answer's last key is a file
    that does not wait, which only the fill of run 0 keys: with it the
    model is the plain selection at one block a row and at one a run;
    without it, it is not."""
    wait = _fill_rows(F, W)
    ticket = np.random.default_rng(F + W).integers(
        0, 5, wait.shape).astype(np.int32)
    want = plain_rows(wait, ticket, W)
    assert (want[0][:, -1] == ref.BIG_TICKET).all()
    for blocks in {1, -(-F // RUN)}:
        got = model_rows(wait, ticket, W, blocks)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    got = model_rows(wait, ticket, W, 1, fill=False)
    assert not np.array_equal(got[1], want[1])
