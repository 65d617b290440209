"""Plain PyTorch versions of the sweep tick's glue: the state updates
between the lane-tick kernels (``repro_torch.sim.batched``'s tick body).

These are the oracles of the ``tick_glue`` kernels and what the ``torch``
tick runs; ``tests/test_torch_batched.py`` holds that tick exact to
``repro``'s jnp program. Each function updates the tick state ``st`` in
place (``masked_fill_``, ``logical_and_``, ``torch.where(..., out=)``), as a
captured tick needs, and keeps the operation order of the JAX package's
tick body (``repro.sim.batched._lane_step_fns``), in four steps and the
wait-queue selection:

- :func:`begin` — which transfers advance this tick (``batched.py:205-206``);
- :func:`complete` — the consumer snapshot (``:195``), the completions'
  state updates and pending-job resolution (``:227-268``), the link
  occupancy and the link-slot prologue (``:273-279``, ``:287``), and the
  hot-tier deletions with the migration candidates (``:295-300``,
  ``:332-333``);
- :func:`link_admit` — the link-slot FIFO admission (``:280-286``);
- :func:`migrate` — the admitted migrations' submission (``:331``,
  ``:336-353``);
- :func:`wait_select` — the wait-queue heads, the ``W`` lowest tickets of
  each row's waiting files (``:473-475``).

The deletions run in :func:`complete`, ahead of the link-slot admission and
the GCS admission where the JAX program applies them: neither of those
reads ``disk_state``, ``disk_used``, ``pend_*`` or ``fin_max``, and
``disk_used`` still loses the dropped copies' bytes before the deleted
ones'. Each of those two row sums is taken in one fixed order,
:func:`row_sum`, which the kernel computes too.

``work`` is what an implementation carries from one step of a tick to
the next: here the link-type masks of the tick's transfers, in the
kernels the counter buffer (``ops``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.lane_tick.ref import by_type

# File-location states; must match the event engine's.
ABSENT, IN_FLIGHT, PRESENT = 0, 1, 2

_INF = float("inf")

#: The ticket of a file that does not wait: above every real ticket.
BIG_TICKET = 2 ** 30


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in one fixed order: a pairwise tree in
    ``x``'s dtype over each row in index order, the row zero-padded to a
    power of two (``x[..., 0::2] + x[..., 1::2]`` until one element is
    left). For values >= 0, ``a + 0.0 == a``, so every aligned
    power-of-two tile of the row reduced alone, then the tiles' sums
    reduced by the same tree, gives the same bits, whatever the tile."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def begin(st: Dict[str, torch.Tensor], now: torch.Tensor, dt: torch.Tensor):
    """The transfers that advance this tick: those holding a link slot
    since before ``now - dt`` (half a second of slack). Returns
    ``(t_active [L,S,F] bool, work)``; ``work`` holds the link type of
    every transfer (``tr_link % 3``: 0 tape->disk, 1 gcs->disk, 2
    disk->gcs) as three masks."""
    t_active = st["tr_slot"] & (st["tr_start"] <= now - dt + 0.5)
    ltype = torch.remainder(st["tr_link"], 3)
    return t_active, [ltype == k for k in range(3)]


def complete(st, c, now, new_done, comp, work):
    """After ``transfer_tick``: apply its completions (``new_done``,
    ``comp``), resolve the arrived files' pending jobs, count the link
    occupancy and admit queued transfers' link slots (``lq_serve``), and
    delete the hot copies that no consumer needs. Returns ``(want_mig
    [L,S,F] bool, occ3 [L,S,3] f32)``: the migration candidates
    ``gcs_admit`` takes and the link occupancy after the admission."""
    is_t = work
    sizes = c["sizes"]
    L, S, _ = sizes.shape
    gcs_en = c["gcs_enabled"]
    # -- consumer snapshot (jobs submitted before this tick that have
    # not finished by ``now``)
    no_cons = (st["pend_cnt"] == 0) & (st["fin_max"] <= now)

    comp_mig = comp & is_t[2]
    inbound = comp & (is_t[0] | is_t[1])
    st["disk_state"].masked_fill_(inbound, PRESENT)
    st["gcs_state"].masked_fill_(comp_mig, PRESENT)
    # migrated with no remaining consumer: drop the hot copy now
    drop_hot = comp_mig & no_cons & (st["disk_state"] == PRESENT)
    st["disk_used"].sub_(row_sum(torch.where(drop_hot, sizes, 0.0)))
    st["disk_state"].masked_fill_(drop_hot, ABSENT)
    st["tr_slot"].logical_and_(~comp)
    torch.where(comp, c["zero"], new_done, out=st["tr_done"])
    st["tr_total"].masked_fill_(comp, _INF)
    st["tr_start"].masked_fill_(comp, _INF)

    # arrived files resolve their pending jobs
    resolve = inbound & (st["pend_cnt"] > 0)
    torch.where(resolve,
                torch.maximum(st["fin_max"], now + st["pend_tail"]),
                st["fin_max"], out=st["fin_max"])
    st["pend_cnt"].masked_fill_(inbound, 0)
    st["pend_tail"].masked_fill_(inbound, 0.0)

    # -- link-slot FIFO admission, its [L, 3S] part: slots freed this tick
    # go to the queue heads (tickets are contiguous per link)
    occ = torch.stack([(st["tr_slot"] & m).sum(-1) for m in is_t],
                      dim=-1).to(torch.float32).view(L, 3 * S)
    free = torch.clamp_min(c["slots"] - occ, 0.0)
    n_q = (st["lq_next"] - st["lq_serve"]).to(torch.float32)
    admit = torch.minimum(free, n_q).to(torch.int32)
    st["lq_serve"].add_(admit)
    occ3 = (occ + admit.to(torch.float32)).view(L, S, 3)

    # -- hot-tier deletions and the hot->cold migration candidates
    cand = no_cons & (st["disk_state"] == PRESENT) & c["limited"]
    gs = st["gcs_state"]
    pop_ok = c["pop_ok"]
    migratable = gcs_en & (gs == ABSENT) & pop_ok
    delete = cand & (~gcs_en | (gs == PRESENT)
                     | ((gs == ABSENT) & ~pop_ok))
    want_mig = cand & migratable
    st["disk_used"].sub_(row_sum(torch.where(delete, sizes, 0.0)))
    st["disk_state"].masked_fill_(delete, ABSENT)
    return want_mig, occ3


def link_admit(st, c, now, work) -> None:
    """Queued transfers whose ticket is below their link's serve counter
    (advanced by :func:`complete`) take their slot and start after the
    link's latency."""
    is_t = work
    L, S, _ = st["tr_link"].shape
    adm_row = st["lq_queued"] & (
        st["lq_ticket"] < by_type(st["lq_serve"].view(L, S, 3), is_t))
    st["tr_slot"].logical_or_(adm_row)
    torch.where(adm_row, now + by_type(c["latency"].view(L, S, 3), is_t),
                st["tr_start"], out=st["tr_start"])
    st["lq_queued"].logical_and_(~adm_row)


def migrate(st, c, now, mig, rank, occ3, work) -> None:
    """Submit the migrations ``gcs_admit`` admitted (``mig``, each with its
    place ``rank`` among its site's admissions) on each site's disk->gcs
    link: FIFO, direct slots only while the link queue is empty, the
    overflow queued. Updates ``occ3`` (from :func:`complete`) in place."""
    sizes = c["sizes"]
    L, S, _ = sizes.shape
    lqn3 = st["lq_next"].view(L, S, 3)
    lqs3 = st["lq_serve"].view(L, S, 3)
    slots3 = c["slots"].view(L, S, 3)
    st["gcs_state"].masked_fill_(mig, IN_FLIGHT)
    # the direct ones are the first n_direct of a site's admissions (or
    # none while the queue is busy), so a queued file's place in the
    # queue is rank - n_direct
    q_empty = (lqn3[..., 2] == lqs3[..., 2])[..., None]
    free_m = torch.clamp_min(slots3[..., 2] - occ3[..., 2], 0.0)[..., None]
    direct = mig & q_empty & (rank < free_m)
    queued = mig & ~direct
    n_direct = direct.sum(-1, keepdim=True, dtype=torch.int32)
    qrank = rank - n_direct
    st["tr_slot"].logical_or_(direct)
    torch.where(mig, c["mig_link"], st["tr_link"], out=st["tr_link"])
    torch.where(mig, sizes, st["tr_total"], out=st["tr_total"])
    st["tr_done"].masked_fill_(mig, 0.0)
    torch.where(direct, now, st["tr_start"], out=st["tr_start"])
    torch.where(queued, lqn3[..., 2:3] + qrank, st["lq_ticket"],
                out=st["lq_ticket"])
    st["lq_queued"].logical_or_(queued)
    lqn3[..., 2] += queued.sum(-1, dtype=torch.int32)
    occ3[..., 2] += n_direct[..., 0].to(torch.float32)


def wait_select(st, W: int, work=None):
    """The wait-queue heads: the ``W`` lowest ``(ticket, index)`` pairs of
    each ``[L, S]`` row, a file that does not wait (``wq_wait`` false)
    counting as ticket :data:`BIG_TICKET`, so the fill past the waiting
    files is the lowest indices of the others, as ``jax.lax.top_k(
    -tickets, W)`` returns it. Returns ``(lowest [L, S, W] int32, idx
    [L, S, W] int64)`` in ascending order; ``work`` is not read."""
    F = st["wq_wait"].shape[-1]
    index = torch.arange(F, dtype=torch.int64, device=st["wq_wait"].device)
    tickets = torch.where(st["wq_wait"], st["wq_ticket"].to(torch.int64),
                          BIG_TICKET)
    key = torch.topk(tickets * F + index, W, dim=-1, largest=False,
                     sorted=True).values
    return (key // F).to(torch.int32), key % F
