"""The sweep tick's glue (``repro_torch.kernels.tick_glue``) on the CPU.

The CUDA kernels (``csrc/tick_glue.cu``) cannot run here, so each is
modelled below in plain PyTorch in the order the kernel computes: one
pass over the elements that reads every element's entry values and
decides it alone, integer row counts, and the [L, 3S] work the launch's
last block does with them. The models are held bitwise to the plain
versions (``tick_glue.ref``) on random states (``torch_glue_inputs.
glue_state``, drawn by hypothesis from a numpy seed), and the whole tick
with the models in place of the plain glue bitwise to the plain tick on
every state tensor over 200 ticks of two grids. The plain glue's own
step order (deletions ahead of the link-slot and GCS admissions) and the
migration queue's closed form are held bitwise to the order the tick had
before the glue was split into steps. The fixed order of ``disk_used``'s
row sums (``ref.row_sum``) is held bitwise to a numpy model of its tree,
and the kernel's partition of it (tile trees, then the tree of the tile
sums) to the whole padded tree.

The kernels are held to the plain versions on a card by
``test_torch_kernels_cuda.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from repro_torch.core.scenarios import ScenarioSpec, pack_specs
from repro_torch.kernels.lane_tick import ref as lt_ref
from repro_torch.kernels.registry import resolve_tick_impl
from repro_torch.kernels.tick_glue import ops, ref
from repro_torch.kernels.tick_glue.ref import ABSENT, IN_FLIGHT, PRESENT
from repro_torch.sim.batched import GCS_ADMIT_PASSES, TickLoop
from torch_glue_inputs import (
    N_MONTHS,
    assert_states_equal,
    bitwise_equal,
    clone_state,
    glue_state,
)

_INF = float("inf")


# ------------------------------------------------ one-pass kernel models
def model_begin(st, now, dt):
    """``tg_begin``: the threshold once, the slot flags, their starts; a
    zeroed counter buffer (held-slot counts [R, 3], direct and queued
    migrations [R] each, two tickets)."""
    L, S, _ = st["tr_slot"].shape
    thr = (now - dt) + 0.5
    active = st["tr_slot"] & (st["tr_start"] <= thr)
    return active, torch.zeros(5 * L * S + 3, dtype=torch.int32)


#: ``tg_complete``'s tile (256 threads x 4 elements x 4 steps) and
#: ``tg_wait_select``'s (256 x 16 x 4).
COMPLETE_TILE = 4096
WAIT_TILE = 16384


def tiled_row_sum(x, tile=COMPLETE_TILE):
    """``tg_complete``'s partition of ``ref.row_sum``: each tile of the row
    (zero-padded to whole tiles) reduced alone, then the tree of the tile
    sums (as the last block's warps take it: padded to at least 32)."""
    F = x.shape[-1]
    nt = max(1, -(-F // tile))
    x = torch.nn.functional.pad(x, (0, nt * tile - F))
    part = ref.row_sum(x.reshape(*x.shape[:-1], nt, tile))
    return ref.row_sum(torch.nn.functional.pad(part, (0, max(0, 32 - nt))))


def model_complete(st, c, now, new_done, comp, work):
    """``tg_complete``: each element from its entry values, then the held
    slots counted by link type into ``work``, then the last block's
    link-slot prologue on those counts and the rows' trees of the tile
    sums of the dropped and the deleted sizes."""
    sizes = c["sizes"]
    L, S, F = sizes.shape
    R = L * S
    pc, fm = st["pend_cnt"].clone(), st["fin_max"].clone()
    ds, sl = st["disk_state"].clone(), st["tr_slot"].clone()
    no_cons = (pc == 0) & (fm <= now)
    lt = torch.remainder(st["tr_link"], 3)
    inbound = comp & (lt != 2)
    mig_done = comp & (lt == 2)
    d = torch.where(inbound, PRESENT, ds)
    gs = torch.where(mig_done, PRESENT, st["gcs_state"])
    drop = mig_done & no_cons & (d == PRESENT)
    d = torch.where(drop, ABSENT, d)
    slot = sl & ~comp
    cand = no_cons & (d == PRESENT) & c["limited"]
    gen = c["gcs_enabled"]
    pop = c["pop_ok"]
    dele = cand & (~gen | (gs == PRESENT) | ((gs == ABSENT) & ~pop))
    want = cand & ~dele & (gs == ABSENT)
    d = torch.where(dele, ABSENT, d)
    # the element's writes
    st["fin_max"].copy_(torch.where(
        inbound & (pc > 0), torch.maximum(fm, now + st["pend_tail"]), fm))
    st["pend_cnt"].masked_fill_(inbound, 0)
    st["pend_tail"].masked_fill_(inbound, 0.0)
    st["gcs_state"].copy_(gs)
    st["tr_slot"].copy_(slot)
    st["tr_done"].copy_(torch.where(comp, 0.0, new_done))
    st["tr_total"].masked_fill_(comp, _INF)
    st["tr_start"].masked_fill_(comp, _INF)
    st["disk_state"].copy_(d)
    drop_sz = torch.where(drop, sizes, 0.0)
    del_sz = torch.where(dele, sizes, 0.0)
    # integer counts, then the last block
    held = torch.stack([(slot & (lt == k)).sum(-1) for k in range(3)], -1)
    work[:3 * R] += held.reshape(-1).to(torch.int32)
    occ = work[:3 * R].to(torch.float32).view(L, 3 * S)
    free = torch.clamp_min(c["slots"] - occ, 0.0)
    n_q = (st["lq_next"] - st["lq_serve"]).to(torch.float32)
    admit = torch.minimum(free, n_q).to(torch.int32)
    st["lq_serve"].add_(admit)
    occ3 = (occ + admit.to(torch.float32)).view(L, S, 3)
    st["disk_used"].sub_(tiled_row_sum(drop_sz))
    st["disk_used"].sub_(tiled_row_sum(del_sz))
    return want, occ3


def model_link_admit(st, c, now, work):
    """``tg_link_admit``: the queued flags, then per queued transfer its
    ticket against its own link's serve counter."""
    L, S, F = st["tr_link"].shape
    q = st["lq_queued"].clone()
    j = torch.remainder(st["tr_link"], 3).to(torch.int64)
    serve = torch.gather(st["lq_serve"].view(L, S, 3), -1, j)
    lat = torch.gather(c["latency"].view(L, S, 3), -1, j)
    adm = q & (st["lq_ticket"] < serve)
    st["tr_slot"].copy_(st["tr_slot"] | adm)
    st["tr_start"].copy_(torch.where(adm, now + lat, st["tr_start"]))
    st["lq_queued"].copy_(q & ~adm)


def closed_n_direct(q_empty, free_m):
    """The direct migrations ahead of a queued one in its row: none while
    the queue is busy, else every rank below ``free_m`` (``ceil``; a
    queued file's own rank is at least ``free_m``, so it is finite)."""
    return torch.where(q_empty, torch.ceil(torch.clamp_max(free_m, 2.0 ** 30)),
                       0.0).to(torch.int32)


def model_migrate(st, c, now, mig, rank, occ3, work):
    """``tg_migrate``: the row's queue head, free slots and closed-form
    ``n_direct`` from the launch's entry values; each migration alone;
    integer row counts into ``work``; the last block's row updates."""
    sizes = c["sizes"]
    L, S, F = sizes.shape
    R = L * S
    lqn = st["lq_next"].view(L, S, 3)[..., 2:3].clone()
    q_empty = lqn == st["lq_serve"].view(L, S, 3)[..., 2:3]
    free_m = torch.clamp_min(
        c["slots"].view(L, S, 3)[..., 2:3] - occ3[..., 2:3], 0.0)
    direct = mig & q_empty & (rank.to(torch.float32) < free_m)
    queued = mig & ~direct
    ticket = lqn + (rank - closed_n_direct(q_empty, free_m))
    st["gcs_state"].masked_fill_(mig, IN_FLIGHT)
    st["tr_slot"].logical_or_(direct)
    st["tr_start"].copy_(torch.where(direct, now, st["tr_start"]))
    st["lq_ticket"].copy_(torch.where(queued, ticket, st["lq_ticket"]))
    st["lq_queued"].logical_or_(queued)
    st["tr_link"].copy_(torch.where(mig, c["mig_link"], st["tr_link"]))
    st["tr_total"].copy_(torch.where(mig, sizes, st["tr_total"]))
    st["tr_done"].masked_fill_(mig, 0.0)
    work[3 * R:4 * R] += direct.sum(-1).reshape(-1).to(torch.int32)
    work[4 * R:5 * R] += queued.sum(-1).reshape(-1).to(torch.int32)
    st["lq_next"].view(L, S, 3)[..., 2] += work[4 * R:5 * R].view(L, S)
    occ3[..., 2] += work[3 * R:4 * R].view(L, S).to(torch.float32)


def model_wait_select(st, W, work):
    """``tg_wait_select``: each file's key ``ticket * F + index`` (ticket
    2^30 where it does not wait), the lowest C keys of each tile (C = 4 for
    W <= 4, else 32; a short tile's list padded with the empty key), then
    the W lowest of each row's tile lists, by sorting (keys are unique in
    a row); floor division back to the ticket and the index."""
    L, S, F = st["wq_wait"].shape
    C = 4 if W <= 4 else 32
    empty = torch.iinfo(torch.int64).max
    key = (torch.where(st["wq_wait"], st["wq_ticket"].to(torch.int64),
                       ref.BIG_TICKET) * F + torch.arange(F))
    nt = max(1, -(-F // WAIT_TILE))
    pad = torch.full((L, S, nt * WAIT_TILE - F), empty, dtype=torch.int64)
    tiles = torch.cat([key, pad], dim=-1).view(L, S, nt, WAIT_TILE)
    lists = torch.sort(tiles, dim=-1).values[..., :C]
    best = torch.sort(lists.reshape(L, S, nt * C), dim=-1).values[..., :W]
    return (best // F).to(torch.int32), best % F


MODELS = {"begin": model_begin, "complete": model_complete,
          "link_admit": model_link_admit, "migrate": model_migrate,
          "wait_select": model_wait_select}


def _step(fns, name, st, c, x, work):
    """Run glue step ``name`` of ``fns`` (``ref``, ``ops`` or ``MODELS``)
    on ``st`` with the values ``x``; returns its outputs."""
    fn = fns[name] if isinstance(fns, dict) else getattr(fns, name)
    now = x["now"]
    if name == "begin":
        return fn(st, now, x["dt"])
    if name == "complete":
        return fn(st, c, now, x["new_done"], x["comp"], work)
    if name == "link_admit":
        return fn(st, c, now, work)
    if name == "wait_select":
        return fn(st, x.get("W", 4), work)
    occ3 = x["occ3"].clone()  # updated in place
    fn(st, c, now, x["mig"], x["rank"], occ3, work)
    return (occ3,)


# ------------------------------------------------- models vs plain (CPU)
_SHARES = hs.sampled_from([0.0, 0.02, 0.3, 0.7, 1.0])


@pytest.mark.parametrize("step", list(MODELS))
@settings(max_examples=30, deadline=None)
@given(seed=hs.integers(0, 2 ** 32 - 1), F=hs.sampled_from([1, 33, 256,
                                                            257, 301]),
       slot=_SHARES, comp=_SHARES, queued=_SHARES, mig=_SHARES,
       gcs=hs.sampled_from(["on", "off", "mixed"]),
       limits=hs.sampled_from(["finite", "inf", "mixed"]),
       wait=_SHARES, W=hs.sampled_from([1, 4, 5, 32]))
def test_kernel_model_bitwise_to_plain(step, seed, F, slot, comp, queued,
                                       mig, gcs, limits, wait, W):
    """Each kernel's one-pass model against the plain step on the same
    state: every state tensor and every output bitwise."""
    st, c, x = glue_state(seed, L=3, S=2, F=F, slot=slot, comp=comp,
                          queued=queued, mig=mig, gcs=gcs, limits=limits,
                          wait=wait)
    x["W"] = min(W, F)
    st_ref, st_mod = clone_state(st), clone_state(st)
    ref_work = ref.begin(clone_state(st), x["now"], x["dt"])[1]
    mod_work = torch.zeros(5 * 6 + 3, dtype=torch.int32)
    want = _step(ref, step, st_ref, c, x, ref_work)
    got = _step(MODELS, step, st_mod, c, x, mod_work)
    assert_states_equal(st_mod, st_ref)
    if step == "begin":  # the work buffers differ by design
        want, got = want[:1], got[:1]
    for w, g in zip(want or (), got or ()):
        assert bitwise_equal(g, w)


def test_states_cover_what_the_kernels_branch_on():
    """The drawn states reach every branch: inbound and migration
    completions, dropped and deleted copies, resolved jobs, candidates,
    admitted and still-queued transfers, direct and queued migrations on
    empty and busy queues."""
    st, c, x = glue_state(3, L=4, S=2, F=301)
    work = ref.begin(st, x["now"], x["dt"])[1]
    lt = torch.remainder(st["tr_link"], 3)
    assert bool((x["comp"] & (lt == 2)).any())
    assert bool((x["comp"] & (lt != 2) & (st["pend_cnt"] > 0)).any())
    used0, queued0 = st["disk_used"].clone(), st["lq_queued"].clone()
    want, occ3 = ref.complete(st, c, x["now"], x["new_done"], x["comp"],
                              work)
    assert bool((st["disk_used"] < used0).any()) and bool(want.any())
    ref.link_admit(st, c, x["now"], work)
    admitted = queued0 & ~st["lq_queued"]
    assert bool(admitted.any()) and bool(st["lq_queued"].any())
    q0 = st["lq_queued"].clone()
    ref.migrate(st, c, x["now"], x["mig"], x["rank"], occ3, work)
    assert bool((x["mig"] & (st["tr_start"] == x["now"])).any())  # direct
    assert bool((st["lq_queued"] & ~q0).any())


# --------------------------------------- the plain order before the split
def plain_order_glue(st, c, now, dt, month, n_months):
    """The tick's glue in the order the tick ran it before it was split
    into steps: deletions applied after the GCS admission, ``n_direct``
    counted before the queued tickets (``disk_used``'s row sums in the
    glue's fixed order, ``ref.row_sum``)."""
    sizes = c["sizes"]
    L, S, F = sizes.shape
    gcs_en = c["gcs_enabled"]
    no_cons = (st["pend_cnt"] == 0) & (st["fin_max"] <= now)
    t_active = st["tr_slot"] & (st["tr_start"] <= now - dt + 0.5)
    ltype = torch.remainder(st["tr_link"], 3)
    is_t = [ltype == k for k in range(3)]
    (new_done, comp, tape_add, recall_add, mig_add, egress_add,
     cls_a_add, cls_b_add) = lt_ref.transfer_tick(
        st["tr_link"], t_active, st["tr_done"], st["tr_total"], sizes,
        c["bw"], c["mode"], dt, month, n_months)
    comp_mig = comp & is_t[2]
    inbound = comp & (is_t[0] | is_t[1])
    st["disk_state"].masked_fill_(inbound, PRESENT)
    st["gcs_state"].masked_fill_(comp_mig, PRESENT)
    st["tape_b"].add_(tape_add)
    st["gcsdisk_b"].add_(recall_add)
    st["diskgcs_b"].add_(mig_add)
    st["egress_mo"].add_(egress_add)
    st["cls_a_mo"].add_(cls_a_add)
    st["cls_b_mo"].add_(cls_b_add)
    drop_hot = comp_mig & no_cons & (st["disk_state"] == PRESENT)
    st["disk_used"].sub_(ref.row_sum(sizes * drop_hot))
    st["disk_state"].masked_fill_(drop_hot, ABSENT)
    st["tr_slot"].logical_and_(~comp)
    torch.where(comp, c["zero"], new_done, out=st["tr_done"])
    st["tr_total"].masked_fill_(comp, _INF)
    st["tr_start"].masked_fill_(comp, _INF)
    resolve = inbound & (st["pend_cnt"] > 0)
    torch.where(resolve,
                torch.maximum(st["fin_max"], now + st["pend_tail"]),
                st["fin_max"], out=st["fin_max"])
    st["pend_cnt"].masked_fill_(inbound, 0)
    st["pend_tail"].masked_fill_(inbound, 0.0)
    occ = torch.stack([(st["tr_slot"] & m).sum(-1) for m in is_t],
                      dim=-1).to(torch.float32).view(L, 3 * S)
    free = torch.clamp_min(c["slots"] - occ, 0.0)
    n_q = (st["lq_next"] - st["lq_serve"]).to(torch.float32)
    admit = torch.minimum(free, n_q).to(torch.int32)
    st["lq_serve"].add_(admit)
    adm_row = st["lq_queued"] & (
        st["lq_ticket"] < lt_ref.by_type(st["lq_serve"].view(L, S, 3), is_t))
    st["tr_slot"].logical_or_(adm_row)
    torch.where(adm_row,
                now + lt_ref.by_type(c["latency"].view(L, S, 3), is_t),
                st["tr_start"], out=st["tr_start"])
    st["lq_queued"].logical_and_(~adm_row)
    occ3 = (occ + admit.to(torch.float32)).view(L, S, 3)
    lqn3 = st["lq_next"].view(L, S, 3)
    lqs3 = st["lq_serve"].view(L, S, 3)
    slots3 = c["slots"].view(L, S, 3)
    cand = no_cons & (st["disk_state"] == PRESENT) & c["limited"]
    gs = st["gcs_state"]
    pop_ok = c["pop_ok"]
    migratable = gcs_en & (gs == ABSENT) & pop_ok
    delete = cand & (~gcs_en | (gs == PRESENT)
                     | ((gs == ABSENT) & ~pop_ok))
    want_mig = cand & migratable
    mig, gcs_used, gbsec_add, rank = lt_ref.gcs_admit(
        want_mig, sizes, st["gcs_used"], c["gcs_limit"], dt, month,
        n_months, GCS_ADMIT_PASSES)
    st["gcs_used"].copy_(gcs_used)
    gs.masked_fill_(mig, IN_FLIGHT)
    st["disk_used"].sub_(ref.row_sum(sizes * delete))
    st["disk_state"].masked_fill_(delete, ABSENT)
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
    return occ3


def split_glue(glue, st, c, now, dt, month, n_months):
    """The same piece of the tick as the steps of ``glue`` run it."""
    sizes = c["sizes"]
    t_active, work = glue.begin(st, now, dt)
    (new_done, comp, tape_add, recall_add, mig_add, egress_add,
     cls_a_add, cls_b_add) = lt_ref.transfer_tick(
        st["tr_link"], t_active, st["tr_done"], st["tr_total"], sizes,
        c["bw"], c["mode"], dt, month, n_months)
    for key, add in (("tape_b", tape_add), ("gcsdisk_b", recall_add),
                     ("diskgcs_b", mig_add), ("egress_mo", egress_add),
                     ("cls_a_mo", cls_a_add), ("cls_b_mo", cls_b_add)):
        st[key].add_(add)
    want_mig, occ3 = glue.complete(st, c, now, new_done, comp, work)
    glue.link_admit(st, c, now, work)
    mig, gcs_used, gbsec_add, rank = lt_ref.gcs_admit(
        want_mig, sizes, st["gcs_used"], c["gcs_limit"], dt, month,
        n_months, GCS_ADMIT_PASSES)
    st["gcs_used"].copy_(gcs_used)
    glue.migrate(st, c, now, mig, rank, occ3, work)
    return occ3


class _Models:
    """The kernel models as a ``glue`` module (``begin`` ... ``migrate``)."""
    begin = staticmethod(model_begin)
    complete = staticmethod(model_complete)
    link_admit = staticmethod(model_link_admit)
    migrate = staticmethod(model_migrate)
    wait_select = staticmethod(model_wait_select)


@pytest.mark.parametrize("glue", [ref, _Models], ids=["plain", "models"])
@settings(max_examples=25, deadline=None)
@given(seed=hs.integers(0, 2 ** 32 - 1), F=hs.sampled_from([33, 257]),
       slot=_SHARES, comp=_SHARES, queued=_SHARES,
       gcs=hs.sampled_from(["on", "off", "mixed"]),
       limits=hs.sampled_from(["finite", "inf", "mixed"]))
def test_split_steps_bitwise_to_the_plain_order(glue, seed, F, slot, comp,
                                                queued, gcs, limits):
    """Deletions and migration candidates ahead of the link-slot and GCS
    admissions (the plain steps, and the kernel models) against the order
    the tick ran them in before, with the real transfer and GCS
    admissions between them: every state tensor and ``occ3`` bitwise."""
    st, c, x = glue_state(seed, L=3, S=2, F=F, slot=slot, comp=comp,
                          queued=queued, gcs=gcs, limits=limits)
    # completions by the transfer advance: done close to total
    st["tr_done"].copy_(torch.where(st["tr_slot"], st["tr_total"] * 0.999,
                                    st["tr_done"]))
    st_old, st_new = clone_state(st), clone_state(st)
    args = (c, x["now"], x["dt"], x["month"], N_MONTHS)
    occ_old = plain_order_glue(st_old, *args)
    occ_new = split_glue(glue, st_new, *args)
    assert_states_equal(st_new, st_old)
    assert bitwise_equal(occ_new, occ_old)


@settings(max_examples=200, deadline=None)
@given(seed=hs.integers(0, 2 ** 32 - 1), mig=_SHARES,
       slots=hs.sampled_from([0.0, 0.5, 1.0, 2.0, 2.5, 7.0, 300.0, _INF]),
       busy=hs.booleans())
def test_n_direct_closed_form_matches_the_count(seed, mig, slots, busy):
    """A queued migration's ticket ``lq_next + rank - n_direct`` with
    ``n_direct`` in closed form (0 on a busy queue, else ``ceil(free_m)``)
    against ``n_direct`` counted over the row, as the plain order takes
    it: bitwise wherever a migration is queued."""
    rng = np.random.default_rng(seed)
    L, S, F = 2, 2, 200
    m = torch.as_tensor(rng.random((L, S, F)) < mig)
    rank = lt_ref.admission_rank(m)
    occ = torch.as_tensor(rng.integers(0, 4, (L, S, 1)).astype(np.float32))
    free_m = torch.clamp_min(torch.full((L, S, 1), slots) - occ, 0.0)
    q_empty = torch.full((L, S, 1), not busy)
    direct = m & q_empty & (rank < free_m)
    queued = m & ~direct
    counted = rank - direct.sum(-1, keepdim=True, dtype=torch.int32)
    closed = rank - closed_n_direct(q_empty, free_m)
    assert torch.equal(torch.where(queued, closed, 0),
                       torch.where(queued, counted, 0))


# --------------------------------------------- the whole tick, 200 ticks
TINY = dict(days=0.25, n_files=1000)


def _grid(name):
    """``tests/test_torch_batched.py``'s tiny grid (cfg I/II/III, limited
    and unlimited disk, a finite cold tier, a scaled job rate), its
    busy-migration grid (two disk->GCS slots a site, so migrations queue)
    or a waiting grid (1 and 2 TB hot disks, so jobs wait in the wait
    queue), packed by the port."""
    specs = [
        ScenarioSpec(base="III", cache_tb=10.0, seed=1, **TINY),
        ScenarioSpec(base="I", seed=2, **TINY),
        ScenarioSpec(base="II", seed=2, **TINY),
        ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0, seed=3,
                     **TINY),
        ScenarioSpec(base="III", cache_tb=15.0, job_rate_scale=1.5, seed=4,
                     **TINY),
    ]
    if name == "tiny":
        return pack_specs(specs, tick=10.0)
    if name == "waiting":
        return pack_specs([
            ScenarioSpec(base="III", cache_tb=1.0, seed=1, **TINY),
            ScenarioSpec(base="III", cache_tb=2.0, gcs_limit_tb=5.0, seed=3,
                         **TINY)], tick=10.0)
    grid = pack_specs([specs[0], specs[3]], tick=10.0)
    slots = np.array(grid.link_slots, copy=True)
    slots[:, 2::3] = 2.0  # link 3*site + 2: disk -> GCS
    return dataclasses.replace(grid, link_slots=slots)


#: Ticks before the compared window: the first ones complete few
#: transfers and migrate nothing.
WARM_TICKS = 600


@pytest.mark.parametrize("name", ["tiny", "busy", "waiting"])
def test_tick_with_kernel_models_bitwise_over_200_ticks(name, monkeypatch):
    """The plain tick with the kernel models in place of the plain glue
    against the plain tick, from the same state at tick 600, over 200
    ticks: every state tensor bitwise, with completions, admissions,
    migrations (queued ones on the busy grid) and disk_used's sums in the
    window, and files waiting in the wait queue."""
    cpu = torch.device("cpu")
    grid = _grid(name)
    plain = TickLoop(grid, resolve_tick_impl("torch", cpu), cpu, graph=False)
    plain.advance(WARM_TICKS)
    models = copy.deepcopy(plain)
    seen = {"comp": 0, "admitted": 0, "mig": 0, "queued": 0, "waiting": 0,
            "dropped": 0}
    complete, link_admit, migrate = (model_complete, model_link_admit,
                                     model_migrate)

    def counting_complete(st, c, now, new_done, comp, work):
        seen["comp"] += int(comp.sum())
        was = st["disk_used"].clone()
        out = complete(st, c, now, new_done, comp, work)
        seen["dropped"] += int((st["disk_used"] != was).sum())
        return out

    def counting_wait_select(st, W, work):
        seen["waiting"] += int(st["wq_wait"].sum())
        return model_wait_select(st, W, work)

    def counting_link_admit(st, c, now, work):
        before = int(st["lq_queued"].sum())
        link_admit(st, c, now, work)
        seen["admitted"] += before - int(st["lq_queued"].sum())

    def counting_migrate(st, c, now, mig, rank, occ3, work):
        seen["mig"] += int(mig.sum())
        migrate(st, c, now, mig, rank, occ3, work)
        seen["queued"] += int(work[4 * mig.shape[0] * mig.shape[1]:].sum())

    with monkeypatch.context() as mp:
        mp.setattr(ref, "begin", model_begin)
        mp.setattr(ref, "complete", counting_complete)
        mp.setattr(ref, "link_admit", counting_link_admit)
        mp.setattr(ref, "migrate", counting_migrate)
        mp.setattr(ref, "wait_select", counting_wait_select)
        models.advance(200)
    plain.advance(200)
    assert_states_equal(models.st, plain.st)
    assert seen["comp"] > 0 and seen["mig"] > 0 and seen["dropped"] > 0
    if name == "waiting":
        assert seen["waiting"] > 0
    if name == "busy":
        assert seen["queued"] > 0 and seen["admitted"] > 0


# ------------------------------------------------------ wrapper contract
def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU state each wrapper is its plain version, launches nothing,
    and hands back what the plain version does."""
    st, c, x = glue_state(11, L=2, S=2, F=65)
    st_ops, st_ref = clone_state(st), clone_state(st)
    ops.reset_launch_counts()
    for step in ("begin", "complete", "link_admit", "migrate",
                 "wait_select"):
        w_ops = ops.begin(clone_state(st_ops), x["now"], x["dt"])[1]
        w_ref = ref.begin(clone_state(st_ref), x["now"], x["dt"])[1]
        got = _step(ops, step, st_ops, c, x, w_ops)
        want = _step(ref, step, st_ref, c, x, w_ref)
        assert_states_equal(st_ops, st_ref, f"{step}: ")
        n_out = {"link_admit": 0, "wait_select": 2}.get(step, 1)
        for g, w in zip((got or ())[:n_out], (want or ())[:n_out]):
            assert bitwise_equal(g, w)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


# ------------------------------------------ disk_used's row-sum order
def numpy_tree(x):
    """``ref.row_sum``'s order in numpy float32: the row zero-padded to a
    power of two, then adjacent pairs summed level by level."""
    x = np.asarray(x, np.float32)
    width = 1
    while width < x.shape[-1]:
        width *= 2
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (width - x.shape[-1],),
                                    np.float32)], axis=-1)
    while x.shape[-1] > 1:
        x = (x[..., 0::2] + x[..., 1::2]).astype(np.float32)
    return x[..., 0]


def _sizes(F, seed=0, share=0.3):
    """Rows of sizes drawn as the sweep's (1e6 to 1e10 bytes), about
    ``share`` of them kept and the rest zero (a masked size plane)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e6, 1e10, (3, F)).astype(np.float32)
    return np.where(rng.random((3, F)) < share, x, np.float32(0.0))


@pytest.mark.parametrize("F", [1, 3, 4095, 4097, 10_000])
def test_row_sum_is_the_padded_pairwise_tree(F):
    """``ref.row_sum`` against a numpy model of its tree: bitwise."""
    x = _sizes(F)
    got = ref.row_sum(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert np.array_equal(got.numpy().view(np.int32),
                          numpy_tree(x).view(np.int32))


@pytest.mark.parametrize("F,share", [(1, 1.0), (33, 0.3), (4096, 1.0),
                                     (4097, 0.3), (300_000, 0.3),
                                     (300_000, 2e-5), (70_000, 0.0)])
def test_kernel_partition_is_the_whole_tree(F, share):
    """``tg_complete``'s partition (4096-element tile trees, then the tree
    of the tile sums padded to 32 or more) and other power-of-two tiles
    against the whole padded tree: bitwise, since sizes are >= 0 and
    ``a + 0.0 == a``."""
    x = torch.as_tensor(_sizes(F, seed=F, share=share))
    whole = ref.row_sum(x)
    for tile in (COMPLETE_TILE, 1, 128, 1 << 20):
        assert bitwise_equal(tiled_row_sum(x, tile), whole), tile
