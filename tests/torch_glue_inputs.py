"""Seeded numpy states of the sweep tick's glue (``repro_torch.kernels.
tick_glue``), shared by the CPU tests (``test_torch_tick_glue.py``) and the
CUDA tests (``test_torch_kernels_cuda.py``). Imports neither JAX nor the
JAX package, so the CUDA tests run where only PyTorch is installed.

:func:`glue_state` draws one tick's state ``st``, constants ``c`` and the
values the glue takes from the lane-tick kernels (``x``: ``now``, ``dt``,
``new_done``, ``comp``, ``mig``, ``rank``, ``occ3``), with the shares of
held slots, completions, queued transfers and migrations given: every
``disk_state``/``gcs_state`` in {ABSENT, IN_FLIGHT, PRESENT}, empty and
busy link queues, tickets on both sides of their link's serve counter,
consumer horizons before, at and after ``now``, link slots from 0 to
unlimited (fractional ones too), the cold tier on or off per lane and
disk limits finite or infinite per site; and the wait queue (``wq_wait``,
``wq_ticket``) with the share of waiting files given, tickets tied within
a row too (drawn last, so the other draws do not depend on them).
"""

import numpy as np
import torch

N_MONTHS = 4

#: Link-slot counts drawn per link: none, a few, a fractional one,
#: unlimited.
SLOT_CHOICES = np.array([0.0, 1.0, 2.0, 2.5, 5.0, np.inf], np.float32)


def glue_state(seed, L=3, S=2, F=257, slot=0.5, comp=0.3, queued=0.3,
               mig=0.3, gcs="mixed", limits="mixed", wait=0.05,
               device="cpu"):
    """``(st, c, x)``: dicts of tensors on ``device``. ``gcs`` and
    ``limits`` are ``"on"``/``"off"``/``"mixed"`` (the cold tier per lane)
    and ``"finite"``/``"inf"``/``"mixed"`` (disk limits per site)."""
    rng = np.random.default_rng(seed)
    plane = (L, S, F)
    f32, i32 = np.float32, np.int32
    site = np.arange(S)[None, :, None]
    now = f32(rng.uniform(1e3, 1e5))
    dt = f32(10.0)

    tr_link = (3 * site + rng.integers(0, 3, plane)).astype(i32)
    tr_slot = rng.random(plane) < slot
    # a completion holds a slot (transfer_tick completes active ones)
    comp_m = tr_slot & (rng.random(plane) < comp)
    sizes = rng.uniform(1e6, 1e10, plane).astype(f32)
    tr_total = np.where(tr_slot, sizes, np.inf).astype(f32)
    tr_done = np.where(tr_slot, rng.random(plane) * sizes, 0.0).astype(f32)
    new_done = np.where(comp_m, tr_total,
                        np.minimum(tr_total, tr_done * 1.01)).astype(f32)
    # some starts just before, at and after the advance threshold
    thr = f32(f32(now - dt) + f32(0.5))
    start = np.where(rng.random(plane) < 0.1, thr,
                     now - rng.uniform(-5.0, 30.0, plane)).astype(f32)
    tr_start = np.where(tr_slot, start, np.inf).astype(f32)

    lq_serve = rng.integers(0, 50, (L, 3 * S)).astype(i32)
    busy = rng.random((L, 3 * S)) < 0.5
    lq_next = (lq_serve + np.where(busy, rng.integers(1, 20, (L, 3 * S)),
                                   0)).astype(i32)
    lq_queued = ~tr_slot & (rng.random(plane) < queued)
    serve3 = lq_serve.reshape(L, S, 3)
    own = np.take_along_axis(serve3, tr_link % 3, axis=-1)
    lq_ticket = np.where(lq_queued, own + rng.integers(-4, 12, plane),
                         0).astype(i32)

    pend_cnt = np.where(rng.random(plane) < 0.5, 0,
                        rng.integers(1, 4, plane)).astype(i32)
    fin_max = np.where(rng.random(plane) < 0.1, now,
                       now + rng.normal(0.0, 50.0, plane)).astype(f32)
    pend_tail = rng.uniform(0.0, 1e3, plane).astype(f32)

    gcs_on = {"on": np.ones(L, bool), "off": np.zeros(L, bool),
              "mixed": rng.random(L) < 0.5}[gcs]
    finite = {"finite": np.ones((L, S), bool), "inf": np.zeros((L, S), bool),
              "mixed": rng.random((L, S)) < 0.7}[limits]
    mig_m = rng.random(plane) < mig
    csum = np.cumsum(mig_m, axis=-1, dtype=i32)
    rank = np.where(mig_m, csum - 1, -1).astype(i32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    st = dict(
        disk_state=t(rng.integers(0, 3, plane).astype(i32)),
        gcs_state=t(rng.integers(0, 3, plane).astype(i32)),
        disk_used=t(rng.uniform(1e12, 1e13, (L, S)).astype(f32)),
        gcs_used=t(rng.uniform(0.0, 1e12, L).astype(f32)),
        tr_slot=t(tr_slot), tr_link=t(tr_link), tr_done=t(tr_done),
        tr_total=t(tr_total), tr_start=t(tr_start),
        lq_ticket=t(lq_ticket), lq_queued=t(lq_queued),
        lq_serve=t(lq_serve), lq_next=t(lq_next),
        pend_cnt=t(pend_cnt), pend_tail=t(pend_tail), fin_max=t(fin_max),
        tape_b=zeros((L, S)), gcsdisk_b=zeros((L, S)),
        diskgcs_b=zeros((L, S)), egress_mo=zeros((L, N_MONTHS)),
        cls_a_mo=zeros((L, N_MONTHS)), cls_b_mo=zeros((L, N_MONTHS)),
    )
    c = dict(
        sizes=t(sizes),
        gcs_enabled=t(gcs_on[:, None, None]),
        gcs_limit=t(np.where(rng.random(L) < 0.5, np.inf,
                             rng.uniform(1e12, 2e12, L)).astype(f32)),
        limited=t(finite[..., None]),
        pop_ok=t(rng.random(plane) < 0.7),
        slots=t(rng.choice(SLOT_CHOICES, (L, 3 * S))),
        latency=t(rng.uniform(0.0, 100.0, (L, 3 * S)).astype(f32)),
        bw=t(rng.uniform(1e7, 1e9, (L, 3 * S)).astype(f32)),
        mode=t(rng.integers(0, 2, (L, 3 * S)).astype(i32)),
        mig_link=t((3 * site + 2).astype(i32)),
        zero=torch.zeros((), dtype=torch.float32, device=device),
    )
    x = dict(
        now=torch.tensor(now, device=device),
        dt=torch.tensor(dt, device=device),
        month=torch.tensor(1, dtype=torch.int32, device=device),
        new_done=t(new_done), comp=t(comp_m), mig=t(mig_m), rank=t(rank),
        occ3=t(rng.integers(0, 6, (L, S, 3)).astype(f32)),
    )
    st["wq_wait"] = t(rng.random(plane) < wait)
    st["wq_ticket"] = t(rng.integers(0, max(2, int(wait * F)),
                                     plane).astype(i32))
    return st, c, x


def clone_state(st):
    """A copy of every tensor of a state dict."""
    return {k: v.clone() for k, v in st.items()}


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def bitwise_equal(a, b) -> bool:
    """Same dtype, shape and bits (floats compared as integers, so -0.0
    and 0.0 differ)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in _BITS:
        a, b = a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype])
    return torch.equal(a, b)


def assert_states_equal(got, want, what=""):
    """Every tensor of two state dicts bitwise equal."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert bitwise_equal(got[k], w), f"{what}{k}: not bitwise equal"
