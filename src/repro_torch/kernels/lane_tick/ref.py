"""Plain PyTorch versions of the three lane-tick kernels.

These are the oracles: the CPU tests hold them against ``repro``'s Pallas
kernels (interpret mode) and its jnp tick program, and ``chip_smoke.py``
holds the CUDA kernels (``csrc/lane_tick.cu``) against them on the card.
Every function takes the lane axis explicitly (``[L, S, F]`` planes,
``[L, S]`` per-site and ``[L]`` per-lane vectors) and keeps the operation
order of the jnp branch of ``repro.sim.batched._lane_step_fns``:

- :func:`transfer_tick` — ``batched.py:217-250``;
- :func:`gcs_admit` — ``batched.py:318-329`` plus the end-of-tick GB-second
  integration (``:582``) and the per-site migration rank (``:337``);
- :func:`window_admit` — ``batched.py:438-446`` (``fifo=False``) and
  ``:490-500`` (``fifo=True``);
- :func:`windows_admit` — both windows of the tick with the glue between
  them (``batched.py:433-447`` and ``:474-501``).

Masks are ``torch.bool``; the month is a 0-d integer tensor and the month
deltas come back as ``[L, n_months]`` rows that are zero outside it.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Refinement passes of the shared-GCS admission gate (``repro.sim.batched.
#: GCS_ADMIT_PASSES``): each pass admits the next fitting run of candidates
#: past a too-big blocker.
GCS_ADMIT_PASSES = 3


def month_onehot(month: torch.Tensor, n_months: int) -> torch.Tensor:
    """``[n_months]`` f32 selector of the 0-d ``month`` index."""
    return (torch.arange(n_months, device=month.device)
            == month).to(torch.float32)


def by_type(x3: torch.Tensor, is_t) -> torch.Tensor:
    """Select ``x3[l, s, type]`` per element of an ``[L, S, F]`` plane, the
    link type given as its three masks (a file only transfers on its own
    site's links, so ``3*site + type`` addressing reduces to this)."""
    return torch.where(is_t[0], x3[..., 0:1],
                       torch.where(is_t[1], x3[..., 1:2], x3[..., 2:3]))


def transfer_tick(link_id, active, done, total, sizes, bw, mode, dt, month,
                  n_months: int) -> Tuple[torch.Tensor, ...]:
    """One transfer tick over every lane's ``[L, S, F]`` transfer planes,
    with its completion billing.

    link_id: ``[L,S,F]`` i32 (``3*site + type``); active: ``[L,S,F]`` bool;
    done/total/sizes: ``[L,S,F]`` f32; bw: ``[L,3S]`` f32; mode: ``[L,3S]``
    i32 (1 = per-transfer throughput); dt: 0-d f32; month: 0-d int.

    Returns ``(new_done f32, completed bool, tape_bytes [L,S],
    recall_bytes [L,S], migrate_bytes [L,S], egress [L,n_months],
    class_a [L,n_months], class_b [L,n_months])``.
    """
    L, S, F = link_id.shape
    ltype = torch.remainder(link_id, 3)  # 0 tape->disk, 1 gcs->disk, 2 disk->gcs
    is_t = [ltype == k for k in range(3)]
    act_f = active.to(torch.float32)
    counts = torch.stack([(active & m).sum(-1) for m in is_t],
                         dim=-1).to(torch.float32)  # [L, S, 3]
    bw_i = by_type(bw.view(L, S, 3), is_t)
    cnt_i = by_type(counts, is_t)
    mode_i = by_type(mode.view(L, S, 3), is_t)
    shared = bw_i / torch.clamp_min(cnt_i, 1.0)
    rate = torch.where(mode_i > 0, bw_i, shared)
    new_done = torch.minimum(total, done + act_f * rate * dt)
    comp = (new_done >= total) & active
    comp_recall = comp & is_t[1]
    comp_mig = comp & is_t[2]
    tape = (sizes * (comp & is_t[0])).sum(-1)
    recall = (sizes * comp_recall).sum(-1)
    mig = (sizes * comp_mig).sum(-1)
    onehot = month_onehot(month, n_months)
    # the lane's egress from its sites' sums, as the kernel folds it: a
    # sum over one row per lane would change its order with the number of
    # lanes (PyTorch splits a single output's reduction across threads)
    egress = onehot * recall.sum(-1)[:, None]
    cls_a = onehot * comp_mig.sum((1, 2)).to(torch.float32)[:, None]
    cls_b = onehot * comp_recall.sum((1, 2)).to(torch.float32)[:, None]
    return new_done, comp, tape, recall, mig, egress, cls_a, cls_b


def admission_rank(admitted: torch.Tensor) -> torch.Tensor:
    """Position of each admitted file among the admitted files of its own
    (lane, site) row: ``cumsum(admitted, -1) - 1`` where ``admitted``
    holds, ``-1`` elsewhere (int32, the shape of ``admitted``)."""
    csum = torch.cumsum(admitted, dim=-1, dtype=torch.int32)
    return torch.where(admitted, csum - 1, -1)


def gcs_admit(want, sizes, used, limit, dt, month, n_months: int,
              n_passes: int = GCS_ADMIT_PASSES):
    """Shared-capacity admission over every lane's ``[L, S, F]`` candidate
    plane: ``n_passes`` passes of one global cumsum per lane over the
    site-major flattened ``S*F`` vector, each gated on the pass-start
    occupancy, fused with the GB-second integration of the final occupancy
    and the per-site rank of each admission (:func:`admission_rank`).

    The prefix and the gate are float64: a float32 prefix over hundreds of
    thousands of sizes drifts by about a hundred float32 ulps of the total
    with its summation order, while two float64 orders agree to about
    ``n * 2**-53`` of it, far inside a float32 ulp: the CUDA kernel's
    block scans and ``torch.cumsum`` decide alike except within about a
    float32 ulp of the limit. ``used'`` is each pass's float64 sum rounded
    to float32 once.

    want: ``[L,S,F]`` bool; sizes: ``[L,S,F]`` f32; used/limit: ``[L]`` f32;
    dt: 0-d f32; month: 0-d int.

    Returns ``(admitted [L,S,F] bool, used' [L] f32, gbsec [L,n_months],
    rank [L,S,F] int32)``.
    """
    admitted, used, _ = _gcs_passes(want, sizes, used, limit, n_passes,
                                    with_dist=False)
    gbsec = month_onehot(month, n_months) * (used / 1e9 * dt)[:, None]
    admitted = admitted.view(want.shape)
    return admitted, used, gbsec, admission_rank(admitted)


def gcs_gate_distance(want, sizes, used, limit,
                      n_passes: int = GCS_ADMIT_PASSES):
    """The passes of :func:`gcs_admit`, keeping per candidate the least
    distance ``|used + cumsum - limit|`` (float64) of its gate value to the
    limit over the passes that still held it (``inf`` elsewhere): how near
    each decision came to a tie.

    Returns ``(admitted [L, S*F] bool, used' [L] f32, dist [L, S*F] f64)``.
    """
    return _gcs_passes(want, sizes, used, limit, n_passes, with_dist=True)


def _gcs_passes(want, sizes, used, limit, n_passes: int, with_dist: bool):
    L = want.shape[0]
    want_flat = want.reshape(L, -1)
    sizes_flat = sizes.reshape(L, -1)
    limit64 = limit.double()[:, None]
    admitted = torch.zeros_like(want_flat)
    dist = None
    if with_dist:
        dist = torch.full(sizes_flat.shape, float("inf"),
                          dtype=torch.float64, device=sizes.device)
    for _ in range(n_passes):
        rem = want_flat & ~admitted
        gate = used.double()[:, None] + torch.cumsum(
            (sizes_flat * rem).double(), dim=1)
        if with_dist:
            dist = torch.where(rem, torch.minimum(
                dist, (gate - limit64).abs()), dist)
        new = rem & (gate <= limit64)
        # per site, then over the sites: an order that does not change
        # with the number of lanes
        site_bytes = (sizes * new.view_as(sizes)).double().sum(-1)
        used = (used.double() + site_bytes.sum(-1)).float()
        admitted = admitted | new
    return admitted, used, dist


def window_admit(live, size, disk_used, disk_limit, fifo: bool):
    """Admission over a ``[L, S, C]`` candidate window against per-site disk
    headroom: later candidates see earlier reservations. ``fifo=False``
    skips a candidate that does not fit (this tick's job arrivals);
    ``fifo=True`` lets a live head that does not fit block everything
    behind it (the waiting queue, §5.2).

    Returns ``(admitted [L,S,C] bool, extra_bytes [L,S] f32)``.
    """
    C = live.shape[-1]
    extra = torch.zeros_like(disk_used)
    if C == 0:
        return torch.zeros_like(live), extra
    blocked = torch.zeros_like(live[..., 0])
    cols = []
    for k in range(C):
        size_k = size[..., k]
        fit = disk_used + extra + size_k <= disk_limit
        live_k = live[..., k]
        if fifo:
            adm = live_k & fit & ~blocked
            blocked = blocked | (live_k & ~fit)
        else:
            adm = live_k & fit
        cols.append(adm)
        extra = extra + torch.where(adm, size_k, 0.0)
    return torch.stack(cols, dim=-1), extra


def windows_admit(absent, size_k, fid_k, valid_w, present_w, size_w, idx_w,
                  disk_used, disk_limit):
    """The tick's two candidate windows against one disk headroom: the K
    window of job arrivals (:func:`window_admit`, ``fifo=False``), then the
    W window of wait-queue heads (``fifo=True``) from the occupancy the
    first one left. A head is stale, and skipped, when its file is no
    longer absent (``present_w``) or a started K slot holds its file.

    absent: ``[L,S,K]`` bool; size_k: ``[L,S,K]`` f32; fid_k: ``[L,S,K]``
    int64; valid_w/present_w: ``[L,S,W]`` bool; size_w: ``[L,S,W]`` f32;
    idx_w: ``[L,S,W]`` int64; disk_used/disk_limit: ``[L,S]`` f32.

    Returns ``(started [L,S,K], admitted [L,S,W], stale [L,S,W],
    disk_used' [L,S] f32)``.
    """
    started, extra = window_admit(absent, size_k, disk_used, disk_limit,
                                  False)
    used = disk_used + extra
    started_fid = torch.where(started, fid_k, -1)
    jumped = (idx_w[..., :, None] == started_fid[..., None, :]).any(-1)
    stale = valid_w & (present_w | jumped)
    admitted, extra_w = window_admit(valid_w & ~stale, size_w, used,
                                     disk_limit, True)
    return started, admitted, stale, used + extra_w
