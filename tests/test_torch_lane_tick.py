"""The port's lane-tick kernels: plain versions against the JAX package's
Pallas kernels, and the wrapper and registry contract.

On the CPU the plain PyTorch versions (``repro_torch.kernels.lane_tick.
ref``) run lane by lane against ``repro.kernels.lane_tick`` in Pallas
interpret mode on the inputs ``tests/test_kernels.py`` builds:

- transfer: completion mask exact, ``new_done`` at rtol 1e-6 (the Pallas
  trace may fuse a multiply-add), billing at rtol 1e-5 (reduction order);
- shared-GCS admission: the mask exact against the global-cumsum numpy
  oracle (and the interpret kernel), occupancy at rtol 1e-5, the
  migration rank exact (the per-site cumsum of that mask, ``-1`` off it);
- candidate windows: bitwise, each window alone and both of a tick
  (``ref.windows_admit``) against two calls of the Pallas kernel with the
  jnp program's stale-head glue between them.

The CUDA kernels themselves are held against the plain versions on a card
by ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import lane_tick as jx_lane_tick
from repro.kernels.lane_tick.lane_tick import F_BLOCK
from repro_torch.kernels import registry
from repro_torch.kernels.lane_tick import ops, ref

from torch_lane_inputs import (
    MONTH,
    N_MONTHS,
    WINDOW_CASES,
    gcs_inputs,
    scalars,
    stack_transfer,
    transfer_inputs,
    window_inputs,
    windows_inputs,
)
from torch_threads import one_torch_thread  # noqa: F401


def _gcs_numpy_oracle(want, sizes, used0, limit, n_passes):
    """``GCS_ADMIT_PASSES`` passes of one global cumsum over a lane's
    site-major flattened candidate vector (the jnp program's loop)."""
    admitted = np.zeros(want.shape, bool)
    used = np.float32(used0)
    for _ in range(n_passes):
        rem = want & ~admitted
        csum = np.cumsum((sizes * rem).ravel()).reshape(want.shape)
        new = rem & (used + csum <= limit)
        admitted |= new
        used = used + (sizes * new).sum(dtype=np.float64).astype(np.float32)
    return admitted, used


# ----------------------------------------------------- plain vs Pallas (CPU)
def test_transfer_tick_plain_matches_pallas_per_lane():
    lanes = [transfer_inputs(seed=s) for s in range(3)]
    dt, month = scalars()
    got = ref.transfer_tick(*stack_transfer(lanes), dt, month, N_MONTHS)
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    for li, (link_id, active, done, total, sizes, bw, mode) in \
            enumerate(lanes):
        want = jx_lane_tick.transfer_tick(
            jnp.asarray(link_id), jnp.asarray(active), jnp.asarray(done),
            jnp.asarray(total), jnp.asarray(sizes), jnp.asarray(bw),
            jnp.asarray(mode), 50.0, jnp.asarray(onehot), interpret=True)
        np.testing.assert_array_equal(got[1][li].numpy(),
                                      np.asarray(want[1]) > 0.5)
        np.testing.assert_allclose(got[0][li].numpy(), np.asarray(want[0]),
                                   rtol=1e-6)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g[li].numpy(), np.asarray(w),
                                       rtol=1e-5)
        assert got[1][li].any() and (~got[1][li]).any()


def test_gcs_admit_plain_matches_global_cumsum_oracle():
    want, sizes, used0, limit = gcs_inputs()
    dt, month = scalars(dt=60.0)
    adm, used, gbsec, _ = ref.gcs_admit(
        torch.as_tensor(want), torch.as_tensor(sizes),
        torch.as_tensor(used0), torch.as_tensor(limit), dt, month, N_MONTHS,
        n_passes=ref.GCS_ADMIT_PASSES)
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    for li in range(want.shape[0]):
        oracle, used_o = _gcs_numpy_oracle(want[li], sizes[li], used0[li],
                                           limit[li], ref.GCS_ADMIT_PASSES)
        np.testing.assert_array_equal(adm[li].numpy(), oracle)
        np.testing.assert_allclose(float(used[li]), used_o, rtol=1e-5)
        np.testing.assert_allclose(gbsec[li].numpy(),
                                   onehot * (used_o / 1e9 * 60.0), rtol=1e-5)
        pallas = jx_lane_tick.gcs_admit(
            jnp.asarray(want[li]), jnp.asarray(sizes[li]), used0[li],
            limit[li], 60.0, jnp.asarray(onehot),
            n_passes=ref.GCS_ADMIT_PASSES, interpret=True)
        np.testing.assert_array_equal(adm[li].numpy(),
                                      np.asarray(pallas[0]) > 0.5)
    # the finite limits bind, the infinite one admits every candidate
    assert not np.array_equal(adm[0].numpy(), want[0])
    np.testing.assert_array_equal(adm[-1].numpy(), want[-1])


#: Float32 ulps of the limit within which two summation orders of the GCS
#: prefix may decide a candidate differently (``chip_smoke.py``'s bar).
TIE_ULPS = 16


def _dense_gcs_lanes(L=2, S=2, F=300_000, share=0.3, seed=31):
    """Candidates at a dense share with log-normal sizes around 2 GB (the
    tick's catalogue), and finite limits that cut through them."""
    rng = np.random.default_rng(seed)
    want = rng.random((L, S, F)) < share
    sizes = np.exp(rng.normal(np.log(2e9), 1.0, (L, S, F))).astype(
        np.float32)
    used0 = rng.uniform(1e11, 1e12, L).astype(np.float32)
    wanted = (sizes * want).sum((1, 2), dtype=np.float64)
    limit = (used0 + np.linspace(0.4, 0.8, L) * wanted).astype(np.float32)
    return want, sizes, used0, limit


def _drift_margin(want, sizes, used0, limit, n_passes, prefix32):
    """One lane's passes with the float64 gate (``ref.gcs_admit``'s),
    keeping per candidate the least ``|gate - limit| - |c32 - c64|`` over
    the passes that still held it, where ``c64`` is the float64 prefix and
    ``c32`` what ``prefix32`` makes of the same float32 vector: a float32
    program with that prefix must decide a candidate as the float64 gate
    does wherever this margin exceeds a few ulps of the limit.

    Returns ``(admitted, margin, drift)``, ``drift`` the largest
    ``|c32 - c64|`` seen."""
    w, sz = want.ravel(), sizes.ravel()
    adm = np.zeros(w.shape, bool)
    margin = np.full(w.shape, np.inf)
    used, drift = np.float32(used0), 0.0
    for _ in range(n_passes):
        rem = w & ~adm
        x = sz * rem
        c64 = np.cumsum(x.astype(np.float64))
        off = np.abs(prefix32(x).astype(np.float64) - c64)
        drift = max(drift, float(off.max()))
        gate = np.float64(used) + c64
        margin = np.where(rem, np.minimum(
            margin, np.abs(gate - np.float64(limit)) - off), margin)
        new = rem & (gate <= np.float64(limit))
        used = np.float32(np.float64(used) + x[new].sum(dtype=np.float64))
        adm |= new
    return adm.reshape(want.shape), margin.reshape(want.shape), drift


def _pallas_prefix32(S):
    """The float32 prefix of ``repro``'s Pallas ``gcs_admit`` pass over a
    flattened ``[S, F]`` vector: a ``jnp.cumsum`` per site row (padded to
    the kernel's file tile) plus the running float32 total of the rows
    before it."""
    def prefix(x):
        rows = x.reshape(S, -1)
        pad = (-rows.shape[1]) % F_BLOCK
        carry, out = np.float32(0.0), []
        for r in rows:
            rp = jnp.pad(jnp.asarray(r), (0, pad))
            out.append(np.asarray(jnp.cumsum(rp) + carry)[:rows.shape[1]])
            carry = np.float32(carry + np.asarray(jnp.sum(rp)))
        return np.concatenate(out)
    return prefix


def test_gcs_admit_dense_share_within_global_cumsum_drift():
    """At a candidate share of 0.3 (about 180k candidates a lane) the plain
    version may differ from ``repro``'s float32 global-cumsum programs (the
    numpy oracle and the Pallas kernel in interpret mode) only where the
    float64 gate lies within that program's own float32 drift, plus 16
    ulps, of the limit."""
    want, sizes, used0, limit = _dense_gcs_lanes()
    L, S, _ = want.shape
    dt, month = scalars(dt=60.0)
    adm = ref.gcs_admit(torch.as_tensor(want), torch.as_tensor(sizes),
                        torch.as_tensor(used0), torch.as_tensor(limit), dt,
                        month, N_MONTHS)[0].numpy()
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    tol = TIE_ULPS * np.finfo(np.float32).eps * limit
    for li in range(L):
        oracle, _ = _gcs_numpy_oracle(want[li], sizes[li], used0[li],
                                      limit[li], ref.GCS_ADMIT_PASSES)
        pallas = np.asarray(jx_lane_tick.gcs_admit(
            jnp.asarray(want[li]), jnp.asarray(sizes[li]), used0[li],
            limit[li], 60.0, jnp.asarray(onehot),
            n_passes=ref.GCS_ADMIT_PASSES, interpret=True)[0]) > 0.5
        for name, got, prefix32 in (
                ("numpy", oracle, lambda x: np.cumsum(x)),
                ("pallas", pallas, _pallas_prefix32(S))):
            replay, margin, drift = _drift_margin(
                want[li], sizes[li], used0[li], limit[li],
                ref.GCS_ADMIT_PASSES, prefix32)
            np.testing.assert_array_equal(replay, adm[li])
            diff = got != adm[li]
            far = int((diff & (margin > tol[li])).sum())
            print(f"lane {li} {name}: {int(diff.sum())} admissions differ "
                  f"from the plain version, {far} beyond the band; f32 "
                  f"drift {drift / limit[li]:.3g} of the limit")
            assert far == 0
        assert adm[li].sum() < want[li].sum()  # the limit binds


def _chunked_prefix64(x, chunk):
    """Float64 inclusive prefix along the last axis in another order than
    ``torch.cumsum``'s: per-chunk sums, a scan of the chunk totals, then a
    scan inside each chunk from its offset (the CUDA kernel's shape)."""
    L, n = x.shape
    pad = (-n) % chunk
    xc = torch.nn.functional.pad(x, (0, pad)).view(L, -1, chunk)
    totals = xc.sum(-1)
    offsets = torch.cumsum(totals, -1) - totals
    return (offsets[..., None] + torch.cumsum(xc, -1)).view(L, -1)[:, :n]


def test_gcs_f64_gate_is_order_free():
    """The float64 gate decides every candidate alike whether the prefix
    is ``torch.cumsum``'s or a chunked one, while two float32 orders of the
    same prefix drift apart by more than the 16-ulp band."""
    want, sizes, used0, limit = (torch.as_tensor(a)
                                 for a in _dense_gcs_lanes(L=3, seed=32))
    L = want.shape[0]
    w, sz = want.reshape(L, -1), sizes.reshape(L, -1)
    lim = limit.double()[:, None]
    adm_ref = ref.gcs_admit(want, sizes, used0, limit, *scalars(),
                            N_MONTHS)[0].reshape(L, -1)
    for chunk in (8192, 1000):
        adm = torch.zeros_like(w)
        used = used0
        for _ in range(ref.GCS_ADMIT_PASSES):
            rem = w & ~adm
            x = (sz * rem).double()
            new = rem & (used.double()[:, None]
                         + _chunked_prefix64(x, chunk) <= lim)
            used = (used.double() + (sz * new).double().sum(1)).float()
            adm = adm | new
        assert torch.equal(adm, adm_ref)
        assert bool((adm != w).any(1).all())  # every limit binds
    x32 = (sz * w).numpy()
    seq = np.cumsum(x32, axis=1)
    chunked = _chunked_prefix64(torch.as_tensor(x32), 8192).float().numpy()
    band = TIE_ULPS * np.finfo(np.float32).eps * np.abs(seq[:, -1:])
    print(f"f32 orders differ by up to "
          f"{float((np.abs(seq - chunked) / band).max()):.1f} bands")
    assert bool((np.abs(seq - chunked) > band).any())


def test_gcs_gate_distance_replays_the_plain_passes():
    want, sizes, used0, limit = (torch.as_tensor(a) for a in gcs_inputs())
    L = want.shape[0]
    adm, used, gbsec, _ = ref.gcs_admit(want, sizes, used0, limit,
                                        *scalars(), N_MONTHS)
    replay, used_r, dist = ref.gcs_gate_distance(want, sizes, used0, limit)
    assert torch.equal(replay, adm.reshape(L, -1))
    assert torch.equal(used_r, used)
    assert dist.dtype == torch.float64
    w = want.reshape(L, -1)
    assert bool(torch.isinf(dist[~w]).all())
    finite = torch.isfinite(limit)
    assert bool(torch.isfinite(dist[finite][w[finite]]).all())
    assert bool(torch.isinf(dist[~finite]).all())
    # the first candidate's gate is the occupancy plus its size
    first = w.to(torch.int8).argmax(1)
    d0 = dist.gather(1, first[:, None])[:, 0]
    s0 = sizes.reshape(L, -1).gather(1, first[:, None])[:, 0].double()
    gate0 = used0.double() + s0
    assert torch.equal(d0[finite], (gate0 - limit.double()).abs()[finite])


def _site_rank(mask):
    """The jnp tick's migration rank (``repro/sim/batched.py:337``): the
    per-site cumsum of the admitted mask, minus one, ``-1`` off the mask."""
    return np.where(mask, np.cumsum(mask, axis=-1) - 1, -1).astype(np.int32)


@pytest.mark.parametrize("seed", [7, 8])
def test_gcs_admit_rank_is_site_cumsum_of_jnp_admissions(seed):
    want, sizes, used0, limit = gcs_inputs(seed=seed)
    dt, month = scalars(dt=60.0)
    adm, _, _, rank = ref.gcs_admit(
        torch.as_tensor(want), torch.as_tensor(sizes),
        torch.as_tensor(used0), torch.as_tensor(limit), dt, month, N_MONTHS)
    assert rank.dtype == torch.int32 and rank.shape == adm.shape
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    for li in range(want.shape[0]):
        oracle, _ = _gcs_numpy_oracle(want[li], sizes[li], used0[li],
                                      limit[li], ref.GCS_ADMIT_PASSES)
        np.testing.assert_array_equal(rank[li].numpy(), _site_rank(oracle))
        pallas = jx_lane_tick.gcs_admit(
            jnp.asarray(want[li]), jnp.asarray(sizes[li]), used0[li],
            limit[li], 60.0, jnp.asarray(onehot),
            n_passes=ref.GCS_ADMIT_PASSES, interpret=True)
        np.testing.assert_array_equal(
            rank[li].numpy(), _site_rank(np.asarray(pallas[0]) > 0.5))
    # every site of the unlimited lane ranks 0..n-1 over its candidates
    for s in range(want.shape[1]):
        got = rank[-1, s].numpy()
        np.testing.assert_array_equal(np.sort(got[want[-1, s]]),
                                      np.arange(want[-1, s].sum()))


def test_admission_rank_restarts_per_site_row():
    T, F = True, False
    mask = torch.tensor([[[T, F, T, T], [F, T, F, T]],
                         [[F, F, F, F], [T, T, F, F]]])
    assert ref.admission_rank(mask).tolist() == [
        [[0, -1, 1, 2], [-1, 0, -1, 1]],
        [[-1, -1, -1, -1], [0, 1, -1, -1]]]


@pytest.mark.parametrize("fifo", [False, True])
def test_window_admit_plain_bitwise_vs_pallas(fifo):
    live, size, used, limit = window_inputs(fifo)
    adm, extra = ref.window_admit(torch.as_tensor(live),
                                  torch.as_tensor(size),
                                  torch.as_tensor(used),
                                  torch.as_tensor(limit), fifo)
    for li in range(live.shape[0]):
        want_adm, want_extra = jx_lane_tick.window_admit(
            jnp.asarray(live[li]), jnp.asarray(size[li]),
            jnp.asarray(used[li]), jnp.asarray(limit[li]), fifo=fifo,
            interpret=True)
        np.testing.assert_array_equal(adm[li].numpy(),
                                      np.asarray(want_adm) > 0.5)
        np.testing.assert_array_equal(extra[li].numpy(),
                                      np.asarray(want_extra))


def _jx_windows(absent, size_k, fid_k, valid_w, present_w, size_w, idx_w,
                used, limit):
    """One lane of the jnp tick's two windows (``repro/sim/batched.py``
    :433-447 and :474-501): the Pallas window kernel (interpret mode) on
    the K job window, the occupancy it leaves, the stale heads, the Pallas
    kernel on the W wait-queue window."""
    S, K = absent.shape
    started = np.zeros((S, K), bool)
    if K > 0:
        started_f, extra = jx_lane_tick.window_admit(
            jnp.asarray(absent), jnp.asarray(size_k), jnp.asarray(used),
            jnp.asarray(limit), fifo=False, interpret=True)
        started = np.asarray(started_f) > 0.5
        used = jnp.asarray(used) + extra
    started_fid = np.where(started, fid_k, -1)
    jumped = np.any(idx_w[:, :, None] == started_fid[:, None, :], axis=2)
    stale = valid_w & (present_w | jumped)
    adm_f, extra_w = jx_lane_tick.window_admit(
        jnp.asarray(valid_w & ~stale), jnp.asarray(size_w),
        jnp.asarray(used), jnp.asarray(limit), fifo=True, interpret=True)
    return (started, np.asarray(adm_f) > 0.5, stale,
            np.asarray(jnp.asarray(used) + extra_w))


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windows_admit_plain_bitwise_vs_pallas_with_glue(case):
    args = windows_inputs(case)
    got = ref.windows_admit(*map(torch.as_tensor, args))
    for li in range(args[0].shape[0]):
        want = _jx_windows(*(a[li] for a in args))
        for name, g, w in zip(("started", "admitted", "stale", "disk_used"),
                              got, want):
            np.testing.assert_array_equal(g[li].numpy(), w, err_msg=name)
    started, admitted, stale, used = (g.numpy() for g in got)
    # each case exercised what it names
    if case == "duplicate_fids":
        assert started[..., 0].all() and started[..., 1].all()
        assert stale[..., 0].all()
    elif case == "head_started":
        assert stale[..., 0].all() and not stale[..., 1].any()
    elif case == "head_blocking":
        assert not admitted.any() and not stale.any()
    elif case == "k0":
        assert started.shape[-1] == 0 and admitted.any()
    elif case == "nothing_fits":
        assert not started.any() and not admitted.any()
    elif case == "sum_at_limit":
        assert (used == np.float32(2.0 ** 33)).all()
        assert started[:, 1::2, 3].all() and admitted[:, ::2, 2].all()


# ------------------------------------------------ wrapper/registry contract
def test_cpu_tensors_go_to_the_plain_versions_without_launching():
    ops.reset_launch_counts()
    lanes = [transfer_inputs(seed=s) for s in range(2)]
    dt, month = scalars()
    args = stack_transfer(lanes)
    for a, b in zip(ops.transfer_tick(*args, dt, month, N_MONTHS),
                    ref.transfer_tick(*args, dt, month, N_MONTHS)):
        assert torch.equal(a, b)
    want, sizes, used0, limit = (torch.as_tensor(a) for a in gcs_inputs())
    for a, b in zip(ops.gcs_admit(want, sizes, used0, limit, dt, month,
                                  N_MONTHS),
                    ref.gcs_admit(want, sizes, used0, limit, dt, month,
                                  N_MONTHS)):
        assert torch.equal(a, b)
    win = [torch.as_tensor(a) for a in windows_inputs("random")]
    for a, b in zip(ops.windows_admit(*win), ref.windows_admit(*win)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_registry_resolution():
    assert registry.resolve_tick_impl("auto", "cpu").name == "torch"
    assert registry.resolve_tick_impl("torch", "cpu").name == "torch"
    assert not registry.resolve_tick_impl("torch", "cpu").use_kernel
    with pytest.raises(ValueError, match="CUDA device"):
        registry.resolve_tick_impl("cuda", "cpu")
    for bad in ("jnp", "pallas", "fortran", True):
        with pytest.raises(ValueError, match="tick_impl"):
            registry.resolve_tick_impl(bad, "cpu")
    assert registry.TICK_IMPL_CHOICES == ("auto", "torch", "cuda")


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.core.scenarios import ScenarioSpec, pack_specs
    from repro_torch.sim.batched import run_sweep_torch, simulate_packed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.resolve_tick_impl("auto")
    grid = pack_specs([ScenarioSpec(days=0.01, n_files=50)], tick=60.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_packed(grid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_packed(grid, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sweep_torch([ScenarioSpec(days=0.01, n_files=50)])
