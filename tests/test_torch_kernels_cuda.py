"""The port's CUDA kernels against their plain versions, on a CUDA device.

Every test here is marked ``cuda`` and skips without a device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed::

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Bars: transfer ``new_done`` and completion bitwise (the kernel rounds like
the plain version's separate ops), billing at rtol 1e-6 (reduction
order), at active shares from 0 to 1, two calls bitwise equal; both
candidate windows of a tick bitwise in one launch; the ``cuda`` sweep
replayed from a CUDA graph bitwise to the same path run eagerly, with
every replayed launch counted; GCS admission equal except at capacity-boundary ties within 16
float32 ulps of the limit (both sides take the prefix in float64, in
different orders), also at a candidate share of 0.3, occupancy at
rtol 1e-5, the migration rank bitwise against the per-site rank of the
kernel's own mask (and of the plain version's, where the masks agree),
two calls bitwise equal; carousel ``new_done``, completion and counts
bitwise (the kernel rounds like the plain version, counts are integer
atomics); the tick engine's final ``active``/``done`` and every tick's
completions bitwise to the plain engine's, its carried counts equal to a
recount, its inputs unchanged and one launch a tick counted through the
graph replays;
attention in float32 at 2e-5 atol/rtol (the tf32x3 kernel: each product
in three TF32 terms of split operands), in bfloat16 at atol 4e-3 and
rtol 8e-3 with at most 1% of the elements unequal (both sides compute in
float32, the wgmma kernel carrying its probabilities as two bf16 halves,
and round once, so they differ by at most one ulp and only next to a
rounding boundary; SDPA, which rounds its probabilities to bfloat16,
differs on about 40%), each case through the kernel its dtype routes to
and, in bfloat16, the loader its width needs (TMA at a multiple of 8,
else the producer's threads), the served families' uses among the
cases (non-causal T = S and T != S at hd 64, hd 96, a GQA group of 7);
the new families served at their smoke widths in float32 through the
kernel and through the plain versions (logits at 1e-3, tokens equal,
one launch an attention call), and the wgmma kernel's pieces with each
loader and the tf32x3 kernel's bitwise on integer inputs; the
Mamba scan and its final state at 1e-4 (the sum over the state runs in
another order), from dA and dBu and from u, dt, A, B and C (the fused
entry, bf16 inputs widened, B and C strided); the execution layer on the ``cuda`` sweep: lane chunks,
a device list, retryable chunk jobs under injected faults and a fleet of
two worker processes, each bitwise to the unchunked run, and series
capture with the replayed tick's series bitwise to the eager tick's and
one launch of each kernel a tick. Training: under autograd the
attention kernel's and the fused scan's gradients are the plain route's
bitwise (their backward is the plain version's, recomputed), an entry
without a backward refuses inputs that require grad, and one step of
three smoke configs in float32 with remat matches the plain route (loss
rtol 1e-4, each gradient leaf's relative L2 within 1e-3) with each
kernel launched twice a layer. The tick's tracing: a traced captured
tick launches the untraced tick's lane-tick and glue kernels and the
trace library's stamps and count only (nothing of it untraced), its
counts equal the eager kernel tick's and the plain tick's exactly, its
stamps cover the replayed ticks, and the count kernel equals the plain
count in 16-byte and byte loads.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.carousel_update import ops as cu_ops
from repro_torch.kernels.carousel_update import ref as cu_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lane_tick import ops, ref
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref
from repro_torch.kernels.tick_glue import ops as tg_ops
from repro_torch.kernels.tick_glue import ref as tg_ref
from torch_glue_inputs import assert_states_equal, bitwise_equal, glue_state
from torch_lane_inputs import (
    N_MONTHS,
    WINDOW_CASES,
    gcs_inputs,
    scalars,
    stack_transfer,
    transfer_inputs,
    windows_inputs,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_transfer_tick_bitwise(cuda_device):
    lanes = [transfer_inputs(S=2, F=5000, seed=s) for s in range(3)]
    dt, month = scalars(cuda_device)
    args = stack_transfer(lanes, cuda_device)
    before = ops.launch_counts()["transfer_tick"]
    got = ops.transfer_tick(*args, dt, month, N_MONTHS)
    want = ref.transfer_tick(*args, dt, month, N_MONTHS)
    torch.cuda.synchronize()
    assert ops.launch_counts()["transfer_tick"] == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)


def _transfer_case(L, S, F, share, seed=0, one_type_row=False):
    """Seeded transfer planes with a share ``share`` of active transfers: a
    quarter of the files already at their total (active ones complete at
    any rate), the others within 1% of it; sizes 1 MB to 1 GB, links 100
    kB/s to 10 MB/s, half per-transfer. ``one_type_row``: every active
    transfer of row 0 on the gcs->disk link (type 1)."""
    rng = np.random.default_rng(seed)
    site = np.arange(S)[None, :, None]
    ltype = rng.integers(0, 3, (L, S, F))
    active = rng.random((L, S, F)) < share
    if one_type_row:
        ltype[0, 0] = 1
    link_id = (3 * site + ltype).astype(np.int32)
    total = rng.uniform(1e6, 1e9, (L, S, F)).astype(np.float32)
    done = np.where(rng.random((L, S, F)) < 0.25, total,
                    total * (1.0 - 0.01 * rng.random((L, S, F)))
                    ).astype(np.float32)
    sizes = total.copy()
    bw = rng.uniform(1e5, 1e7, (L, 3 * S)).astype(np.float32)
    mode = rng.integers(0, 2, (L, 3 * S)).astype(np.int32)
    return [link_id, active, done, total, sizes, bw, mode]


def _transfer_run(args, device):
    """Two kernel calls and the plain version on the same inputs: each call
    launches once, both give the same bits, new_done and the completions
    equal the plain version's bitwise and the billing is within rtol 1e-6.
    Returns the kernel's outputs."""
    dt, month = scalars(device)
    before = ops.launch_counts()["transfer_tick"]
    got = ops.transfer_tick(*args, dt, month, N_MONTHS)
    assert ops.launch_counts()["transfer_tick"] == before + 1
    again = ops.transfer_tick(*args, dt, month, N_MONTHS)
    assert ops.launch_counts()["transfer_tick"] == before + 2
    want = ref.transfer_tick(*args, dt, month, N_MONTHS)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
    return got


TRANSFER_CASES = {
    # name: (L, S, F, active share, extra)
    "share 0": (2, 2, 50_000, 0.0, {}),
    "share 3e-4": (2, 2, 200_000, 3e-4, {}),
    "share 0.3": (2, 2, 200_000, 0.3, {}),
    "share 1": (2, 2, 200_000, 1.0, {}),
    "F not a multiple of the tile": (2, 3, 3 * 4096 + 100, 0.05, {}),
    "F not a multiple of 4, byte loads": (2, 3, 10_001, 0.05, {}),
    "a row's actives of one link type": (2, 2, 20_000, 0.2,
                                         {"one_type_row": True}),
    "many rows": (16, 4, 3000, 0.1, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRANSFER_CASES))
def test_cuda_transfer_tick_by_share_and_shape(cuda_device, case):
    L, S, F, share, extra = TRANSFER_CASES[case]
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _transfer_case(L, S, F, share, **extra)]
    got = _transfer_run(args, cuda_device)
    n_act = int(args[1].sum())
    assert int(got[1].sum()) > 0 or n_act == 0
    if share == 0.0:
        assert not bool(got[1].any())
        assert not bool(torch.cat([g.reshape(-1) for g in got[2:]]).any())


@pytest.mark.cuda
def test_cuda_transfer_tick_unaligned_planes(cuda_device):
    """Planes that start one element past a 16-byte line take the byte
    path (contiguous views into a larger buffer)."""
    args = [torch.as_tensor(a, device=cuda_device)
            for a in _transfer_case(2, 2, 8192, 0.1, seed=5)]
    for i in range(5):
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                          device=cuda_device)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        args[i] = view
    _transfer_run(args, cuda_device)


def _gcs_run(want, sizes, used, limit, dt=10.0, month=1):
    """One kernel call and the plain version on the same inputs; the kernel
    must launch once and its rank be the per-site rank of its own mask."""
    dev = want.device
    dt_t = torch.tensor(dt, dtype=torch.float32, device=dev)
    month_t = torch.tensor(month, dtype=torch.int32, device=dev)
    before = ops.launch_counts()["gcs_admit"]
    got = ops.gcs_admit(want, sizes, used, limit, dt_t, month_t, N_MONTHS)
    plain = ref.gcs_admit(want, sizes, used, limit, dt_t, month_t, N_MONTHS)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gcs_admit"] == before + 1
    assert got[0].dtype == torch.bool and got[3].dtype == torch.int32
    assert got[0].shape == want.shape and got[3].shape == want.shape
    assert torch.equal(got[3], ref.admission_rank(got[0]))
    return got, plain


def _assert_gcs_equal(got, plain):
    """Mask and rank bitwise, occupancy and GB-seconds at rtol 1e-6."""
    assert torch.equal(got[0], plain[0])
    assert torch.equal(got[3], plain[3])
    torch.testing.assert_close(got[1], plain[1], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_cuda_gcs_admit_matches_plain(cuda_device):
    want, sizes, used0, limit = (torch.as_tensor(a, device=cuda_device)
                                 for a in gcs_inputs(S=2, F=20000))
    got, plain = _gcs_run(want, sizes, used0, limit)
    assert int((got[0] != plain[0]).sum()) <= 2
    torch.testing.assert_close(got[1], plain[1], rtol=1e-5, atol=0.0)
    assert torch.equal(got[0][-1], want[-1])  # unlimited lane
    if torch.equal(got[0], plain[0]):
        assert torch.equal(got[3], plain[3])


def _gcs_case(case, device):
    """(want, sizes, used, limit) of one edge case; sizes 1 MB to 1 GB,
    occupancy 1 to 3 GB, the last lane unlimited where L > 1."""
    L, S, F = {"no candidates": (3, 2, 5000),
               "all candidates": (3, 4, 3000),
               "last partial tile, vector loads": (2, 2, 5000),
               "last partial tile, byte loads": (2, 2, 5001),
               "N not a multiple of the tile": (3, 3, 4099),
               "unaligned want": (2, 2, 4096),
               "L = 1": (1, 2, 7000),
               "sites without candidates": (2, 5, 3000)}[case]
    rng = np.random.default_rng(len(case))
    sizes = rng.uniform(1e6, 1e9, (L, S, F)).astype(np.float32)
    used = rng.uniform(1e9, 3e9, L).astype(np.float32)
    want = rng.random((L, S, F)) < 0.3
    if case == "no candidates":
        want[:] = False
    elif case == "all candidates":
        want[:] = True
    elif case.startswith("last partial tile"):
        tile = 4096  # the kernel's tile of candidate flags
        flat = want.reshape(L, S * F)
        flat[:, :(S * F - 1) // tile * tile] = False
    elif case == "sites without candidates":
        want[:, 1] = False
        want[:, 3] = False
    wanted = (sizes * want).sum((1, 2))
    limit = (used + 0.5 * wanted).astype(np.float32)
    if L > 1:
        limit[-1] = np.inf
    t = [torch.as_tensor(a, device=device)
         for a in (want, sizes, used, limit)]
    if case == "unaligned want":  # contiguous, one byte past 16-byte lines
        buf = torch.zeros(want.size + 1, dtype=torch.bool, device=device)
        t[0] = buf[1:].view(want.shape)
        t[0].copy_(torch.as_tensor(want, device=device))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "no candidates", "all candidates", "last partial tile, vector loads",
    "last partial tile, byte loads", "N not a multiple of the tile",
    "unaligned want", "L = 1", "sites without candidates"])
def test_cuda_gcs_admit_edge_cases(cuda_device, case):
    want, sizes, used, limit = _gcs_case(case, cuda_device)
    got, plain = _gcs_run(want, sizes, used, limit)
    # a lane with a finite limit: equal to the plain version but at ties
    n_diff = int((got[0] != plain[0]).sum())
    assert n_diff <= 2, f"{n_diff} admissions differ"
    if n_diff == 0:
        _assert_gcs_equal(got, plain)
    if want.shape[0] > 1:  # the unlimited lane admits every candidate
        assert torch.equal(got[0][-1], want[-1])
    if case == "no candidates":
        assert not bool(got[0].any()) and bool((got[3] == -1).all())
        assert torch.equal(got[1], used)


@pytest.mark.cuda
def test_cuda_gcs_admit_limit_at_first_candidate(cuda_device):
    """A limit equal to the occupancy plus the first candidate's size
    admits exactly that candidate in every lane (an exact tie at the
    gate, the same float sum on both sides)."""
    want, sizes, used, _ = _gcs_case("L = 1", cuda_device)
    want, sizes = want.repeat(3, 1, 1), sizes.repeat(3, 1, 1)
    used = used.repeat(3) + torch.tensor([0.0, 1e9, 2e9], device=cuda_device)
    flat = want.reshape(3, -1)
    first = flat.to(torch.int8).argmax(1)
    # multiples of 1 kB below 16 GB: the float32 sum of the occupancy
    # and the first size is exact, so the float64 gate meets it too
    used = torch.round(used / 1024.0) * 1024.0
    sizes = sizes.reshape(3, -1).scatter(
        1, first[:, None],
        torch.round(sizes.reshape(3, -1).gather(1, first[:, None]) / 1024.0)
        * 1024.0).view(sizes.shape)
    limit = used + sizes.reshape(3, -1).gather(1, first[:, None])[:, 0]
    got, plain = _gcs_run(want, sizes, used, limit)
    _assert_gcs_equal(got, plain)
    assert got[0].reshape(3, -1).sum(1).tolist() == [1, 1, 1]
    assert bool(got[0].reshape(3, -1).gather(1, first[:, None]).all())
    assert torch.equal(got[1], limit)


@pytest.mark.cuda
def test_cuda_gcs_admit_dense_share_finite_limits(cuda_device):
    """At a candidate share of 0.3 (about 600k candidates a lane, the
    sweep's 2 x 1M files) under finite limits, the kernel and the plain
    version (both with the prefix in float64, in different orders) differ
    on no candidate farther than 16 float32 ulps from the limit."""
    L, S, F = 4, 2, 1_000_000
    rng = np.random.default_rng(1605)
    sizes = (10.0 ** rng.uniform(6.0, 10.0, (L, S, F))).astype(np.float32)
    want = rng.random((L, S, F)) < 0.3
    used = rng.uniform(0.0, 1e12, L).astype(np.float32)
    limit = (used + np.linspace(0.3, 0.9, L)
             * (sizes * want).sum((1, 2), dtype=np.float64)).astype(
                 np.float32)
    want, sizes, used, limit = (torch.as_tensor(a, device=cuda_device)
                                for a in (want, sizes, used, limit))
    got, plain = _gcs_run(want, sizes, used, limit)
    adm, _, dist = ref.gcs_gate_distance(want, sizes, used, limit)
    assert torch.equal(adm, plain[0].reshape(L, -1))
    diff = got[0].reshape(L, -1) != adm
    tol = 16 * torch.finfo(torch.float32).eps * limit.double()
    far = int((diff & ~(dist <= tol[:, None])).sum())
    print(f"{int(diff.sum())} admissions differ, {far} farther than 16 "
          f"ulps from the limit")
    assert far == 0
    assert bool((plain[0] != want).reshape(L, -1).any(1).all())
    tied = (sizes.reshape(L, -1) * diff).sum(1)
    assert bool(((got[1] - plain[1]).abs()
                 <= 1e-6 * plain[1].abs() + tied).all())


@pytest.mark.cuda
def test_cuda_gcs_admit_two_calls_bitwise(cuda_device):
    want, sizes, used0, limit = (torch.as_tensor(a, device=cuda_device)
                                 for a in gcs_inputs(S=2, F=50000, seed=3))
    a, _ = _gcs_run(want, sizes, used0, limit)
    b, _ = _gcs_run(want, sizes, used0, limit)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_cuda_window_admit_bitwise(cuda_device, case):
    """Both candidate windows of a tick in one launch, bitwise the plain
    ``ref.windows_admit``."""
    args = [torch.as_tensor(a, device=cuda_device)
            for a in windows_inputs(case)]
    before = ops.launch_counts()["window_admit"]
    got = ops.windows_admit(*args)
    assert ops.launch_counts()["window_admit"] == before + 1
    want = ref.windows_admit(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda_device):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in windows_inputs("random")]

    def with_size_k(size_k):
        return ops.windows_admit(args[0], size_k, *args[2:])

    with pytest.raises(ValueError, match="float32"):
        with_size_k(args[1].double())
    with pytest.raises(ValueError, match="on cuda"):
        with_size_k(args[1].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        with_size_k(args[1].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="int64"):
        ops.windows_admit(*args[:2], args[2].int(), *args[3:])
    wide = [a.repeat(1, 1, 9) for a in args[3:7]]  # W = 36 heads
    with pytest.raises(ValueError, match="32 bits"):
        ops.windows_admit(*args[:3], *wide, *args[7:])


def _small_grid():
    from repro_torch.core.scenarios import ScenarioSpec, pack_specs

    return pack_specs([
        ScenarioSpec(base="III", cache_tb=10.0, seed=1, days=0.05,
                     n_files=1000),
        ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0, seed=3,
                     days=0.05, n_files=1000),
        ScenarioSpec(base="I", seed=2, days=0.05, n_files=1000),
    ], tick=10.0)


@pytest.mark.cuda
def test_cuda_captured_sweep_bitwise_to_eager(cuda_device):
    """The ``cuda`` sweep replayed from a CUDA graph against the same path
    run eagerly: every output bitwise, two captured runs bitwise, and a
    run advanced in pieces across the warm-up and the capture ends the
    same."""
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop, simulate_packed

    grid = _small_grid()
    eager = simulate_packed(grid, tick_impl="cuda", _eager=True)
    captured = simulate_packed(grid, tick_impl="cuda")
    again = simulate_packed(grid, tick_impl="cuda")
    loop = TickLoop(grid, resolve_tick_impl("cuda", cuda_device),
                    cuda_device, graph=True)
    for n in (1, 1, 5, grid.n_ticks - 7):
        loop.advance(n)
    pieces = loop.result()
    assert loop.capture_s > 0 and loop.pool_bytes > 0
    assert set(captured) == set(eager)
    for key, want in eager.items():
        for got in (captured, again, pieces):
            assert got[key].dtype == want.dtype
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert eager["jobs_done_site"].sum() > 0


@pytest.mark.cuda
def test_cuda_replays_count_their_launches(cuda_device):
    """Launch counts after a captured sweep: every kernel once a tick,
    the lane-tick and the glue kernels, the replayed ticks included, as
    on the eager path."""
    from repro_torch.sim.batched import simulate_packed

    grid = _small_grid()
    for eager in (False, True):
        ops.reset_launch_counts()
        tg_ops.reset_launch_counts()
        simulate_packed(grid, tick_impl="cuda", _eager=eager)
        assert ops.launch_counts() == {k: grid.n_ticks for k in ops.KERNELS}
        assert tg_ops.launch_counts() == {k: grid.n_ticks
                                          for k in tg_ops.KERNELS}


def _exec_grid():
    """Five lanes with a small disk cache (waiting files, every series
    moving): chunks of 2 leave a padded last chunk."""
    from repro_torch.core.scenarios import ScenarioSpec, pack_specs

    return pack_specs([ScenarioSpec(base="III", cache_tb=2.0 + 4.0 * i,
                                    gcs_limit_tb=[None, 5.0][i % 2], seed=i,
                                    days=0.05, n_files=2000)
                       for i in range(5)], tick=10.0)


def _assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.cuda
def test_cuda_chunks_and_round_robin_bitwise_to_unchunked(cuda_device):
    """The ``cuda`` sweep in lane chunks of 1, 2 and 3 (padded last
    chunks) and dealt over a device list, each bitwise to the unchunked
    run: no float sum of a lane depends on the lanes beside it."""
    from repro_torch.sim.batched import simulate_packed

    grid = _exec_grid()
    whole = simulate_packed(grid, tick_impl="cuda")
    for kw in (dict(lane_chunk=1), dict(lane_chunk=2), dict(lane_chunk=3),
               dict(lane_chunk=2, devices=["cuda:0", "cuda:0"]),
               dict(devices=["cuda", "cuda"])):
        _assert_outputs_equal(simulate_packed(grid, tick_impl="cuda", **kw),
                              whole)
    assert whole["jobs_done_site"].sum() > 0


@pytest.mark.cuda
def test_cuda_series_replayed_bitwise_to_eager_and_launches_unchanged(
        cuda_device):
    """Series capture on the ``cuda`` tick: the replayed tick's series and
    outputs bitwise to the eager tick's, capture off's outputs unchanged
    by it, and each kernel still launched once a tick."""
    from repro_torch.sim.batched import simulate_packed

    grid = _exec_grid()
    off = simulate_packed(grid, tick_impl="cuda")
    got = {}
    for eager in (True, False):
        ops.reset_launch_counts()
        tg_ops.reset_launch_counts()
        got[eager] = simulate_packed(grid, tick_impl="cuda", _eager=eager,
                                     record_series=7)
        assert ops.launch_counts() == {k: grid.n_ticks for k in ops.KERNELS}
        assert tg_ops.launch_counts() == {k: grid.n_ticks
                                          for k in tg_ops.KERNELS}
    _assert_outputs_equal(got[False], got[True])
    for key, want in off.items():
        np.testing.assert_array_equal(got[False][key], want, err_msg=key)
    assert got[False]["ser_queue"].max() > 0
    assert got[False]["ser_run"].max() > 0


@pytest.mark.cuda
def test_cuda_fault_injected_jobs_bitwise_and_memory_returns(cuda_device):
    """Retryable chunk jobs on the card under injected crashes, hangs and
    transient faults: the same results as the plain sweep, and the device
    memory of the attempts given back."""
    from repro_torch.core.scenarios import ScenarioSpec
    from repro_torch.sim.batched import run_sweep_torch
    from repro_torch.sim.faults import FaultPlan
    from repro_torch.sim.jobs import RetryPolicy

    specs = [ScenarioSpec(base="III", cache_tb=2.0 + 4.0 * i, seed=i,
                          days=0.05, n_files=2000) for i in range(5)]
    from repro_torch.obs.trace import get_tracer

    plain = run_sweep_torch(specs, tick=10.0, tick_impl="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        res = run_sweep_torch(
            specs, tick=10.0, tick_impl="cuda", lane_chunk=2,
            job_timeout=0.2,
            faults=FaultPlan(seed=11, crash=0.3, hang=0.3, transient=0.3,
                             hang_s=0.5),
            retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
        (call,) = [e["args"] for e in tracer.events
                   if e["name"] == "sweep.torch"]
    finally:
        tracer.disable()
        tracer.reset()
    torch.cuda.synchronize()
    assert call["chunks"] == 3 and call["pool_bytes"] > 0
    assert torch.cuda.memory_allocated() - before < call["pool_bytes"] // 2
    assert res.ok
    for a, b in zip(res.results, plain.results):
        assert a.metrics == b.metrics and a.cost_usd == b.cost_usd


@pytest.mark.cuda
def test_cuda_subprocess_fleet_bitwise(cuda_device):
    """Two worker processes on the card, each opening its own CUDA
    context: the fleet's results are the plain sweep's."""
    from repro_torch.core.scenarios import ScenarioSpec
    from repro_torch.sim.batched import run_sweep_torch

    specs = [ScenarioSpec(base="III", cache_tb=2.0 + 4.0 * i, seed=i,
                          days=0.05, n_files=2000) for i in range(5)]
    plain = run_sweep_torch(specs, tick=10.0, tick_impl="cuda")
    fleet = run_sweep_torch(specs, tick=10.0, tick_impl="cuda",
                            transport="subprocess", workers=2, lane_chunk=2)
    assert fleet.ok and len(fleet.results) == len(plain.results)
    for a, b in zip(fleet.results, plain.results):
        assert a.metrics == b.metrics and a.cost_usd == b.cost_usd


GLUE_STEPS = ("begin", "complete", "link_admit", "migrate", "wait_select")

GLUE_CASES = {
    # name: (L, S, F, glue_state keywords)
    "random": (3, 2, 20_000, {}),
    "dense shares": (2, 2, 50_000,
                     dict(slot=0.9, comp=0.5, queued=0.5, mig=0.5)),
    "the tick's sparse shares": (2, 2, 50_000, dict(slot=3e-3, comp=0.3,
                                                    queued=3e-3, mig=2e-4)),
    "nothing to do": (2, 2, 8192,
                      dict(slot=0.0, comp=0.0, queued=0.0, mig=0.0)),
    "everything": (2, 2, 8192, dict(slot=1.0, comp=1.0, queued=1.0,
                                    mig=1.0)),
    "cold tier off, no disk limits": (2, 2, 10_000,
                                      dict(gcs="off", limits="inf")),
    "F not a multiple of 4, byte loads": (3, 2, 4097, {}),
    "F below a tile": (2, 3, 33, {}),
    "many rows": (16, 4, 3000, {}),
    "every file waiting": (2, 2, 20_000, dict(wait=1.0)),
    "a few waiting files over many tiles": (2, 2, 200_000, dict(wait=1e-5)),
    # rows that the flag kernels' runs (tg_ops.FLAG_RUN) split unevenly
    "three runs and 17 flags, byte loads": (2, 2, 3 * tg_ops.FLAG_RUN + 17,
                                            {}),
    "64 rows, a few blocks each": (16, 4, 40_000, {}),
    "the sweep's shape at the tick's sparse shares": (
        8, 2, 1_000_000, dict(slot=3e-3, comp=0.3, queued=3e-3, mig=2e-4)),
}


def _unaligned(t):
    """A contiguous copy of ``t`` that starts one element past its
    buffer's start (so not 16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _glue_inputs(case, device, seed=0):
    if case == "unaligned planes":
        st, c, x = glue_state(seed, L=2, S=2, F=8192, device=device)
        big = lambda d: {k: _unaligned(v) if v.dim() == 3 else v  # noqa: E731
                         for k, v in d.items()}
        return big(st), big(c), big(x)
    L, S, F, kw = GLUE_CASES[case]
    return glue_state(seed, L=L, S=S, F=F, device=device, **kw)


def _glue_step(glue, step, st, c, x, W=4):
    """Glue step ``step`` of ``glue`` (``tg_ops`` or ``tg_ref``) on ``st``,
    with the work of its own ``begin``; returns its outputs, ``occ3``
    updated in place for ``migrate``."""
    t_active, work = glue.begin(st, x["now"], x["dt"])
    if step == "begin":
        return (t_active,)
    if step == "wait_select":
        return glue.wait_select(st, W, work)
    if step == "complete":
        return glue.complete(st, c, x["now"], x["new_done"], x["comp"],
                             work)
    if step == "link_admit":
        return glue.link_admit(st, c, x["now"], work) or ()
    occ3 = x["occ3"].clone()
    glue.migrate(st, c, x["now"], x["mig"], x["rank"], occ3, work)
    return (occ3,)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GLUE_CASES) + ["unaligned planes"])
@pytest.mark.parametrize("step", GLUE_STEPS)
def test_cuda_glue_kernel_bitwise(cuda_device, step, case):
    """Each glue kernel against its plain version on the same state: every
    state tensor and output bitwise, one launch of the step's kernel."""
    st, c, x = _glue_inputs(case, cuda_device)
    st_k = {k: v.clone() for k, v in st.items()}
    if case == "unaligned planes":
        st_k = {k: _unaligned(v) if v.dim() == 3 else v.clone()
                for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    name = f"glue_{step}"
    before = tg_ops.launch_counts()[name]
    got = _glue_step(tg_ops, step, st_k, c, x)
    assert tg_ops.launch_counts()[name] == before + 1
    want = _glue_step(tg_ref, step, st_p, c, x)
    torch.cuda.synchronize()
    assert_states_equal(st_k, st_p, f"{step}: ")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["three runs and 17 flags, byte loads",
                                  "dense shares", "unaligned planes"])
@pytest.mark.parametrize("sms", [1, 3, 1000])
@pytest.mark.parametrize("step", ["link_admit", "migrate"])
def test_cuda_flag_kernels_bitwise_on_any_grid(cuda_device, monkeypatch,
                                               step, sms, case):
    """``tg_link_admit`` and ``tg_migrate`` on grids sized for other SM
    counts (one block a row taking every run, a few, one a run) against
    the plain version: every state tensor and output bitwise, one
    launch."""
    monkeypatch.setattr(tg_ops, "_sm_count", lambda index: sms)
    st, c, x = _glue_inputs(case, cuda_device, seed=sms)
    copy = _unaligned if case == "unaligned planes" else torch.clone
    st_k = {k: copy(v) if v.dim() == 3 else v.clone() for k, v in st.items()}
    st_p = {k: v.clone() for k, v in st.items()}
    name = f"glue_{step}"
    before = tg_ops.launch_counts()[name]
    got = _glue_step(tg_ops, step, st_k, c, x)
    assert tg_ops.launch_counts()[name] == before + 1
    want = _glue_step(tg_ref, step, st_p, c, x)
    torch.cuda.synchronize()
    assert_states_equal(st_k, st_p, f"{step}: ")
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)


#: The selection's own cases (beside some of :data:`GLUE_CASES`): ``(L,
#: S, F, glue_state keywords)``. A third of the files waiting makes most
#: of a warp's loads dense (each thread keys its own files).
WAIT_CASES = {
    "F % 16 == 4, byte loads": (2, 2, 20_004, {}),
    "F below a run": (2, 2, 10_000, {}),
    "W - 1 waiting files a row": (2, 3, 3 * tg_ops.FLAG_RUN + 16, {}),
    "a third of the files waiting": (2, 2, 50_000, dict(wait=0.3)),
    "a third waiting, byte loads": (2, 2, 20_003, dict(wait=0.3)),
}


def _wait_inputs(case, device, W, seed):
    """The state of a selection case. ``"W - 1 waiting files a row"``:
    every row holds exactly ``W - 1`` waiting files (so the fill decides
    its last head): at the front of the row, in the first thread's four
    words of run 0, only after run 0, or anywhere."""
    if case not in WAIT_CASES:
        return _glue_inputs(case, device, seed=seed)
    L, S, F, kw = WAIT_CASES[case]
    st, c, x = glue_state(seed, L=L, S=S, F=F, device=device, **kw)
    if case == "W - 1 waiting files a row":
        rng = np.random.default_rng(seed)
        span = tg_ops.FLAG_RUN // 4  # the flags of one load of a block
        words = np.concatenate([np.arange(u * span, u * span + 16)
                                for u in range(4)])
        wait = np.zeros((L * S, F), bool)
        for r in range(L * S):
            at = [np.arange(F), words, np.arange(tg_ops.FLAG_RUN, F),
                  rng.permutation(F)][r % 4]
            wait[r, at[:W - 1]] = True
        st["wq_wait"] = torch.as_tensor(wait.reshape(L, S, F), device=device)
    return st, c, x


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "F not a multiple of 4, byte loads",
                                  "F below a tile", "many rows",
                                  "every file waiting",
                                  "a few waiting files over many tiles",
                                  "unaligned planes", *WAIT_CASES])
@pytest.mark.parametrize("W", [1, 4, 5, 32])
def test_cuda_wait_select_bitwise(cuda_device, W, case):
    """``tg_wait_select`` against the plain selection (``torch.topk`` of
    the keys): ``lowest`` and ``idx`` bitwise, one launch, at W of the
    specialised list (W <= 4) and of the general one, with 16-byte and
    byte loads, rows below one run and over several, and rows whose last
    head only the fill of run 0 gives."""
    st, c, x = _wait_inputs(case, cuda_device, W, seed=W)
    W = min(W, st["wq_wait"].shape[-1])
    before = tg_ops.launch_counts()["glue_wait_select"]
    got = _glue_step(tg_ops, "wait_select", st, c, x, W)
    assert tg_ops.launch_counts()["glue_wait_select"] == before + 1
    want = _glue_step(tg_ref, "wait_select", st, c, x, W)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)
    if case == "W - 1 waiting files a row":
        assert (want[0][..., -1] == tg_ref.BIG_TICKET).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [4, 32])
def test_cuda_wait_select_replayed_from_a_graph(cuda_device, W):
    """``glue.begin`` and the selection captured in one CUDA graph and
    replayed twice, on two wait queues written into the captured planes:
    bitwise to the plain selection after each replay (``tg_begin`` resets
    the selection's ticket, so each replay's last block merges)."""
    st, c, x = glue_state(3, L=8, S=2, F=50_000, device=cuda_device)
    now, dt = x["now"], x["dt"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the build, the SM count
        tg_ops.wait_select(st, W, tg_ops.begin(st, now, dt)[1])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tg_ops.launch_counts()["glue_wait_select"]
    with torch.cuda.graph(graph):
        got = tg_ops.wait_select(st, W, tg_ops.begin(st, now, dt)[1])
    assert tg_ops.launch_counts()["glue_wait_select"] == before + 1
    gen = torch.Generator(device=cuda_device)
    for share in (0.02, 3e-5):
        gen.manual_seed(int(share * 1e5))
        plane = st["wq_wait"].shape
        st["wq_wait"].copy_(torch.rand(plane, generator=gen,
                                       device=cuda_device) < share)
        st["wq_ticket"].copy_(torch.randint(0, 40, plane, generator=gen,
                                            device=cuda_device,
                                            dtype=torch.int32))
        graph.replay()
        want = tg_ref.wait_select(st, W)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert bitwise_equal(g, w)


@pytest.mark.cuda
def test_cuda_wait_select_on_the_sweep_planes(cuda_device):
    """The sweep's shapes (8 lanes x 2 sites x 1,000,000 files) with a few
    waiting files a row, none in one row and tickets tied: bitwise, twice
    (the ticket of the launch before is reset by the next tick's begin)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    plane = (8, 2, 1_000_000)
    st = {"tr_slot": torch.zeros(plane, dtype=torch.bool, device=cuda_device),
          "tr_start": torch.zeros(plane, device=cuda_device),
          "wq_wait": torch.rand(plane, generator=g, device=cuda_device) < 2e-5,
          "wq_ticket": torch.randint(0, 50, plane, generator=g,
                                     device=cuda_device, dtype=torch.int32)}
    st["wq_wait"][0, 0] = False
    for _ in range(2):
        _, work = tg_ops.begin(st, torch.tensor(0.0, device=cuda_device),
                               torch.tensor(10.0, device=cuda_device))
        got = tg_ops.wait_select(st, 4, work)
        want = tg_ref.wait_select(st, 4)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert bitwise_equal(a, b)


def _glue_grid():
    """Two disk->GCS slots a site on Config III grids with a limited disk
    and a finite cold tier, so migrations queue (2,161 ticks)."""
    import dataclasses

    from repro_torch.core.scenarios import ScenarioSpec, pack_specs

    grid = pack_specs([
        ScenarioSpec(base="III", cache_tb=10.0, seed=1, days=0.25,
                     n_files=1000),
        ScenarioSpec(base="III", cache_tb=15.0, gcs_limit_tb=5.0, seed=3,
                     days=0.25, n_files=1000),
        ScenarioSpec(base="I", seed=2, days=0.25, n_files=1000),
    ], tick=10.0)
    slots = np.array(grid.link_slots, copy=True)
    slots[:, 2::3] = 2.0
    return dataclasses.replace(grid, link_slots=slots)


@pytest.mark.cuda
def test_cuda_fused_glue_tick_bitwise_to_plain_glue(cuda_device,
                                                    monkeypatch):
    """The ``cuda`` tick with the glue kernels against the same tick with
    the plain glue in their place (the same lane-tick kernels), eager and
    replayed: every state tensor bitwise after 600 ticks and after the
    200 that follow, in which files complete, migrate and queue."""
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    grid = _glue_grid()
    impl = resolve_tick_impl("cuda", cuda_device)
    fused = TickLoop(grid, impl, cuda_device, graph=False)
    captured = TickLoop(grid, impl, cuda_device, graph=True)
    plain = TickLoop(grid, impl, cuda_device, graph=False)
    queued = []
    for n in (600, 200):
        fused.advance(n)
        captured.advance(n)
        with monkeypatch.context() as mp:
            for step in GLUE_STEPS:
                mp.setattr(tg_ops, step, getattr(tg_ref, step))
            plain.advance(n)
        torch.cuda.synchronize()
        assert_states_equal(fused.st, plain.st, f"tick {plain.t}: ")
        assert_states_equal(captured.st, plain.st, f"tick {plain.t}: ")
        queued.append(int(plain.st["lq_next"].view(-1, 3)[:, 2].sum()))
    assert int(plain.st["diskgcs_b"].sum()) > 0
    assert queued[1] > queued[0] > 0  # migrations queued in the window


@pytest.mark.cuda
def test_cuda_glue_wrappers_check_their_inputs(cuda_device):
    """Wrong dtype, shape or device, or the plain version's work on the
    card: the wrapper raises before it launches anything."""
    st, c, x = glue_state(1, L=2, S=2, F=100, device=cuda_device)
    now, dt = x["now"], x["dt"]
    _, work = tg_ops.begin(st, now, dt)
    tg_ops.reset_launch_counts()
    with pytest.raises(ValueError, match="int32"):
        tg_ops.complete(dict(st, pend_cnt=st["pend_cnt"].float()), c, now,
                        x["new_done"], x["comp"], work)
    with pytest.raises(ValueError, match="shape"):
        tg_ops.migrate(st, c, now, x["mig"][..., :50], x["rank"], x["occ3"],
                       work)
    with pytest.raises(ValueError, match="on cuda"):
        tg_ops.link_admit(st, dict(c, latency=c["latency"].cpu()), now, work)
    with pytest.raises(ValueError, match="on cuda"):
        tg_ops.begin(st, now.cpu(), dt)
    with pytest.raises(ValueError, match="contiguous"):
        tg_ops.complete(st, c, now, x["new_done"].transpose(0, 1)
                        .contiguous().transpose(0, 1), x["comp"], work)
    with pytest.raises(ValueError, match="shape"):
        tg_ops.migrate(st, c, now, x["mig"], x["rank"], x["occ3"], work[1:])
    with pytest.raises(TypeError, match="work"):
        tg_ops.complete(st, c, now, x["new_done"], x["comp"],
                        tg_ref.begin(st, now, dt)[1])
    for W in (0, 33, 101):
        with pytest.raises(ValueError, match="W="):
            tg_ops.wait_select(st, W, work)
    with pytest.raises(ValueError, match="int32"):
        tg_ops.wait_select(dict(st, wq_ticket=st["wq_ticket"].long()), 4,
                           work)
    assert tg_ops.launch_counts() == {k: 0 for k in tg_ops.KERNELS}


def carousel_inputs(N, M, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    link_id = torch.randint(0, M, (N,), generator=g, dtype=torch.int32)
    active = torch.rand(N, generator=g) < 0.6
    total = 1e9 * torch.rand(N, generator=g) + 1e6
    done = total * torch.rand(N, generator=g)
    mode = (torch.arange(M) % 2).to(torch.int32)
    bw = 1e6 + 1e8 * torch.rand(M, generator=g)
    bw = torch.where(mode == 0, bw * (N / M), bw)
    return [t.to(device) for t in (link_id, active, done, total, bw, mode)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [6, 512, 20000])
def test_cuda_carousel_tick_bitwise(cuda_device, M):
    args = carousel_inputs(100_003, M, cuda_device)
    before = cu_ops.launch_counts()["carousel_tick"]
    got = cu_ops.carousel_tick(*args, 10.0)
    want = cu_ref.carousel_tick(*args, 10.0)
    torch.cuda.synchronize()
    assert cu_ops.launch_counts()["carousel_tick"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any())


@pytest.mark.cuda
def test_cuda_simulate_ticks_bitwise(cuda_device):
    args = carousel_inputs(50_000, 6, cuda_device, seed=1)
    a = cu_ops.simulate_ticks(*args, 10.0, 50, tick_impl="cuda")
    b = cu_ops.simulate_ticks(*args, 10.0, 50, tick_impl="torch")
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[2].sum()) > 0


ENGINE_TICKS = sorted({0, 1, cu_ops.ENGINE_CHUNK - 1, cu_ops.ENGINE_CHUNK,
                       cu_ops.ENGINE_CHUNK + 1, 3 * cu_ops.ENGINE_CHUNK + 5})


def _engine_against_plain(args, n_ticks):
    """Run the engine for ``n_ticks`` and hold it to the plain engine:
    final state and every tick's completions bitwise, carried counts equal
    to a recount, inputs unchanged, launches counted through the replays.
    Returns the engine."""
    kept = [a.clone() for a in args]
    cu_ops.reset_launch_counts()
    engine = cu_ops.CarouselEngine(*args, 10.0, n_ticks)
    engine.advance(n_ticks)
    counts = cu_ops.launch_counts()
    want = cu_ops.simulate_ticks(*args, 10.0, n_ticks, tick_impl="torch")
    torch.cuda.synchronize()
    assert counts == {"carousel_tick": 0, "engine_count": 1,
                      "engine_tick": n_ticks}
    for got, w in zip((engine.active, engine.done, engine.completions),
                      want):
        assert torch.equal(got, w)
    recount = torch.bincount(args[0][engine.active].long(),
                             minlength=args[4].shape[0])
    assert torch.equal(engine.carried_counts(), recount.to(torch.int32))
    for a, k in zip(args, kept):
        assert torch.equal(a, k)
    return engine


@pytest.mark.cuda
@pytest.mark.parametrize("n_ticks", ENGINE_TICKS)
@pytest.mark.parametrize("M", [6, 512, 20000])
def test_cuda_engine_bitwise_to_plain_engine(cuda_device, M, n_ticks):
    args = carousel_inputs(100_003, M, cuda_device, seed=M + n_ticks)
    engine = _engine_against_plain(args, n_ticks)
    if n_ticks > cu_ops.ENGINE_CHUNK:
        assert engine.capture_s > 0 and int(engine.completions.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("M", [6, 512, 20000])
def test_cuda_engine_count_matches_bincount(cuda_device, M):
    args = carousel_inputs(100_003, M, cuda_device)
    out = torch.full((M,), -1, dtype=torch.int32, device=cuda_device)
    before = cu_ops.launch_counts()["engine_count"]
    cu_ops.engine_count(args[0], args[1], out)
    assert cu_ops.launch_counts()["engine_count"] == before + 1
    want = torch.bincount(args[0][args[1]].long(), minlength=M)
    assert torch.equal(out, want.to(torch.int32))


@pytest.mark.cuda
def test_cuda_engine_simulate_ticks_matches_the_engine(cuda_device):
    """``simulate_ticks`` on the card runs the engine: the same state, one
    count launch and one tick launch a tick, inputs unchanged."""
    args = carousel_inputs(50_000, 6, cuda_device, seed=3)
    kept = [a.clone() for a in args]
    n = 2 * cu_ops.ENGINE_CHUNK + 3
    cu_ops.reset_launch_counts()
    got = cu_ops.simulate_ticks(*args, 10.0, n, tick_impl="cuda")
    assert cu_ops.launch_counts() == {"carousel_tick": 0,
                                      "engine_count": 1, "engine_tick": n}
    engine = _engine_against_plain(args, n)
    for g, w in zip(got, (engine.active, engine.done, engine.completions)):
        assert torch.equal(g, w)
    for a, k in zip(args, kept):
        assert torch.equal(a, k)


@pytest.mark.cuda
def test_cuda_engine_in_pieces_and_small_chunks(cuda_device, monkeypatch):
    """An engine advanced in pieces across its warm-up, capture, replays
    and remainders, with a chunk of 4, ends as the plain engine."""
    args = carousel_inputs(70_001, 6, cuda_device, seed=5)
    kept = [a.clone() for a in args]
    monkeypatch.setattr(cu_ops, "ENGINE_CHUNK", 4)
    engine = cu_ops.CarouselEngine(*args, 10.0, 40)
    cu_ops.reset_launch_counts()
    for n in (1, 2, 9, 0, 28):
        engine.advance(n)
    assert cu_ops.launch_counts()["engine_tick"] == 40
    want = cu_ops.simulate_ticks(*args, 10.0, 40, tick_impl="torch")
    torch.cuda.synchronize()
    for got, w in zip((engine.active, engine.done, engine.completions),
                      want):
        assert torch.equal(got, w)
    for a, k in zip(args, kept):
        assert torch.equal(a, k)


@pytest.mark.cuda
def test_cuda_engine_histogram_in_device_memory(cuda_device):
    """At M = 40,000 the rate table and the histogram do not fit one
    block's shared memory together: the histogram goes to device memory."""
    args = carousel_inputs(100_003, 40_000, cuda_device, seed=7)
    _engine_against_plain(args, 3 * cu_ops.ENGINE_CHUNK + 5)


@pytest.mark.cuda
def test_cuda_engine_unaligned_inputs(cuda_device):
    """Inputs that start off a 16-byte boundary: the engine copies what its
    vector loads need aligned."""
    args = carousel_inputs(100_004, 6, cuda_device, seed=9)
    shifted = [a[1:] for a in args[:4]] + args[4:]
    assert shifted[0].data_ptr() % 16 != 0
    _engine_against_plain(shifted, cu_ops.ENGINE_CHUNK + 1)


@pytest.mark.cuda
def test_cuda_engine_checks_its_inputs(cuda_device):
    args = carousel_inputs(1000, 6, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        cu_ops.CarouselEngine(*args[:2], args[2].double(), *args[3:], 1.0, 4)
    too_many = carousel_inputs(1000, 60_000, cuda_device)
    with pytest.raises(ValueError, match="links"):
        cu_ops.CarouselEngine(*too_many, 1.0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cu_ops.simulate_ticks(*(a.cpu() for a in args), 1.0, 2,
                              tick_impl="cuda", device="cpu")


@pytest.mark.cuda
def test_cuda_carousel_checks_its_inputs(cuda_device):
    args = carousel_inputs(1000, 6, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        cu_ops.carousel_tick(args[0].long(), *args[1:], 1.0)
    too_many = carousel_inputs(1000, 60_000, cuda_device)
    with pytest.raises(ValueError, match="links"):
        cu_ops.carousel_tick(*too_many, 1.0)


#: (atol, rtol) of the attention kernel against the plain version, as in
#: ``chip_smoke.py``.
ATTENTION_BARS = {torch.bfloat16: (4e-3, 8e-3), torch.float32: (2e-5, 2e-5)}

ATTENTION_CASES = [
    # B, nh, nkv, T, S, hd, dtype, causal, window
    (1, 4, 2, 200, 200, 128, torch.bfloat16, True, 0),
    (1, 4, 2, 130, 130, 168, torch.bfloat16, True, 64),
    (1, 4, 2, 130, 130, 168, torch.float32, True, 64),
    (1, 5, 1, 96, 96, 64, torch.float32, True, 0),
    (1, 2, 1, 100, 100, 32, torch.float32, False, 0),
    (1, 2, 2, 80, 40, 16, torch.float32, True, 8),
    (2, 2, 1, 70, 150, 256, torch.float32, False, 16),
    # f32 on the tf32x3 kernel: widths not a multiple of 4 (4-byte copies)
    # or of 8 (zero-filled columns), hd 256 with T != S both ways,
    # hymba_1_5b's group of 5 at hd 64 with its window, rows whose every
    # key is masked
    (1, 4, 2, 150, 150, 100, torch.float32, True, 0),
    (1, 2, 1, 90, 70, 3, torch.float32, True, 16),
    (1, 2, 1, 200, 130, 256, torch.float32, True, 0),
    (1, 4, 2, 130, 200, 256, torch.float32, True, 64),
    (1, 10, 2, 300, 300, 64, torch.float32, True, 64),
    (2, 4, 4, 100, 60, 168, torch.float32, True, 16),
    # bf16 on the wgmma kernel: both ends of its widths, ragged T and S,
    # rows whose every key is masked, batches with a GQA group of 4
    (1, 4, 2, 256, 256, 64, torch.bfloat16, True, 0),
    (1, 2, 1, 200, 200, 256, torch.bfloat16, True, 0),
    (1, 2, 1, 70, 150, 128, torch.bfloat16, False, 0),
    (1, 2, 2, 80, 40, 64, torch.bfloat16, True, 8),
    (2, 8, 2, 160, 160, 128, torch.bfloat16, True, 0),
    # bf16 at widths that are not a multiple of 8: the wgmma kernel's
    # thread loader, 8-byte copies (hd 100, 4), 4-byte (50, 250), odd
    # widths through registers (37, 97, 3); ragged T and S, rows whose
    # every key is masked, causal=False with S unaligned, a GQA group of 4,
    # and a second kv head that starts 8 (hd 100, S 149) or 4 (hd 50, S
    # 151) bytes past a 16-byte boundary
    (1, 4, 2, 150, 150, 100, torch.bfloat16, True, 0),
    (2, 4, 2, 149, 149, 100, torch.bfloat16, True, 0),
    (1, 4, 2, 151, 151, 50, torch.bfloat16, True, 16),
    (1, 4, 2, 200, 200, 50, torch.bfloat16, True, 0),
    (1, 2, 1, 130, 130, 37, torch.bfloat16, True, 32),
    (1, 4, 2, 150, 150, 97, torch.bfloat16, True, 0),
    (1, 2, 1, 100, 100, 4, torch.bfloat16, True, 0),
    (1, 2, 1, 200, 130, 250, torch.bfloat16, True, 0),
    (1, 4, 2, 130, 200, 50, torch.bfloat16, True, 64),
    (1, 2, 2, 80, 40, 36, torch.bfloat16, True, 8),
    (1, 2, 1, 90, 70, 3, torch.bfloat16, True, 16),
    (1, 2, 1, 70, 150, 100, torch.bfloat16, False, 0),
    (1, 2, 1, 70, 150, 97, torch.bfloat16, False, 0),
    (2, 8, 2, 160, 160, 100, torch.bfloat16, True, 0),
    # the served families' uses: seamless's encoder (non-causal, T = S)
    # and its cross-attention (T decoder queries against S frames, both
    # ways) at hd 64; phi_3_vision's hd 96 (the 128 bucket) with nkv = nh;
    # arctic's 56 query heads on 8 kv heads (a group of 7) at hd 128
    (2, 4, 4, 150, 150, 64, torch.bfloat16, False, 0),
    (2, 4, 4, 70, 190, 64, torch.bfloat16, False, 0),
    (2, 4, 4, 190, 70, 64, torch.bfloat16, False, 0),
    (1, 4, 4, 200, 200, 96, torch.bfloat16, True, 0),
    (1, 56, 8, 130, 130, 128, torch.bfloat16, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTENTION_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    B, nh, nkv, T, S, hd, dtype, causal, window = case
    g = torch.Generator().manual_seed(T + hd)
    q, k, v = (torch.randn(shape, generator=g).to(cuda_device, dtype)
               for shape in ((B, nh, T, hd), (B, nkv, S, hd),
                             (B, nkv, S, hd)))
    route = "tf32x3" if dtype == torch.float32 else "wgmma"
    threads = int(route == "wgmma" and hd % 8 != 0)
    assert fa_ops._route(dtype, hd) == route
    before = fa_ops.launch_counts()
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa_ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    key = f"flash_attention_{route}"
    assert after[key] == before[key] + 1
    key = "flash_attention_wgmma_threads"
    assert after[key] == before[key] + threads
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = ATTENTION_BARS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dtype == torch.bfloat16:
        assert int((got != want).sum()) <= 0.01 * got.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("hdp", [*fa_ops.WGMMA_WIDTHS, 168, 100, 50, 37, 4,
                                 250, 97])
def test_cuda_wgmma_tile_bitwise(cuda_device, hdp):
    """The wgmma kernel's loader at this width (TMA maps at a multiple of
    8; else the thread loader: 8-byte cp.async at 100 and 4, 4-byte at 50
    and 250, loads through registers at 37 and 97), swizzle, zeroed pad
    columns, descriptors, fragment layouts and two-half split on one
    64-row tile: with small integer inputs every sum is exact, so S = q
    k^T and O = S v equal the plain products, and O's pad columns (from
    the width up to its bucket) are 0. A probe on NaN inputs runs first,
    so shared memory that the loader leaves unwritten most likely holds
    NaN and shows in S or O."""
    bk, hd = fa_ops.WGMMA_KEYS, hdp
    g = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randint(-3, 4, shape, generator=g)
               .to(cuda_device, torch.bfloat16)
               for shape in ((64, hd), (bk, hd), (bk, hd)))
    # stale NaN in the shared memory the probe's CTA will get
    fa_ops._wgmma_tile_check(*(torch.full((r, 64), float("nan"),
                                          dtype=torch.bfloat16,
                                          device=cuda_device)
                               for r in (64, bk, bk)))
    s, o = fa_ops._wgmma_tile_check(q, k, v)
    s_ref = q.float() @ k.float().T
    assert torch.equal(s, s_ref)
    width = next(w for w in fa_ops.WGMMA_WIDTHS if w >= hd)
    assert o.shape == (64, width)
    assert torch.equal(o[:, :hd], s_ref @ v.float())
    assert torch.equal(o[:, hd:], torch.zeros_like(o[:, hd:]))


#: Largest magnitude of the tf32x3 probe's integer inputs: small (every
#: value exact in TF32) or wide (up to 12 bits, so the low half is
#: nonzero). At most one operand of each product is wide, so the missing
#: lo.lo' term is 0, and at w <= 64 with 16 keys every sum stays below
#: 2**24, exact in float32.
TF32X3_PROBE_RANGES = {"small": 2, "wide": 4095}


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 24, 64])
@pytest.mark.parametrize("wide", [None, "q", "k", "v"])
def test_cuda_tf32x3_tile_bitwise(cuda_device, w, wide):
    """The tf32x3 kernel's cp.async loads, m16n8k8 fragment layouts, the
    split into TF32 halves, the three products and P carried from the
    score accumulator (its permuted k index) on one warp: with integer
    inputs every product term is exact, so S = q k^T and O = S v equal
    the plain products bitwise. A wide operand drives its low half through
    the lo.hi' or hi.lo' product (a wide q or k makes S wide for O)."""
    g = torch.Generator().manual_seed(w)
    inputs = []
    for name in ("q", "k", "v"):
        top = TF32X3_PROBE_RANGES["wide" if name == wide else "small"]
        inputs.append(torch.randint(-top, top + 1,
                                    (fa_ops.TF32X3_PROBE_KEYS, w),
                                    generator=g)
                      .to(cuda_device, torch.float32))
    q, k, v = inputs
    s, o = fa_ops._tf32x3_tile_check(q, k, v)
    s_ref = (q.double() @ k.double().T)
    o_ref = s_ref @ v.double()
    assert torch.equal(s.double(), s_ref)
    assert torch.equal(o.double(), o_ref)


#: The tf32x3 kernel's K/V ring (stages, keys) at head widths on both
#: sides of each change, as the CPU model of its arithmetic assumes it
#: (``test_torch_flash_attention_tf32x3.py``, the same table).
TF32X3_TILES = [
    (1, (2, 64)), (64, (2, 64)), (72, (2, 64)), (100, (2, 32)),
    (128, (2, 32)), (144, (2, 32)), (168, (1, 32)), (200, (1, 32)),
    (224, (1, 16)), (256, (1, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,tiles", TF32X3_TILES)
def test_cuda_tf32x3_tiles(cuda_device, hd, tiles):
    """The kernel's own K/V ring at ``hd`` (``fa_tf32x3_tiles``: stages *
    1000 + keys), the key tiles the CPU model walks; -1 outside 1..256."""
    lib = fa_ops._TF32X3.get()
    assert divmod(lib.fa_tf32x3_tiles(hd), 1000) == tiles
    assert lib.fa_tf32x3_tiles(0) == lib.fa_tf32x3_tiles(257) == -1


@pytest.mark.cuda
def test_cuda_flash_attention_checks_its_inputs(cuda_device):
    q = torch.randn(1, 2, 8, 264, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        fa_ops.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q, q[:, :1].repeat(1, 3, 1, 1), q[:, :1]
                               .repeat(1, 3, 1, 1))
    qb = torch.randn(1, 2, 8, 64, device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(qb.transpose(2, 3).contiguous()
                               .transpose(2, 3), qb, qb)
    # contiguous, but starting 2 bytes past TMA's 16-byte alignment
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention(shifted, qb, qb)


def _shifted(t):
    """A contiguous copy of ``t`` starting 2 bytes past an allocation."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hd,copy", [(64, 16), (100, 8), (50, 4), (37, 2)])
def test_cuda_wgmma_checks_its_loader_alignment(cuda_device, hd, copy):
    """Each loader's copy size is the alignment q, k and v must start on:
    a start 2 bytes off raises ``ValueError`` for each input and launches
    nothing where the copies are 16, 8 or 4 bytes; at odd hd (2 bytes,
    through registers) every bf16 tensor is aligned, and the shifted
    inputs give what the plain version gives."""
    assert fa_ops._copy_bytes(hd) == copy
    g = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(shape, generator=g).to(cuda_device, torch.bfloat16)
               for shape in ((1, 4, 96, hd), (1, 2, 96, hd), (1, 2, 96, hd)))
    before = fa_ops.launch_counts()
    if copy > 2:
        for i in range(3):
            args = [q, k, v]
            args[i] = _shifted(args[i])
            with pytest.raises(ValueError, match=f"{copy}-byte"):
                fa_ops.flash_attention(*args)
            with pytest.raises(ValueError, match=f"{copy}-byte"):
                fa_ops._wgmma_tile_check(*(a[0, 0, :64].contiguous()
                                           if j != i else
                                           _shifted(a[0, 0, :64])
                                           for j, a in enumerate(args)))
        assert fa_ops.launch_counts() == before
    else:
        got = fa_ops.flash_attention(*(_shifted(t) for t in (q, k, v)))
        want = fa_ref.attention(q, k, v)
        torch.cuda.synchronize()
        atol, rtol = ATTENTION_BARS[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        assert int((got != want).sum()) <= 0.01 * got.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,N", [(2, 300, 130, 16), (1, 100, 64, 5),
                                     (1, 64, 33, 32)])
def test_cuda_mamba_scan_matches_plain(cuda_device, B, T, D, N):
    g = torch.Generator().manual_seed(T + D)
    dA = torch.exp(-torch.rand(B, T, D, N, generator=g)).to(cuda_device)
    dBu = (0.1 * torch.randn(B, T, D, N, generator=g)).to(cuda_device)
    C = torch.randn(B, T, N, generator=g).to(cuda_device)
    before = ms_ops.launch_counts()["mamba_scan"]
    got = ms_ops.mamba_scan(dA, dBu, C)
    want = ms_ref.mamba_scan(dA, dBu, C)
    torch.cuda.synchronize()
    assert ms_ops.launch_counts()["mamba_scan"] == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,N", [(2, 300, 130, 16), (1, 1001, 64, 5),
                                     (3, 7, 33, 32), (1, 1, 8, 1)])
def test_cuda_mamba_scan_final_state(cuda_device, B, T, D, N):
    """The kernel's final state at ragged T and N <= 32, against the plain
    version's, and y unchanged by asking for it."""
    g = torch.Generator().manual_seed(B * T + N)
    dA = torch.exp(-torch.rand(B, T, D, N, generator=g)).to(cuda_device)
    dBu = (0.1 * torch.randn(B, T, D, N, generator=g)).to(cuda_device)
    C = torch.randn(B, T, N, generator=g).to(cuda_device)
    before = ms_ops.launch_counts()["mamba_scan"]
    y, h = ms_ops.mamba_scan(dA, dBu, C, return_state=True)
    y_only = ms_ops.mamba_scan(dA, dBu, C)
    want_y, want_h = ms_ref.mamba_scan(dA, dBu, C, return_state=True)
    torch.cuda.synchronize()
    assert ms_ops.launch_counts()["mamba_scan"] == before + 2
    assert h.shape == (B, D, N) and h.dtype == torch.float32
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    assert torch.equal(y, y_only)


def _selective_inputs(B, T, D, N, dtype, dtr, seed, device):
    """u, dt (a softplus of seeded values), A = -(1..N) on every row, and
    B and C as column slices of one seeded ``[B, T, dtr + 2N]`` projection
    (as ``models.ssm`` takes them, at the offset ``dtr``)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, T, D, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, T, D, generator=g) - 2)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(D, 1)
    dbc = torch.randn(B, T, dtr + 2 * N, generator=g).to(dtype)
    u, dt, A, dbc = (t.to(device) for t in (u, dt, A, dbc))
    return u, dt, A, dbc[..., dtr:dtr + N], dbc[..., dtr + N:]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,N,dtype,dtr", [
    (2, 300, 130, 16, torch.bfloat16, 100),  # hymba's offset, ragged D
    (1, 1001, 64, 5, torch.float32, 7),
    (3, 7, 33, 32, torch.bfloat16, 3),   # B and C at an odd bf16 offset
    (1, 1, 8, 1, torch.bfloat16, 1),     # one step, one state
    (2, 65, 200, 16, torch.float32, 0),
    (1, 257, 1000, 16, torch.bfloat16, 256),
], ids=str)
def test_cuda_selective_scan_matches_plain(cuda_device, B, T, D, N, dtype,
                                           dtr):
    """The fused entry (dA and dBu formed in the kernel from u, dt, A and
    the strided B) against its plain version at 1e-4, with its final state
    and without; one launch each, y the same either way."""
    args = _selective_inputs(B, T, D, N, dtype, dtr, B * T + N, cuda_device)
    before = ms_ops.launch_counts()
    y, h = ms_ops.selective_scan(*args, return_state=True)
    y_only = ms_ops.selective_scan(*args)
    want_y, want_h = ms_ref.selective_scan(*args, return_state=True)
    torch.cuda.synchronize()
    after = ms_ops.launch_counts()
    assert after["selective_scan"] == before["selective_scan"] + 2
    assert after["mamba_scan"] == before["mamba_scan"]
    assert h.shape == (B, D, N) and h.dtype == torch.float32
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)
    assert torch.equal(y, y_only)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b",
                                  "phi_3_vision_4_2b",
                                  "seamless_m4t_large_v2"])
def test_cuda_served_families_match_plain(cuda_device, arch):
    """Each new family's smoke config in float32 on the card: prefill
    (the vision prefix, the encoder over frames) and 4 greedy decode
    steps through the attention kernel and through the plain versions,
    the kernel launched once an attention call (decoder layers, and the
    encoder's and cross-attention's), the scan never; logits within 1e-3
    (the f32 kernel is within 2e-5 of the plain version a call) and the
    greedy tokens equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    multimodal, prefill)

    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(cuda_device).manual_seed(3),
                         cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(4)
    B, T = 2, 40
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     generator=gen, device=cuda_device)}
    fe = 0
    if cfg.frontend == "vision":
        batch["frontend"] = multimodal.synthetic_frontend(cfg, gen, B)
        fe = cfg.frontend_tokens
    if cfg.is_enc_dec:
        batch["enc_input"] = multimodal.synthetic_frames(cfg, gen, B, 30)
    want_launches = cfg.n_layers + 2 * cfg.encoder_layers
    runs = {}
    for impl in ("cuda", "torch"):
        fa_ops.reset_launch_counts()
        ms_ops.reset_launch_counts()
        logits, cache = prefill(cfg, params, batch,
                                init_cache(cfg, B, fe + T + 4, cuda_device),
                                impl=impl)
        out = [logits]
        for i in range(4):
            logits, cache = decode_step(cfg, params,
                                        logits.argmax(-1)[:, None], cache,
                                        fe + T + i)
            out.append(logits)
        torch.cuda.synchronize()
        n = fa_ops.launch_counts()["flash_attention"]
        assert n == (want_launches if impl == "cuda" else 0), (impl, n)
        assert ms_ops.launch_counts()["selective_scan"] == 0
        runs[impl] = out
    for got, want in zip(runs["cuda"], runs["torch"]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------- training
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal,window,T,S", [
    (True, 0, 300, 300), (True, 64, 300, 300), (False, 0, 200, 333)])
def test_cuda_attention_gradients_match_plain(cuda_device, dtype, causal,
                                              window, T, S):
    """Under autograd the kernel route's output carries a ``grad_fn``
    and its q, k and v gradients are the plain route's bitwise (its
    backward is the plain version's, recomputed from the same inputs):
    causal, windowed, and bidirectional with T != S, GQA group 3."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda_device).manual_seed(31)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    q, k, v = rand(2, 6, T, 64), rand(2, 2, S, 64), rand(2, 2, S, 64)
    w = rand(2, 6, T, 64).float()
    grads = {}
    for impl in ("cuda", "torch"):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fa_ops.reset_launch_counts()
        out = fa_ops.flash_attention(*ins, causal=causal, window=window,
                                     impl=impl)
        assert out.grad_fn is not None
        assert fa_ops.launch_counts()["flash_attention"] == \
            (impl == "cuda")
        grads[impl] = torch.autograd.grad((out.float() * w).sum(), ins)
    for a, b in zip(grads["cuda"], grads["torch"]):
        assert a.dtype == dt and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_selective_scan_gradients_match_plain(cuda_device, dtype):
    """The fused entry under autograd: y and h_T carry a ``grad_fn``, and
    the gradients to u, dt, A and the projection whose strided column
    slices are B and C are the plain route's bitwise."""
    B, T, D, N, dtr = 2, 300, 130, 16, 5
    dt_ = getattr(torch, dtype)
    g = torch.Generator(cuda_device).manual_seed(32)
    u = torch.randn(B, T, D, generator=g, device=cuda_device).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, D, generator=g, device=cuda_device) - 3)
    A = -torch.rand(D, N, generator=g, device=cuda_device) - 0.5
    dbc = torch.randn(B, T, dtr + 2 * N, generator=g,
                      device=cuda_device).to(dt_)
    wy = torch.randn(B, T, D, generator=g, device=cuda_device)
    wh = torch.randn(B, D, N, generator=g, device=cuda_device)
    grads = {}
    for impl in ("cuda", "torch"):
        ins = [t.clone().requires_grad_(True) for t in (u, dt, A, dbc)]
        Bm, Cm = ins[3][..., dtr:dtr + N], ins[3][..., dtr + N:]
        ms_ops.reset_launch_counts()
        y, h = ms_ops.selective_scan(ins[0], ins[1], ins[2], Bm, Cm,
                                     return_state=True, impl=impl)
        assert y.grad_fn is not None and h.grad_fn is not None
        assert ms_ops.launch_counts()["selective_scan"] == (impl == "cuda")
        grads[impl] = torch.autograd.grad((y * wy).sum() + (h * wh).sum(),
                                          ins)
    for a, b in zip(grads["cuda"], grads["torch"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_entries_without_backward_raise_under_grad(cuda_device):
    """A kernel entry with no backward refuses an input that requires
    grad under grad mode (its output would have no ``grad_fn``), and
    launches under ``torch.no_grad()``."""
    g = torch.Generator(cuda_device).manual_seed(33)
    dA = torch.rand(1, 8, 4, 4, generator=g, device=cuda_device)
    dBu = torch.rand(1, 8, 4, 4, generator=g, device=cuda_device)
    C = torch.rand(1, 8, 4, generator=g, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        ms_ops.mamba_scan(dA.requires_grad_(True), dBu, C, impl="cuda")
    with torch.no_grad():
        ms_ops.mamba_scan(dA, dBu, C, impl="cuda")
    args = carousel_inputs(1000, 6, cuda_device)
    args[2].requires_grad_(True)  # done
    with pytest.raises(RuntimeError, match="no backward"):
        cu_ops.carousel_tick(*args, 10.0)
    with torch.no_grad():
        cu_ops.carousel_tick(*args, 10.0)
    q = torch.randn(64, 64, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops._wgmma_tile_check(q.requires_grad_(True), q.detach(),
                                 q.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba_1_5b", "olmoe_1b_7b",
                                  "seamless_m4t_large_v2"])
def test_cuda_train_step_matches_plain(cuda_device, arch):
    """One step's loss and gradients of a smoke config in float32 with
    remat on, through the kernels and through the plain versions from the
    same state: loss within rtol 1e-4, each leaf's relative L2 within
    1e-3 (the kernels' forward is within 2e-5 / 1e-4 of the plain
    versions; the embedding's backward accumulates with atomics), each
    kernel launched twice a layer (the forward and the recompute), none
    on the plain route."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, multimodal
    from repro_torch.models.convert import tree_leaves
    from repro_torch.train.train_step import value_and_grad

    cfg = get_smoke_config(arch).replace(dtype=torch.float32, remat=True)
    params = init_params(cfg, torch.Generator(cuda_device).manual_seed(5),
                         cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen,
                         device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_enc_dec:
        batch["enc_input"] = multimodal.synthetic_frames(cfg, gen, 2, 30)
    # self-attention (and cross-attention) a decoder layer, the encoder's
    # layers, each twice: the forward and remat's recompute
    n_attn = 2 * (cfg.n_layers * (1 + cfg.is_enc_dec) + cfg.encoder_layers)
    n_scan = 2 * cfg.n_layers if cfg.has_ssm else 0
    runs = {}
    for impl in ("cuda", "torch"):
        fa_ops.reset_launch_counts()
        ms_ops.reset_launch_counts()
        runs[impl] = value_and_grad(cfg, params, batch, impl)
        torch.cuda.synchronize()
        assert fa_ops.launch_counts()["flash_attention"] == \
            (n_attn if impl == "cuda" else 0)
        assert ms_ops.launch_counts()["selective_scan"] == \
            (n_scan if impl == "cuda" else 0)
    (lk, _, gk), (lp, _, gp) = runs["cuda"], runs["torch"]
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm()) + 1e-12


# ------------------------------------------------------------ mesh path
@pytest.fixture
def one_rank_mesh(cuda_device):
    """A one-rank NCCL ``DeviceMesh`` of the card (1 x 1), destroyed
    after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "hymba_1_5b", "qwen3_4b"])
def test_cuda_mesh_prefill_matches_no_mesh(one_rank_mesh, arch):
    """A smoke config's prefill in float32 on the 1x1 mesh (DTensor
    weights, batch and cache on the rules' placements) through the
    kernels against the no-mesh prefill: logits within 1e-3 (the serving
    tests' float32 bar), one attention launch a layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.parallel import plan_for
    from repro_torch.parallel.sharding import (batch_shardings,
                                               cache_shardings,
                                               param_shardings, shard_tree)
    from repro_torch.serve.engine import make_prefill_step

    mesh = one_rank_mesh
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(7), "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(8))
    batch = {"tokens": toks}
    want, _ = prefill(cfg, params, batch, init_cache(cfg, 2, 48, "cuda"),
                      impl="cuda")
    plan = plan_for(cfg, "prefill_32k", mesh)
    cache = init_cache(cfg, 2, 48, "cuda")
    step = make_prefill_step(cfg, "cuda", mesh=mesh,
                             moe_local_dispatch=plan.moe_local_dispatch,
                             no_ep=plan.no_ep)
    fa_ops.reset_launch_counts()
    got, _ = step(shard_tree(params, mesh, param_shardings(mesh, plan, params)),
                  shard_tree(batch, mesh, batch_shardings(mesh, batch)),
                  shard_tree(cache, mesh,
                             cache_shardings(mesh, plan, cfg, cache)))
    torch.cuda.synchronize()
    assert fa_ops.launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.full_tensor(), want, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba_1_5b", "olmoe_1b_7b"])
def test_cuda_mesh_train_step_matches_no_mesh(one_rank_mesh, arch):
    """One train step of a smoke config in float32 on the 1x1 mesh through
    the kernels against the no-mesh step from one state: loss rtol 1e-4,
    each gradient leaf's relative L2 within 1e-3 (the train tests' bars),
    each kernel launched twice a layer; then ``make_train_step(mesh=)``'s
    parameters after one step within the same bar."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import tree_leaves, tree_map
    from repro_torch.parallel import plan_for
    from repro_torch.parallel.ctx import sharding_ctx
    from repro_torch.parallel.sharding import (batch_shardings,
                                               param_shardings, shard_tree)
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, shard_state,
                                              value_and_grad)

    mesh = one_rank_mesh
    cfg = get_smoke_config(arch).replace(dtype=torch.float32, remat=True)
    plan = plan_for(cfg)
    params, opt = init_train_state(cfg, plan,
                                   torch.Generator("cuda").manual_seed(9),
                                   "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 41), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(10))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    lp, _, gp = value_and_grad(cfg, params, batch, "cuda")
    pd = shard_tree(params, mesh, param_shardings(mesh, plan, params))
    bd = shard_tree(batch, mesh, batch_shardings(mesh, batch))
    fa_ops.reset_launch_counts()
    ms_ops.reset_launch_counts()
    with sharding_ctx(mesh):
        lk, _, gk = value_and_grad(cfg, pd, bd, "cuda")
    torch.cuda.synchronize()
    assert fa_ops.launch_counts()["flash_attention"] == 2 * cfg.n_layers
    assert ms_ops.launch_counts()["selective_scan"] == \
        (2 * cfg.n_layers if cfg.has_ssm else 0)
    torch.testing.assert_close(lk.full_tensor(), lp, rtol=1e-4, atol=0)
    gk = tree_map(lambda g: g.full_tensor(), gk)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm()) + 1e-12
    want_p, _, _ = make_train_step(cfg, plan, impl="cuda")(params, opt, batch)
    got_p, _, _ = make_train_step(cfg, plan, impl="cuda", mesh=mesh)(
        *shard_state(params, opt, mesh, plan), bd)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        torch.testing.assert_close(a.full_tensor(), b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_sharded_sweep_bitwise_to_unsharded(cuda_device):
    """``run_sweep(shard=True)`` over the lane mesh of every visible card
    (one block of lanes a card) bitwise to the unsharded run, with and
    without lane chunks."""
    from repro_torch.core.scenarios import ScenarioSpec
    from repro_torch.parallel.sharding import lane_mesh
    from repro_torch.sim.sweep import run_sweep

    specs = [ScenarioSpec(base="III", cache_tb=c, days=0.05, n_files=5000,
                          seed=s) for c in (5.0, 20.0, 80.0)
             for s in (1, 2, 3)]
    want = run_sweep(specs, tick=10.0, tick_impl="cuda", device="cuda")
    assert lane_mesh().size == torch.cuda.device_count()
    for kw in ({}, {"lane_chunk": 4}):
        got = run_sweep(specs, tick=10.0, tick_impl="cuda", device="cuda",
                        shard=True, **kw)
        for a, b in zip(got.results, want.results):
            assert a.spec == b.spec and a.metrics == b.metrics, kw
            assert a.cost_usd == b.cost_usd, kw


# ------------------------------------------------ the tick's tracing
def _unlimited_grid():
    """Three Config III lanes with a small disk and unlimited GCS: files
    wait, links are busy, files migrate, and no GCS admission sits at a
    capacity tie, so the kernels' tick and the plain one agree exactly."""
    from repro_torch.core.scenarios import ScenarioSpec, pack_specs

    return pack_specs([ScenarioSpec(base="III", cache_tb=1.0 + 2.0 * i,
                                    seed=i, days=0.1, n_files=2000)
                       for i in range(3)], tick=10.0)


def _traced_loop(grid, device, tick_impl, graph):
    """A loop built with the tracer on, run to its end and read: the loop
    and its ``sweep.torch.tick`` instant."""
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.obs.trace import get_tracer
    from repro_torch.sim.batched import TickLoop

    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        loop = TickLoop(grid, resolve_tick_impl(tick_impl, device), device,
                        graph=graph)
        loop.advance(grid.n_ticks)
        loop.result()
        (tick,) = [e["args"] for e in tracer.events
                   if e["name"] == "sweep.torch.tick"]
    finally:
        tracer.disable()
        tracer.reset()
    return loop, tick


@pytest.mark.cuda
def test_cuda_traced_tick_launches_the_untraced_ticks_kernels(cuda_device):
    """The captured tick's lane-tick and glue launches are the same traced
    and untraced; untraced it launches nothing of the trace library,
    traced one stamp a segment and one count a tick, replays included."""
    from repro_torch.kernels import trace_tick
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    grid = _small_grid()
    trace_tick.reset_launch_counts()
    loop = TickLoop(grid, resolve_tick_impl("cuda", cuda_device), cuda_device,
                    graph=True)
    loop.advance(grid.n_ticks)
    loop.result()
    assert not loop.trace and "trace_acc" not in loop.st
    untraced = loop._per_tick
    loop.close()
    assert trace_tick.launch_counts() == {k: 0 for k in trace_tick.KERNELS}
    loop, tick = _traced_loop(grid, cuda_device, "cuda", graph=True)
    assert loop._per_tick[:2] == untraced
    assert loop._per_tick[2] == {"trace_stamp": len(trace_tick.SEGMENTS),
                                 "trace_count": 1}
    assert trace_tick.launch_counts() == {
        "trace_stamp": len(trace_tick.SEGMENTS) * grid.n_ticks,
        "trace_count": grid.n_ticks}
    loop.close()


@pytest.mark.cuda
def test_cuda_trace_of_a_replayed_loop_matches_the_plain_path(cuda_device):
    """A replayed traced loop's counts equal the eager kernel tick's and
    the plain tick's on the CPU, lane by lane; its stamps read the card's
    clock over the replayed ticks only: every segment booked once a
    replayed tick, sums and maxima consistent, one gap fewer."""
    from repro_torch.kernels import trace_tick
    from repro_torch.sim.batched import GRAPH_WARMUP_TICKS

    grid = _unlimited_grid()
    replayed, tick = _traced_loop(grid, cuda_device, "cuda", graph=True)
    eager, _ = _traced_loop(grid, cuda_device, "cuda", graph=False)
    plain, plain_tick = _traced_loop(grid, torch.device("cpu"), "torch",
                                     graph=False)
    counts = replayed.st["trace_counts"].cpu()
    assert torch.equal(counts, eager.st["trace_counts"].cpu())
    assert torch.equal(counts, plain.st["trace_counts"])
    assert counts[:, 3].sum() > 0 and counts[:, 2].sum() > 0
    assert tick["counts"] == plain_tick["counts"]
    assert tick["clock"] == "globaltimer"
    n = grid.n_ticks - GRAPH_WARMUP_TICKS
    assert tick["ticks"] == n and tick["replay_gap"]["n"] == n - 1
    for name, seg in tick["segments"].items():
        assert 0 < seg["sum_ns"] and seg["max_ns"] * n >= seg["sum_ns"], name
        assert seg["max_ns"] <= seg["sum_ns"], name
    for loop in (replayed, eager, plain):
        loop.close()


@pytest.mark.cuda
def test_cuda_traced_plain_tick_runs_on_the_card(cuda_device):
    """The plain tick on the card, traced: its glue keeps no counts in a
    work buffer, so it counts with the plain count and stamps on the
    card's clock. Its results are bitwise the untraced plain tick's on
    the card, its counts the plain tick's on the CPU."""
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    grid = _unlimited_grid()
    traced, tick = _traced_loop(grid, cuda_device, "torch", graph=False)
    cpu, cpu_tick = _traced_loop(grid, torch.device("cpu"), "torch",
                                 graph=False)
    untraced = TickLoop(grid, resolve_tick_impl("torch", cuda_device),
                        cuda_device, graph=False)
    untraced.advance(grid.n_ticks)
    want = untraced.result()
    got = traced.result()
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert tick["clock"] == "globaltimer" and tick["ticks"] == grid.n_ticks
    assert tick["counts"] == cpu_tick["counts"]
    assert tick["lane_ticks"] == cpu_tick["lane_ticks"] > 0
    for loop in (traced, cpu, untraced):
        loop.close()


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4096, 1001])
def test_cuda_trace_count_kernel_matches_plain(cuda_device, F):
    """The counter kernel against the plain count on random planes, in
    16-byte loads (F a multiple of 16) and byte loads: a counted tick adds
    each lane's counts (the admitted migrations from the glue's ``work``
    rows), the next tick adds nothing."""
    from repro_torch.kernels.tick_glue import ops as glue
    from repro_torch.kernels.trace_tick import ops as trk
    from repro_torch.kernels.trace_tick import ref as trk_ref

    g = torch.Generator().manual_seed(F)
    L, S = 3, 2
    want = torch.rand((L, S, F), generator=g) < 0.1
    wait = torch.rand((L, S, F), generator=g) < 0.3
    mig = want & (torch.rand((L, S, F), generator=g) < 0.5)
    occ3 = torch.randint(0, 40, (L, S, 3), generator=g).to(torch.float32)
    lq_serve = torch.randint(0, 100, (L, 3 * S), generator=g,
                             dtype=torch.int32)
    lq_next = lq_serve + torch.randint(0, 9, (L, 3 * S), generator=g,
                                       dtype=torch.int32)
    work = torch.zeros((glue._LIB.get().tg_work_ints(L, S),),
                       dtype=torch.int32)
    n_direct, n_queued = glue.migration_counts(work, L, S)
    per_row = mig.sum(-1).view(-1).to(torch.int32)
    n_direct.copy_(per_row // 3)
    n_queued.copy_(per_row - per_row // 3)
    want_counts = torch.zeros((L, len(trk.COUNTS)), dtype=torch.int64)
    got = want_counts.to(cuda_device)
    dev = [t.to(cuda_device) for t in (want, mig, occ3, lq_next, lq_serve,
                                       wait)]
    for tick in (1, 2, 1 + trk.COUNT_STRIDE):
        t = torch.tensor([tick], dtype=torch.int64)
        trk_ref.count(want_counts, t, want, mig, occ3, lq_next, lq_serve,
                      wait)
        trk.count(got, t.to(cuda_device), *dev, work.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want_counts), tick
    assert want_counts[:, 5].tolist() == [2] * L
    assert want_counts[:, 0].sum() > 0
