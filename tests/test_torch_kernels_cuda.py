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
differs on about 40%), each case through the kernel its dtype and width
route to, and the wgmma and tf32x3 kernels' pieces bitwise on integer
inputs; the
Mamba scan at 1e-4 (the sum over
the state runs in another order).
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
@pytest.mark.parametrize("case", ["random", "F not a multiple of 4, byte loads",
                                  "F below a tile", "many rows",
                                  "every file waiting",
                                  "a few waiting files over many tiles",
                                  "unaligned planes"])
@pytest.mark.parametrize("W", [1, 4, 5, 32])
def test_cuda_wait_select_bitwise(cuda_device, W, case):
    """``tg_wait_select`` against the plain selection (``torch.topk`` of
    the keys): ``lowest`` and ``idx`` bitwise, one launch, at W of the
    specialised list (W <= 4) and of the general one."""
    st, c, x = _glue_inputs(case, cuda_device, seed=W)
    W = min(W, st["wq_wait"].shape[-1])
    before = tg_ops.launch_counts()["glue_wait_select"]
    got = _glue_step(tg_ops, "wait_select", st, c, x, W)
    assert tg_ops.launch_counts()["glue_wait_select"] == before + 1
    want = _glue_step(tg_ref, "wait_select", st, c, x, W)
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
    # bf16 at a width that is not a multiple of 8: the SIMT kernel
    (1, 4, 2, 150, 150, 100, torch.bfloat16, True, 0),
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
    if dtype == torch.float32:
        route = "tf32x3"
    else:
        route = "wgmma" if hd % 8 == 0 else "simt"
    assert fa_ops._route(dtype, hd) == route
    before = fa_ops.launch_counts()
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa_ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    key = f"flash_attention_{route}"
    assert after[key] == before[key] + 1
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = ATTENTION_BARS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dtype == torch.bfloat16:
        assert int((got != want).sum()) <= 0.01 * got.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("hdp", fa_ops.WGMMA_WIDTHS)
def test_cuda_wgmma_tile_bitwise(cuda_device, hdp):
    """The wgmma kernel's TMA maps, swizzle, descriptors, fragment layouts
    and two-half split on one 64-row tile: with small integer inputs every
    sum is exact, so S = q k^T and O = S v equal the plain products."""
    bk = fa_ops.WGMMA_KEYS
    g = torch.Generator().manual_seed(hdp)
    q, k, v = (torch.randint(-3, 4, shape, generator=g)
               .to(cuda_device, torch.bfloat16)
               for shape in ((64, hdp), (bk, hdp), (bk, hdp)))
    s, o = fa_ops._wgmma_tile_check(q, k, v)
    s_ref = q.float() @ k.float().T
    assert torch.equal(s, s_ref)
    assert torch.equal(o, s_ref @ v.float())


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
