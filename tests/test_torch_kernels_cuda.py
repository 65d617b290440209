"""The port's CUDA kernels against their plain versions, on a CUDA device.

Every test here is marked ``cuda`` and skips without a device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed::

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Bars: transfer ``new_done`` and completion bitwise (the kernel rounds like
the plain version's separate ops), billing at rtol 1e-6 (reduction
order); windows bitwise; GCS admission equal except at capacity-boundary
ties (no bitwise promise against ``torch.cumsum``'s order), occupancy at
rtol 1e-5, the migration rank bitwise against the per-site rank of the
kernel's own mask (and of the plain version's, where the masks agree),
two calls bitwise equal; carousel ``new_done``, completion and counts
bitwise (the kernel rounds like the plain version, counts are integer
atomics);
attention in float32 at 2e-5 atol/rtol, in bfloat16 at atol 4e-3 and
rtol 8e-3 with at most 1% of the elements unequal (both sides compute in
float32, the wgmma kernel carrying its probabilities as two bf16 halves,
and round once, so they differ by at most one ulp and only next to a
rounding boundary; SDPA, which rounds its probabilities to bfloat16,
differs on about 40%), each case through the kernel its dtype and width
route to, and the wgmma kernel's pieces bitwise on integer inputs; the
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
from torch_lane_inputs import (
    N_MONTHS,
    gcs_inputs,
    scalars,
    stack_transfer,
    transfer_inputs,
    window_inputs,
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
    limit = used + sizes.reshape(3, -1).gather(1, first[:, None])[:, 0]
    got, plain = _gcs_run(want, sizes, used, limit)
    _assert_gcs_equal(got, plain)
    assert got[0].reshape(3, -1).sum(1).tolist() == [1, 1, 1]
    assert bool(got[0].reshape(3, -1).gather(1, first[:, None]).all())
    assert torch.equal(got[1], limit)


@pytest.mark.cuda
def test_cuda_gcs_admit_two_calls_bitwise(cuda_device):
    want, sizes, used0, limit = (torch.as_tensor(a, device=cuda_device)
                                 for a in gcs_inputs(S=2, F=50000, seed=3))
    a, _ = _gcs_run(want, sizes, used0, limit)
    b, _ = _gcs_run(want, sizes, used0, limit)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("fifo", [False, True])
def test_cuda_window_admit_bitwise(cuda_device, fifo):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in window_inputs(fifo)]
    got = ops.window_admit(*args, fifo)
    want = ref.window_admit(*args, fifo)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda_device):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in window_inputs(False)]
    with pytest.raises(ValueError, match="float32"):
        ops.window_admit(args[0], args[1].double(), args[2], args[3], False)
    with pytest.raises(ValueError, match="on cuda"):
        ops.window_admit(args[0], args[1].cpu(), args[2], args[3], False)
    with pytest.raises(ValueError, match="contiguous"):
        ops.window_admit(args[0], args[1].transpose(0, 1).contiguous()
                         .transpose(0, 1), args[2], args[3], False)


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
    route = "wgmma" if dtype == torch.bfloat16 and hd % 8 == 0 else "simt"
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
