"""The port's CUDA kernels against their plain versions, on a CUDA device.

Every test here is marked ``cuda`` and skips without a device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed::

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Bars: transfer ``new_done`` and completion bitwise (the kernel rounds like
the plain version's separate ops), billing at rtol 1e-6 (reduction
order); windows bitwise; GCS admission equal except at capacity-boundary
ties (no bitwise promise against ``torch.cumsum``'s order), occupancy at
rtol 1e-5; carousel ``new_done``, completion and counts bitwise (the
kernel rounds like the plain version, counts are integer atomics);
attention in float32 at 2e-5 atol/rtol, in bfloat16 at atol 4e-3 and
rtol 8e-3 with at most 1% of the elements unequal (both sides compute in
float32 and round once, so they differ by at most one ulp and only next
to a rounding boundary; SDPA, which rounds its probabilities to
bfloat16, differs on about 40%); the Mamba scan at 1e-4 (the sum over
the state runs in another order).
"""

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


@pytest.mark.cuda
def test_cuda_gcs_admit_matches_plain(cuda_device):
    want, sizes, used0, limit = (torch.as_tensor(a, device=cuda_device)
                                 for a in gcs_inputs(S=2, F=20000))
    dt, month = scalars(cuda_device, dt=10.0)
    before = ops.launch_counts()["gcs_admit"]
    got = ops.gcs_admit(want, sizes, used0, limit, dt, month, N_MONTHS)
    plain = ref.gcs_admit(want, sizes, used0, limit, dt, month, N_MONTHS)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gcs_admit"] == before + 1
    assert int((got[0] != plain[0]).sum()) <= 2
    torch.testing.assert_close(got[1], plain[1], rtol=1e-5, atol=0.0)
    assert torch.equal(got[0][-1], want[-1])  # unlimited lane


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
    before = fa_ops.launch_counts()["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = ATTENTION_BARS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dtype == torch.bfloat16:
        assert int((got != want).sum()) <= 0.01 * got.numel()


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
