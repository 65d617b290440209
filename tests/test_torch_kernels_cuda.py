"""The port's CUDA lane-tick kernels against their plain versions, on a
CUDA device.

Every test here is marked ``cuda`` and skips without a device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed::

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Bars: transfer ``new_done`` and completion bitwise (the kernel rounds like
the plain version's separate ops), billing at rtol 1e-6 (reduction
order); windows bitwise; GCS admission equal except at capacity-boundary
ties (no bitwise promise against ``torch.cumsum``'s order), occupancy at
rtol 1e-5.
"""

import pytest
import torch

from repro_torch.kernels.lane_tick import ops, ref
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
