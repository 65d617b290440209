"""The port's Mamba-1 selective scan against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.mamba_scan`` (its
associative-scan reference and its Pallas kernel, which always runs in
interpret mode: ``repro``'s wrapper never passes ``interpret``) and through
``repro_torch.kernels.mamba_scan``'s plain version, a loop over T. The two
sum in different orders, so the bar is 1e-4 (atol and rtol), as in
``tests/test_kernels.py``. The CUDA kernel is held against the plain
version on a card by ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.mamba_scan.ops import mamba_scan as jx_scan
from repro_torch.kernels.mamba_scan import ops


def scan_inputs(B, T, D, N, seed):
    rng = np.random.default_rng(seed)
    dA = np.exp(-rng.random((B, T, D, N))).astype(np.float32)
    dBu = rng.normal(size=(B, T, D, N)).astype(np.float32) * 0.1
    C = rng.normal(size=(B, T, N)).astype(np.float32)
    return dA, dBu, C


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B,T,D,N", [
    (1, 64, 128, 8),
    (2, 300, 130, 16),   # unaligned to the Pallas chunk and block
    (1, 512, 256, 16),
])
def test_scan_matches_repro(B, T, D, N, use_pallas):
    arrays = scan_inputs(B, T, D, N, T + D)
    want = jx_scan(*map(jnp.asarray, arrays), use_pallas=use_pallas)
    got = ops.mamba_scan(*map(torch.as_tensor, arrays))
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_scan_carry_across_chunks():
    """The state persists past the Pallas kernel's 256-step chunk: a
    constant decay and input accumulate monotonically through t = 256."""
    B, T, D, N = 1, 512, 128, 4
    dA = np.full((B, T, D, N), 0.999, np.float32)
    dBu = np.full((B, T, D, N), 0.01, np.float32)
    C = np.ones((B, T, N), np.float32)
    y = ops.mamba_scan(*map(torch.as_tensor, (dA, dBu, C)))
    assert float(y[0, 256, 0]) > float(y[0, 255, 0]) > float(y[0, 0, 0])
    for use_pallas in (False, True):
        want = jx_scan(*map(jnp.asarray, (dA, dBu, C)),
                       use_pallas=use_pallas)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4)


def test_cuda_impl_on_cpu_tensors_raises():
    arrays = [torch.as_tensor(a) for a in scan_inputs(1, 4, 8, 4, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.mamba_scan(*arrays, impl="cuda")
    assert ops.launch_counts() == {"mamba_scan": 0}
