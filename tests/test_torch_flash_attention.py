"""The port's attention forward against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.flash_attention``
(``attention_ref``, the definition, and the Pallas kernel in interpret
mode) and through ``repro_torch.kernels.flash_attention``'s plain version.
Bars as ``tests/test_kernels.py``'s sweep: 2e-5 in float32, 2e-2 in
bfloat16 (atol and rtol). The CUDA kernel is held against the plain
version on a card by ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def attention_inputs(B, nh, nkv, T, S, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, nh, T, hd)).astype(np.float32),
            rng.normal(size=(B, nkv, S, hd)).astype(np.float32),
            rng.normal(size=(B, nkv, S, hd)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in arrays]
    # the port gets the very values JAX rounded to bfloat16
    tt = [torch.as_tensor(np.array(a, np.float32)).to(tdt) for a in jx]
    return jx, tt, tol


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,nh,nkv,T,hd", [
    (1, 2, 1, 64, 32),
    (2, 4, 2, 200, 64),      # T unaligned to the Pallas 128 tiles
    (1, 8, 8, 256, 128),
    (1, 5, 1, 96, 64),       # hymba-like: 5 query heads on 1 kv head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_attention_matches_repro(B, nh, nkv, T, hd, dtype, window):
    jx, tt, tol = _both(attention_inputs(B, nh, nkv, T, T, hd, T + hd),
                        dtype)
    got = ops.flash_attention(*tt, causal=True, window=window)
    assert got.dtype == tt[0].dtype and got.shape == tt[0].shape
    _close(got, attention_ref(*jx, causal=True, window=window), tol)
    _close(got, jx_flash(*jx, causal=True, window=window, use_pallas=True),
           tol)


@pytest.mark.parametrize("window", [0, 16])
def test_attention_not_causal_unaligned(window):
    """``causal=False`` with S = 100, held against ``attention_ref`` only.
    ``repro``'s Pallas path pads S to 128 with zero keys and relies on the
    causal mask to drop them (``flash_attention/ops.py:33-34``); without
    it the padded keys enter the softmax, so that path is off the
    definition here. The port masks keys at positions >= S instead."""
    jx, tt, tol = _both(attention_inputs(1, 2, 1, 100, 100, 32, 5),
                        "float32")
    got = ops.flash_attention(*tt, causal=False, window=window)
    _close(got, attention_ref(*jx, causal=False, window=window), tol)


def test_attention_rows_with_every_key_masked():
    """T > S with a window: late queries see no key. The definition then
    averages every key uniformly (masked scores are -1e30, not -inf)."""
    jx, tt, tol = _both(attention_inputs(1, 2, 2, 80, 40, 16, 9),
                        "float32")
    got = ops.flash_attention(*tt, causal=True, window=8)
    _close(got, attention_ref(*jx, causal=True, window=8), tol)
    late = got[:, :, -1]
    torch.testing.assert_close(late, tt[2].mean(2), rtol=1e-5, atol=1e-6)


def test_cuda_impl_on_cpu_tensors_raises():
    _, tt, _ = _both(attention_inputs(1, 2, 1, 8, 8, 8, 0), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*tt, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.flash_attention(*tt, impl="pallas")
    assert ops.launch_counts() == {"flash_attention": 0}
