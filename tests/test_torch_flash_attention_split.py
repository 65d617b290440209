"""Why the wgmma attention kernel carries its probabilities as two bf16
halves, shown on the CPU, and which kernel each input goes to.

``kernel_model`` is a plain-torch model of the numerics of
``csrc/flash_attention_wgmma.cu``: bf16 Q, K and V; float32 scores
multiplied by hd^-0.5 * log2(e) after the product; an online softmax on
exp2 over tiles of ``BK`` keys with float32 running max, normaliser and
accumulator; P split
into ``bf16(p)`` and ``bf16(p - bf16(p))`` for the second product; one
bf16 rounding at the end. Held against the port's definition
(``ref.attention``) at the kernel's bar: one bf16 ulp (atol 4e-3, rtol
8e-3) and at most 1% of the elements unequal. The same model with P rounded
once to bf16 (SDPA's and a textbook FlashAttention-3's choice) leaves far
more than 1% unequal.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

ATOL, RTOL, UNEQUAL_SHARE = 4e-3, 8e-3, 0.01


def kernel_model(q, k, v, *, causal, window, bk, split=True):
    """The wgmma kernel's arithmetic on bf16 ``q [B, nh, T, hd]``, ``k/v
    [B, nkv, S, hd]``; ``split=False`` rounds P once to bf16 instead."""
    B, nh, T, hd = q.shape
    S = k.shape[2]
    rep = nh // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    qf = q.float()
    t = torch.arange(T)[:, None]
    m = torch.full((B, nh, T, 1), ref.MASKED)
    l = torch.zeros((B, nh, T, 1))
    acc = torch.zeros((B, nh, T, hd))
    for s0 in range(0, S, bk):
        kt, vt = k[:, :, s0:s0 + bk], v[:, :, s0:s0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * (hd ** -0.5 * math.log2(math.e))
        rel = t - torch.arange(s0, s0 + kt.shape[2])[None, :]
        keep = torch.ones_like(rel, dtype=torch.bool)
        if causal:
            keep &= rel >= 0
        if window > 0:
            keep &= rel < window
        s = s.masked_fill(~keep, ref.MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        if split:
            pv = p_hi @ vt + (p - p_hi).bfloat16().float() @ vt
        else:
            pv = p_hi @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l).bfloat16()


def _inputs(B, nh, nkv, T, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=shape).astype(np.float32))
            .bfloat16() for shape in ((B, nh, T, hd), (B, nkv, S, hd),
                                      (B, nkv, S, hd))]


@pytest.mark.parametrize("hd", [64, 168])
@pytest.mark.parametrize("window", [0, 64])
def test_split_probabilities_hold_the_bar(hd, window):
    q, k, v = _inputs(1, 4, 2, 256, 256, hd, seed=hd + window)
    bk = ops.WGMMA_KEYS
    want = ref.attention(q, k, v, causal=True, window=window)
    got = kernel_model(q, k, v, causal=True, window=window, bk=bk)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL,
                               rtol=RTOL)
    assert int((got != want).sum()) <= UNEQUAL_SHARE * got.numel()
    # one bf16 rounding of P moves far more outputs off the definition
    single = kernel_model(q, k, v, causal=True, window=window, bk=bk,
                          split=False)
    assert int((single != want).sum()) > UNEQUAL_SHARE * got.numel()


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 168, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 100, "simt"),
    (torch.bfloat16, 4, "simt"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
    (torch.float32, 168, "tf32x3"),
    (torch.float32, 3, "tf32x3"),
    (torch.float32, 100, "tf32x3"),
    (torch.float32, 256, "tf32x3"),
])
def test_route_by_dtype_and_width(dtype, hd, route):
    assert ops._route(dtype, hd) == route


def test_wgmma_probe_refuses_cpu_tensors_and_other_widths():
    q = torch.zeros((64, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ops._wgmma_tile_check(q, q, q)
    with pytest.raises(ValueError, match="bucket"):
        ops._wgmma_tile_check(q[:, :100], q, q)
    assert ops.launch_counts()["flash_attention"] == 0
