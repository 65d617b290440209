"""Why the float32 attention kernel forms each product from split TF32
operands, shown on the CPU.

``kernel_model`` is a plain-torch model of the arithmetic of
``csrc/flash_attention_tf32x3.cu``: each operand split into TF32 halves,
``hi = tf32(x)``, rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
away from zero), and ``lo`` = ``x - hi`` truncated to TF32, both on the
float32 bits as the kernel does; each product summed over steps
of 8 along its inner axis, each step adding ``lo.hi'``, then ``hi.lo'``,
then ``hi.hi'`` to a float32 accumulator (for the scores, the two small
terms to an accumulator of their own, added at the end); the scores
multiplied by
hd^-0.5 * log2(e) after the product; an online softmax on exp2 over the
kernel's key tiles (``kernel_tiles``) with float32 running max,
normaliser and accumulator; P split like the other operands; one
division at the end. The same inputs, made with numpy from a seed, go
through ``repro``'s ``attention_ref`` (JAX) and the port's ``ref.attention``,
and the model is held to both at the kernel's bar, 2e-5 atol and rtol.
The model with one TF32 product (``hi.hi'`` alone) misses that bar: the
recorded reason for the split. The tensor cores' own float32
accumulation is not modelled; the card's test holds the kernel itself
(``tests/test_torch_kernels_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops, ref
from torch_threads import one_torch_thread  # noqa: F401

ATOL = RTOL = 2e-5


def kernel_tiles(hd):
    """``(stages, keys)`` of the kernel's K/V ring at head width ``hd``, as
    the model assumes it (``Tiles`` in the source; the card's
    ``test_cuda_tf32x3_tiles`` holds the kernel's own answer,
    ``fa_tf32x3_tiles``, to the same widths): at hd rounded up to 8, the
    first of 2 stages of 64 or 32 keys, 1 of 32, 2 of 16 or 1 of 16 whose
    shared memory (Q's 64 rows, K and V per stage, rows hd8 + 4 floats
    apart) lets two CTAs share an SM of 228 KB, each reserving 1 KB."""
    w = -(-hd // 8) * 8
    for stages, keys in ((2, 64), (2, 32), (1, 32), (2, 16), (1, 16)):
        if 2 * (4 * (w + 4) * (64 + 2 * stages * keys) + 1024) <= 233472:
            return stages, keys
    raise ValueError(f"head_dim {hd}: no K/V ring fits two CTAs an SM")


def tf32(x):
    """``x`` (float32) rounded to TF32, 10 mantissa bits, on its bits: to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate(x):
    """``x`` (float32) with its low 13 bits cleared: TF32 toward zero."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, truncate(x - hi)


def products(a, b, terms=3, small_apart=False):
    """``a [..., M, K] . b [..., N, K]^T`` the kernel's way: K zero-padded
    to a multiple of 8 and summed in steps of 8, each step adding
    ``lo.hi'``, ``hi.lo'`` and ``hi.hi'`` (``terms=3``) or ``hi.hi'`` alone
    (``terms=1``) in turn to a float32 accumulator; ``small_apart`` keeps
    the two small terms in an accumulator of their own, added last."""
    pad = (-a.shape[-1]) % 8
    (ah, al), (bh, bl) = split(F.pad(a, (0, pad))), split(F.pad(b, (0, pad)))
    acc = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    small = torch.zeros_like(acc) if small_apart else acc
    for k0 in range(0, a.shape[-1] + pad, 8):
        def step(x, y):
            return x[..., k0:k0 + 8] @ y[..., k0:k0 + 8].transpose(-1, -2)
        if terms == 3:
            small = small + step(al, bh)
            small = small + step(ah, bl)
            if not small_apart:
                acc = small
        acc = acc + step(ah, bh)
        if not small_apart:
            small = acc
    return acc + small if small_apart else acc


def kernel_model(q, k, v, *, causal, window, terms=3):
    """The tf32x3 kernel's arithmetic on float32 ``q [B, nh, T, hd]``,
    ``k/v [B, nkv, S, hd]``. Skipping key tiles outside every row's mask
    changes nothing here (those pairs weigh exactly 0), so every tile is
    walked."""
    B, nh, T, hd = q.shape
    S = k.shape[2]
    rep = nh // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    # hd^-0.5 as the wrapper hands it over (float32), times log2(e) there
    scale_log2 = (torch.tensor(hd ** -0.5, dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32))
    scores = products(q, k, terms, small_apart=True) * scale_log2
    bk = kernel_tiles(hd)[1]
    t = torch.arange(T)[:, None]
    m = torch.full((B, nh, T, 1), ref.MASKED)
    l = torch.zeros((B, nh, T, 1))
    acc = torch.zeros((B, nh, T, hd))
    for s0 in range(0, S, bk):
        s = scores[..., s0:s0 + bk]
        rel = t - torch.arange(s0, s0 + s.shape[-1])[None, :]
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
        vt = v[:, :, s0:s0 + bk].transpose(-1, -2)
        acc = acc * corr + products(p, vt, terms)
        m = m_new
    return acc / l


def _inputs(B, nh, nkv, T, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, nh, T, hd), (B, nkv, S, hd), (B, nkv, S, hd))]


def _outside(got, want):
    """Elements of ``got`` outside the bar around ``want``."""
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


#: (nh, nkv, T, S, window): GQA groups of 2 and 5; T = S; T > S, where the
#: rows from S + window - 1 on see no key (every key masked); T < S.
CASES = [
    (4, 2, 256, 256, 64),
    (5, 1, 200, 130, 64),
    (10, 2, 130, 200, 0),
]


@pytest.mark.parametrize("hd", [64, 168])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_products_hold_the_bar(hd, case):
    nh, nkv, T, S, window = case
    arrays = _inputs(1, nh, nkv, T, S, hd, seed=hd + T + S)
    q, k, v = map(torch.as_tensor, arrays)
    got = kernel_model(q, k, v, causal=True, window=window)
    want_jax = torch.as_tensor(np.array(attention_ref(
        *map(jnp.asarray, arrays), causal=True, window=window)))
    want = ref.attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want_jax, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    if T > S + window - 1:
        # the late rows average every key, as the definition does
        torch.testing.assert_close(got[:, :, -1], v.repeat_interleave(
            nh // nkv, dim=1).mean(2), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hd", [64, 168])
def test_one_tf32_product_misses_the_bar(hd):
    nh, nkv, T, S, window = CASES[0]
    arrays = _inputs(1, nh, nkv, T, S, hd, seed=hd + T + S)
    q, k, v = map(torch.as_tensor, arrays)
    want = torch.as_tensor(np.array(attention_ref(
        *map(jnp.asarray, arrays), causal=True, window=window)))
    single = kernel_model(q, k, v, causal=True, window=window, terms=1)
    assert _outside(single, want) > 0.01 * want.numel()
    assert _outside(kernel_model(q, k, v, causal=True, window=window),
                    want) == 0


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    """hi as ``cvt.rna.tf32.f32`` rounds; lo = x - hi truncated."""
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=4096).astype(np.float32))
    hi, lo = split(x)
    # hi keeps 11 significant bits; lo, truncated, 11 more of x - hi
    assert bool(((hi - x).abs() <= 2 ** -11 * x.abs()).all())
    assert bool(((hi + lo - x).abs() <= 2 ** -21 * x.abs()).all())
    assert int((hi != x).sum()) > 0.99 * x.numel()


@pytest.mark.parametrize("hd,tiles", [
    (1, (2, 64)), (64, (2, 64)), (72, (2, 64)), (100, (2, 32)),
    (128, (2, 32)), (144, (2, 32)), (168, (1, 32)), (200, (1, 32)),
    (224, (1, 16)), (256, (1, 16))])
def test_tf32x3_tiles_let_two_ctas_share_an_sm(hd, tiles):
    """The model's K/V ring at each padded width: stages and keys, and the
    CTA's shared memory (Q's 64 rows, K and V per stage, rows hd8 + 4
    floats apart) small enough for two CTAs on an SM of 228 KB, each also
    reserving 1 KB. The card's ``test_cuda_tf32x3_tiles`` holds the
    kernel to the same table."""
    assert kernel_tiles(hd) == tiles
    stages, keys = tiles
    hd8 = -(-hd // 8) * 8
    assert 233472 // (4 * (hd8 + 4) * (64 + 2 * stages * keys) + 1024) >= 2


def test_tf32x3_probe_refuses_cpu_tensors_and_other_widths():
    q = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops._tf32x3_tile_check(q, q, q)
    with pytest.raises(ValueError, match="width"):
        ops._tf32x3_tile_check(q[:, :12].contiguous(), q, q)
    with pytest.raises(ValueError, match="width"):
        ops._tf32x3_tile_check(torch.zeros((16, 72)), q, q)
    assert ops.launch_counts()["flash_attention"] == 0
