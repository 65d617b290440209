"""Why the wgmma attention kernel carries its probabilities as two bf16
halves, shown on the CPU, which kernel and loader each input goes to, and
where the kernel's thread loader puts each value.

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
more than 1% unequal. At a head width that is not a bucket the kernel
pads hd with zero columns, which change no sum, so the model runs at hd
itself.

``thread_loader_tile`` models the wgmma kernel's thread loader
(``make_walk``, ``load_tile`` and ``zero_pad`` in
``csrc/flash_attention_wgmma.cu``): the 128 producer threads' walk over a
tile's rows in units of the copy size (4 values at odd hd, zeros past hd),
into the 128-byte swizzled layout, over stale shared memory. It must leave the very bytes a TMA box would: each value
where the swizzle puts it, zeros in rows past the tensor and in columns
from hd up to the bucket width.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref
from torch_threads import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("hd", [64, 168, 100, 37])
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
    (torch.bfloat16, 100, "wgmma"),
    (torch.bfloat16, 4, "wgmma"),
    (torch.bfloat16, 37, "wgmma"),
    (torch.bfloat16, 250, "wgmma"),
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
    with pytest.raises(ValueError, match="CUDA"):
        ops._wgmma_tile_check(q[:, :100].contiguous(), q, q)
    wide = torch.zeros((64, 264), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1..256"):
        ops._wgmma_tile_check(wide, wide, wide)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("hd,loader,copy", [
    (64, "tma", 16), (168, "tma", 16), (8, "tma", 16), (256, "tma", 16),
    (100, "threads", 8), (4, "threads", 8), (52, "threads", 8),
    (50, "threads", 4), (250, "threads", 4), (2, "threads", 4),
    (37, "threads", 2), (97, "threads", 2), (1, "threads", 2),
    (255, "threads", 2),
])
def test_loader_and_copy_size_by_width(hd, loader, copy):
    assert ops._loader(hd) == loader
    assert ops._copy_bytes(hd) == copy


ROW_BYTES, PRODUCERS = 128, 128


def swizzled(rows, r, c):
    """Byte offset of element (r, c) in a tile of ``rows`` rows, as a TMA
    box of 64 columns with 128-byte swizzle places it (``swizzled``)."""
    return ((c >> 6) * rows * ROW_BYTES + r * ROW_BYTES
            + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1))


def thread_loader_tile(src, rows, present, hd, hdp):
    """The shared bytes of a tile of ``rows`` rows after the kernel's
    ``zero_pad`` and the 128 producer threads' ``load_tile`` (``make_walk``:
    thread i copies unit i % n_u of every P-th row from i // n_u, its
    address the unit's column bytes with the row's swizzle): ``src`` is
    the tile's rows in memory (uint16), ``present`` of them exist."""
    tile = np.full(rows * hdp * 2, 0xAB, np.uint8)  # stale bytes
    j0 = hd // 8
    per_row = hdp // 8 - j0
    for i in range(rows * per_row):
        r, j = i // per_row, j0 + i % per_row
        a = swizzled(rows, r, 8 * j)
        tile[a:a + 16] = 0
    copy = ops._copy_bytes(hd)
    unit = copy // 2 if copy > 2 else 4  # odd hd: 4 values, zeros past hd
    n_u = -(-hd // unit)
    rows_at_once = PRODUCERS // n_u
    for tid in range(PRODUCERS):
        c, r0 = (tid % n_u) * unit, tid // n_u
        if r0 >= rows_at_once:
            continue
        col = (c >> 6) * rows * ROW_BYTES
        piece = (c << 1) & 127
        for r in range(r0, rows, rows_at_once):
            vals = np.zeros(unit, np.uint16)
            if r < present:
                k = min(unit, hd - c)
                vals[:k] = src[r, c:c + k]
            a = col + r * ROW_BYTES + (piece ^ ((r & 7) << 4))
            tile[a:a + 2 * unit] = vals.view(np.uint8)
    return tile


def tma_tile(src, rows, present, hd, hdp):
    """The bytes a TMA box leaves: each present value where the swizzle
    puts it, zeros elsewhere."""
    tile = np.zeros(rows * hdp * 2, np.uint8)
    for r in range(min(present, rows)):
        for c in range(hd):
            a = swizzled(rows, r, c)
            tile[a:a + 2] = src[r, c:c + 1].view(np.uint8)
    return tile


@pytest.mark.parametrize("hd", [100, 4, 50, 250, 37, 97, 1, 255])
@pytest.mark.parametrize("rows,present", [(64, 64), (64, 23), (128, 77)])
def test_thread_loader_places_values_where_tma_does(hd, rows, present):
    hdp = next(w for w in ops.WGMMA_WIDTHS if w >= hd)
    rng = np.random.default_rng(hd * 1000 + present)
    src = rng.integers(1, 2**16, size=(rows, hd)).astype(np.uint16)
    np.testing.assert_array_equal(
        thread_loader_tile(src, rows, present, hd, hdp),
        tma_tile(src, rows, present, hd, hdp))
