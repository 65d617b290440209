"""Entry point of the attention forward: :func:`flash_attention`
(``repro.kernels.flash_attention.ops:21``).

``impl`` follows ``repro_torch.kernels.registry`` and takes the place of
``repro``'s ``use_pallas``/``interpret``: ``"torch"`` runs the plain
version (``ref.py``) on any device, ``"cuda"`` a hand-written kernel and
raises off a CUDA device, ``"auto"`` is ``"cuda"`` for CUDA tensors and
``"torch"`` for CPU ones. The function runs where its tensors live. No
padding: the kernels mask the ragged edges of T and S themselves.

Two kernels compute the same function, and :func:`_route` picks one from
the dtype alone, never from a failure:

- ``"tf32x3"`` (``csrc/flash_attention_tf32x3.cu``): float32 at any hd in
  1..256 — tensor cores through ``mma.sync``, each product in three TF32
  terms of split operands, fed by a ``cp.async`` ring;
- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bfloat16 at any hd in
  1..256 — tensor cores through ``wgmma``, fed by one of two loaders
  (:func:`_loader`, from hd alone): TMA where a row is a multiple of 16
  bytes (hd % 8 == 0), else the producer warpgroup's threads through
  ``cp.async`` (8 or 4 bytes a copy) or, at odd hd, through registers.

The wrapper checks device, dtype, shape, contiguity and the alignment the
loader's copies need (:func:`_copy_bytes`), launches on the current stream
without synchronising, raises on a CUDA error and counts its launches per
kernel and loader (:func:`launch_counts`); it has no fallback. Under
autograd the kernel route's backward is the plain version's, recomputed
from the saved q, k and v (``kernels.autograd``; no backward kernel: the
Pallas kernel has none either).
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, sharded
from repro_torch.kernels.autograd import kernel_with_plain_backward
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.registry import resolve_tick_impl

KERNELS = ("flash_attention",)

#: Widest head either kernel takes.
MAX_HEAD_DIM = 256

#: The wgmma kernel's head-width buckets (hd runs padded to the narrowest
#: one at least hd) and its keys per K/V tile.
WGMMA_WIDTHS = (64, 128, 192, 256)
WGMMA_KEYS = 64

#: Keys and widest row of the tf32x3 kernel's bring-up probe.
TF32X3_PROBE_KEYS = 16
TF32X3_PROBE_MAX_WIDTH = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_FORWARD = [_P] * 4 + [_I] * 8 + [ctypes.c_float]

#: argtypes of the C entry points (see ``_build.KernelLib``).
_TF32X3_SIGNATURES = {
    "fa_tf32x3_error_string": ([_I], ctypes.c_char_p),
    "fa_tf32x3_forward": (_FORWARD + [_P], _I),
    "fa_tf32x3_tile_check": ([_P] * 5 + [_I, _P], _I),
    "fa_tf32x3_tiles": ([_I], _I),
}
_WGMMA_SIGNATURES = {
    "fa_wgmma_error_string": ([_I], ctypes.c_char_p),
    "fa_wgmma_forward": (_FORWARD + [_P], _I),
    "fa_wgmma_tile_check": ([_P] * 5 + [_I, _P], _I),
}

_WGMMA = _build.KernelLib("flash_attention_wgmma", _WGMMA_SIGNATURES,
                          "fa_wgmma_error_string",
                          ("flash_attention_wgmma",
                           "flash_attention_wgmma_threads", "tile_check"))
_TF32X3 = _build.KernelLib("flash_attention_tf32x3", _TF32X3_SIGNATURES,
                           "fa_tf32x3_error_string",
                           ("flash_attention_tf32x3", "tile_check"))
#: route -> (library, launch-count key, C entry point)
_KERNELS = {
    "tf32x3": (_TF32X3, "flash_attention_tf32x3", "fa_tf32x3_forward"),
    "wgmma": (_WGMMA, "flash_attention_wgmma", "fa_wgmma_forward"),
}


def launch_counts():
    """Kernel launches since the last reset: ``flash_attention`` (both
    kernels), ``flash_attention_tf32x3``, ``flash_attention_wgmma`` (either
    loader) and ``flash_attention_wgmma_threads`` (the thread loader's
    share of it). A call that went to the plain version does not count."""
    counts = {key: lib.launch_counts()[key]
              for lib, key, _ in _KERNELS.values()}
    return {"flash_attention": sum(counts.values()), **counts,
            "flash_attention_wgmma_threads":
                _WGMMA.launch_counts()["flash_attention_wgmma_threads"]}


def reset_launch_counts() -> None:
    for lib, _, _ in _KERNELS.values():
        lib.reset_launch_counts()


def _route(dtype, hd: int) -> str:
    """The kernel that takes inputs of ``dtype`` and head width ``hd``:
    ``"tf32x3"`` for float32, else ``"wgmma"`` (the wrapper refuses other
    dtypes and hd outside 1..256)."""
    return "tf32x3" if dtype == torch.float32 else "wgmma"


def _loader(hd: int) -> str:
    """How the wgmma kernel loads its tiles at head width ``hd``: ``"tma"``
    where a row is a multiple of 16 bytes, else ``"threads"``."""
    return "tma" if hd % 8 == 0 else "threads"


def _copy_bytes(hd: int) -> int:
    """Bytes each copy of the wgmma kernel's loader moves at head width
    ``hd``, and the alignment q, k and v must start on: 16 through TMA
    (hd % 8 == 0), 8 or 4 through the thread loader's ``cp.async`` (hd %
    4 == 0, even hd), 2 at odd hd (loads through registers)."""
    return 16 if hd % 8 == 0 else 8 if hd % 4 == 0 else 4 if hd % 2 == 0 else 2


def _attention_kernel(q, k, v, causal: bool, window: int):
    """Launch the route's kernel on CUDA tensors (contract of
    ``ref.attention``)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the attention kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k and v must be [B, heads, length, head_dim]")
    B, nh, T, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: expected torch.float32 or torch.bfloat16, got "
                         f"{q.dtype}")
    chk = _build.check_tensor
    chk("q", q, q.dtype, (B, nh, T, hd), dev)
    chk("k", k, q.dtype, (B, nkv, S, hd), dev)
    chk("v", v, q.dtype, (B, nkv, S, hd), dev)
    if nkv < 1 or nh % nkv:
        raise ValueError(f"{nh} query heads are not a multiple of {nkv} kv "
                         f"heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {hd} outside 1..{MAX_HEAD_DIM}: float32 runs the "
            f"tf32x3 kernel, bfloat16 the wgmma kernel")
    if S < 1:
        raise ValueError("no keys: S must be at least 1")
    out = torch.empty_like(q)
    if T == 0 or B == 0 or nh == 0:
        return out
    args = (*(t.data_ptr() for t in (q, k, v, out)), B, nh, nkv, T, S, hd,
            int(bool(causal)), int(window), hd ** -0.5)
    route = _route(q.dtype, hd)
    lib, key, fn = _KERNELS[route]
    if route == "wgmma":
        _check_alignment(hd, q, k, v)
        if _loader(hd) == "threads":
            key = (key, "flash_attention_wgmma_threads")
    lib.launch(key, fn, dev, *args)
    return out


def _check_alignment(hd: int, q, k, v) -> None:
    """Raise ``ValueError`` unless q, k and v start on a multiple of the
    wgmma kernel's copy size at ``hd``."""
    align = _copy_bytes(hd)
    how = ("reads through TMA" if _loader(hd) == "tma" else
           f"copies {align} bytes at a time at head_dim {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: the wgmma kernel {how} and needs a "
                             f"{align}-byte aligned start")


def _wgmma_tile_check(q, k, v):
    """Bring-up probe of the wgmma kernel's pieces (its loader at this
    width, TMA maps or the thread loader's cp.async walk, the swizzle and
    the zeroed pad columns, descriptors, fragment layouts, the split of P
    into two bf16 halves) on one warpgroup, without scale, masks or
    softmax: ``q [64, hd]``, ``k`` and ``v [WGMMA_KEYS, hd]`` contiguous
    bfloat16 on a CUDA device, hd in 1..256, aligned as
    :func:`flash_attention` needs. Returns float32 ``S = q k^T [64,
    WGMMA_KEYS]`` and ``O = S v [64, HDP]`` with HDP the bucket of hd
    (:data:`WGMMA_WIDTHS`; its columns from hd on are 0), exact for small
    integer inputs."""
    hd, bk = q.shape[-1], WGMMA_KEYS
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"width {hd}: the wgmma probe takes "
                         f"1..{MAX_HEAD_DIM}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the wgmma probe needs CUDA tensors, got {dev}")
    _build.check_tensor("q", q, torch.bfloat16, (64, hd), dev)
    _build.check_tensor("k", k, torch.bfloat16, (bk, hd), dev)
    _build.check_tensor("v", v, torch.bfloat16, (bk, hd), dev)
    _check_alignment(hd, q, k, v)
    hdp = next(w for w in WGMMA_WIDTHS if w >= hd)
    s = torch.empty((64, bk), dtype=torch.float32, device=dev)
    o = torch.empty((64, hdp), dtype=torch.float32, device=dev)
    _WGMMA.launch("tile_check", "fa_wgmma_tile_check", dev,
                  *(t.data_ptr() for t in (q, k, v, s, o)), hd)
    return s, o


def _tf32x3_tile_check(q, k, v):
    """Bring-up probe of the tf32x3 kernel's pieces (``cp.async`` loads,
    the m16n8k8 fragment layouts, the split into TF32 halves, the three
    products, P carried from the score accumulator into the second
    product) on one warp, without scale, masks or softmax: ``q`` (16
    rows), ``k`` and ``v`` (:data:`TF32X3_PROBE_KEYS` = 16 rows), each
    ``[16, w]`` contiguous float32 on a CUDA device, 16-byte aligned, w a
    multiple of 8 up to :data:`TF32X3_PROBE_MAX_WIDTH`. Returns float32
    ``S = q k^T [16, 16]`` and ``O = S v [16, w]``, exact for integer
    inputs whose sums are exact in float32 and where no two low halves
    meet in a product."""
    w, rows = q.shape[-1], TF32X3_PROBE_KEYS
    if w % 8 or not 8 <= w <= TF32X3_PROBE_MAX_WIDTH:
        raise ValueError(f"width {w}: the tf32x3 probe takes a multiple of "
                         f"8 in 8..{TF32X3_PROBE_MAX_WIDTH}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the tf32x3 probe needs CUDA tensors, got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(name, t, torch.float32, (rows, w), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tf32x3 probe copies 16 bytes at "
                             f"a time and needs a 16-byte aligned start")
    s = torch.empty((rows, rows), dtype=torch.float32, device=dev)
    o = torch.empty((rows, w), dtype=torch.float32, device=dev)
    _TF32X3.launch("tile_check", "fa_tf32x3_tile_check", dev,
                   *(t.data_ptr() for t in (q, k, v, s, o)), w)
    return s, o


def _kernel_route(q, k, v, causal: bool, window: int, launch=None):
    """``launch`` (default: the kernel) on q, k and v; under autograd its
    output's backward is the plain version's, recomputed
    (``kernels.autograd``)."""
    launch = launch or _attention_kernel
    return kernel_with_plain_backward(
        lambda q, k, v: launch(q, k, v, causal, window),
        lambda q, k, v: ref.attention(q, k, v, causal=causal, window=window),
        q, k, v)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """``q [B, nh, T, hd]``, ``k/v [B, nkv, S, hd]`` (float32 or bfloat16)
    -> ``[B, nh, T, hd]`` in ``q.dtype``; see ``ref.attention`` for the
    masks and the head mapping. Differentiable on both routes: the kernel
    route's backward is the plain version's. DTensor inputs run each
    rank's shards (``kernels.sharded``); ``impl="shape"`` is the dry
    run's shape-only entry (fake tensors only)."""
    if impl == "shape":
        def run(q, k, v):
            return sharded.attention_shape(q, k, v, causal=causal,
                                           window=window)
    elif resolve_tick_impl(impl, q.device).use_kernel:
        def run(q, k, v):
            return _kernel_route(q, k, v, causal, int(window))
    else:
        def run(q, k, v):
            return ref.attention(q, k, v, causal=causal, window=window)
    if isinstance(q, DTensor):
        return sharded.sharded_attention(run, q, k, v)
    return run(q, k, v)
