"""Entry points of the carousel tick: :func:`carousel_tick` and the tick
engine :func:`simulate_ticks` (``repro.kernels.carousel_update.ops:38``,
``:50``), which runs on :class:`CarouselEngine`.

``tick_impl`` follows ``repro_torch.kernels.registry``: ``"torch"`` runs
the plain version (``ref.py``) on any device, ``"cuda"`` the hand-written
kernels (``csrc/carousel_update.cu``) and raises off a CUDA device, and
``"auto"`` is ``"cuda"`` for CUDA tensors and ``"torch"`` for CPU ones. A
wrapper checks device, dtype, shape and contiguity, launches on the
current stream without synchronising, raises on a CUDA error and counts
its launches (:func:`launch_counts`: ``carousel_tick``, and the engine's
``engine_count`` and ``engine_tick``); it has no fallback.
"""

from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.carousel_update import ref
from repro_torch.kernels.registry import resolve_device, resolve_tick_impl

KERNELS = ("carousel_tick", "engine_count", "engine_tick")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes of the C entry points (see ``_build.KernelLib``).
_SIGNATURES = {
    "cu_max_links": ([], _I),
    "cu_error_string": ([_I], ctypes.c_char_p),
    "cu_carousel_tick": ([_P] * 6 + [ctypes.c_float, _LL, _I] + [_P] * 5,
                         _I),
    "cu_engine_max_links": ([], _I),
    "cu_engine_blocks": ([_LL], _I),
    "cu_engine_count": ([_P, _P, _LL, _I, _P, _P], _I),
    "cu_engine_tick": ([_P] * 6 + [ctypes.c_float, _LL, _I, _LL] + [_P] * 5,
                       _I),
}

#: Eager ticks an engine runs before it captures its CUDA graph: real
#: ticks of the run, on a side stream as capture asks (the first launch of
#: the tick kernel in a process loads it).
ENGINE_WARMUP_TICKS = 1
#: Engine ticks captured in one CUDA graph and replayed as a whole.
ENGINE_CHUNK = 32

_LIB = _build.KernelLib("carousel_update", _SIGNATURES, "cu_error_string",
                        KERNELS)
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _check_transfers(link_id, active, done, total, bw, mode):
    """Check the transfer set of a tick (``ref.carousel_tick``'s contract)
    and return its ``(device, N, M)``."""
    dev = link_id.device
    N, M = link_id.shape[0], bw.shape[0]
    chk = _build.check_tensor
    chk("link_id", link_id, torch.int32, (N,), dev)
    chk("active", active, torch.bool, (N,), dev)
    chk("done", done, torch.float32, (N,), dev)
    chk("total", total, torch.float32, (N,), dev)
    chk("bw", bw, torch.float32, (M,), dev)
    chk("mode", mode, torch.int32, (M,), dev)
    return dev, N, M


def _tick_kernel(link_id, active, done, total, bw, mode, dt):
    """Launch ``csrc/carousel_update.cu`` on CUDA tensors (contract of
    ``ref.carousel_tick``; ``dt`` a number of seconds). ``M`` may not exceed
    the links one block's shared memory holds (``cu_max_links()``,
    58,112)."""
    if link_id.device.type != "cuda":
        raise ValueError(f"the carousel kernel needs CUDA tensors, got "
                         f"{link_id.device}")
    dev, N, M = _check_transfers(link_id, active, done, total, bw, mode)
    lib = _LIB.get()
    if not 1 <= M <= lib.cu_max_links():
        raise ValueError(f"carousel kernel: {M} links, expected 1 to "
                         f"{lib.cu_max_links()} (one block's shared memory)")
    counts_i = torch.empty((M,), dtype=torch.int32, device=dev)
    new_done = torch.empty((N,), dtype=torch.float32, device=dev)
    completed = torch.empty((N,), dtype=torch.bool, device=dev)
    counts = torch.empty((M,), dtype=torch.float32, device=dev)
    _LIB.launch("carousel_tick", "cu_carousel_tick", dev,
                *(t.data_ptr() for t in (link_id, active, done, total, bw,
                                         mode)),
                float(dt), N, M,
                *(t.data_ptr() for t in (counts_i, new_done, completed,
                                         counts)))
    return new_done, completed, counts


def carousel_tick(link_id, active, done, total, bw, mode, dt: float,
                  tick_impl: str = "auto"):
    """One transfer-manager tick of ``dt`` seconds where the tensors live;
    see ``ref.carousel_tick`` for the contract. Returns ``(new_done,
    completed, counts)``."""
    impl = resolve_tick_impl(tick_impl, link_id.device)
    fn = _tick_kernel if impl.use_kernel else ref.carousel_tick
    return fn(link_id, active, done, total, bw, mode, dt)


def engine_schedule(t: int, n: int, chunk: int):
    """How an engine at tick ``t`` runs its next ``n`` ticks: ``(warm,
    replays, rest)`` — eager warm-up ticks (those of the first
    :data:`ENGINE_WARMUP_TICKS` left), then ``replays`` replays of a
    ``chunk``-tick graph, then ``rest`` eager ticks."""
    warm = min(n, max(0, ENGINE_WARMUP_TICKS - t))
    replays, rest = divmod(n - warm, chunk)
    return warm, replays, rest


def engine_count(link_id, active, out):
    """Count the active transfers per link into ``out`` (int32 ``[M]``) and
    return it: the tick engine's count before its first tick. On CUDA
    tensors a memset and ``cu_count_kernel`` (``cu_engine_count``); on CPU
    tensors the plain ``torch.bincount``."""
    dev = link_id.device
    N, M = link_id.shape[0], out.shape[0]
    chk = _build.check_tensor
    chk("link_id", link_id, torch.int32, (N,), dev)
    chk("active", active, torch.bool, (N,), dev)
    chk("out", out, torch.int32, (M,), dev)
    if dev.type != "cuda":
        return out.copy_(torch.bincount(link_id[active].long(), minlength=M))
    lib = _LIB.get()
    if not 1 <= M <= lib.cu_max_links():
        raise ValueError(f"carousel count: {M} links, expected 1 to "
                         f"{lib.cu_max_links()} (one block's shared memory)")
    _LIB.launch("engine_count", "cu_engine_count", dev, link_id.data_ptr(),
                active.data_ptr(), N, M, out.data_ptr())
    return out


def _aligned(t):
    """``t``, or a copy where its data is not 16-byte aligned (the engine
    kernel's vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class CarouselEngine:
    """The tick engine's state on one device, advanced tick by tick
    (:meth:`advance`) without a host sync.

    The engine works on its own copies of ``active`` and ``done`` and
    updates them in place; the caller's tensors are never written. Tick
    ``t`` adds its completions into ``completions[t]`` (int32, one entry
    per tick of ``n_ticks``). The active transfers per link are counted
    once, before the first tick, and then carried from tick to tick: a
    tick's count is the one before less its completions on each link
    (``ref.carry_counts``), kept in rotating buffers (``ref.engine_tick``).

    On CUDA tensors a tick is one launch of the engine kernel
    (``csrc/carousel_update.cu``), which takes its tick index from device
    counters, one per block. The first :data:`ENGINE_WARMUP_TICKS` run
    eagerly on a side stream, then :data:`ENGINE_CHUNK` ticks (read when
    the engine is built) are captured once as a CUDA graph (capture runs
    nothing) and replayed whole, and a remainder shorter than a chunk runs
    eagerly through the same kernel. A replay
    runs no wrapper, so each adds the chunk's launches to
    :func:`launch_counts`. A failed capture or replay raises; nothing falls
    back. ``capture_s`` is the capture's host time (0 until it happens).
    On CPU tensors each tick runs the plain ``ref.engine_tick``.
    """

    def __init__(self, link_id, active, done, total, bw, mode, dt: float,
                 n_ticks: int):
        dev, N, M = _check_transfers(link_id, active, done, total, bw, mode)
        if n_ticks < 0:
            raise ValueError(f"{n_ticks} ticks")
        self.device, self.dt, self.n_ticks = dev, float(dt), n_ticks
        self.use_kernel = dev.type == "cuda"
        self.chunk = ENGINE_CHUNK
        self.link_id, self.total = _aligned(link_id), _aligned(total)
        self.bw, self.mode = bw, mode
        self.active, self.done = active.clone(), done.clone()
        i32 = dict(dtype=torch.int32, device=dev)
        self.counts = torch.zeros((2, M), **i32)
        self.hist = torch.zeros((3, M), **i32)
        self.completions = torch.zeros((n_ticks,), **i32)
        self.t = 0
        self.capture_s = 0.0
        self._graph = None
        self._per_chunk: dict = {}
        if self.use_kernel:
            lib = _LIB.get()
            if not 1 <= M <= lib.cu_engine_max_links():
                raise ValueError(f"carousel engine: {M} links, expected 1 "
                                 f"to {lib.cu_engine_max_links()} (one "
                                 f"block's shared memory)")
        engine_count(self.link_id, self.active, self.counts[1])
        if not self.use_kernel:
            return
        self._ticks = torch.zeros((lib.cu_engine_blocks(N),),
                                  dtype=torch.int64, device=dev)
        self._tick_args = (
            *(t.data_ptr() for t in (self.link_id, self.active, self.done,
                                     self.total, bw, mode)),
            self.dt, N, M, n_ticks,
            *(t.data_ptr() for t in (self.counts, self.hist,
                                     self.completions, self._ticks)))

    def advance(self, n: int) -> None:
        """Run the next ``n`` ticks (no host sync)."""
        if not 0 <= n <= self.n_ticks - self.t:
            raise ValueError(f"advance({n}) at tick {self.t} of "
                             f"{self.n_ticks}")
        if not self.use_kernel:
            for t in range(self.t, self.t + n):
                ref.engine_tick(self.link_id, self.active, self.done,
                                self.total, self.bw, self.mode, self.dt, t,
                                self.counts, self.hist, self.completions)
            self.t += n
            return
        warm, replays, rest = engine_schedule(self.t, n, self.chunk)
        if warm:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(warm):
                    self._tick()
            cur.wait_stream(side)
        if replays:
            if self._graph is None:
                self._capture()
            for _ in range(replays):
                self._graph.replay()
            _LIB.add_launch_counts(self._per_chunk, replays)
        for _ in range(rest):
            self._tick()
        self.t += n

    def carried_counts(self):
        """The active transfers per link that the next tick reads, as the
        engine carried them (int32 ``[M]``)."""
        return self.counts[(self.t + 1) % 2] - self.hist[(self.t + 2) % 3]

    def _tick(self) -> None:
        _LIB.launch("engine_tick", "cu_engine_tick", self.device,
                    *self._tick_args)

    def _capture(self) -> None:
        # capture_begin/end on a side stream: what ``torch.cuda.graph``
        # does without its synchronize, gc.collect and empty_cache, which
        # each call of the engine would pay (the ticks allocate nothing)
        before = launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                for _ in range(self.chunk):
                    self._tick()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        self._per_chunk = {k: v - before[k]
                           for k, v in launch_counts().items()}
        _LIB.add_launch_counts(self._per_chunk, -1)  # capture ran nothing
        self._graph = graph


def simulate_ticks(link_id, active, done, total, bw, mode, dt: float,
                   n_ticks: int, *, tick_impl: str = "auto", device=None):
    """Run ``n_ticks`` of the tick engine: each tick advances the active
    transfers, and those that complete leave the active set.

    Runs on ``device`` (default ``cuda``; the CPU only when asked for), the
    inputs moved there and never written. Returns ``(active [N] bool, done
    [N] float32, completions [n_ticks] int32)``, as ``repro``'s
    ``simulate_ticks``. ``tick_impl="cuda"`` runs :class:`CarouselEngine`:
    one kernel launch a tick on carried link counts, replayed from a CUDA
    graph, with no host work per tick. ``"torch"`` runs the plain loop over
    ``ref.carousel_tick``, the oracle (``repro`` steps its jnp reference
    in a ``scan``); both compute the same function, bitwise.
    """
    dev = resolve_device(device)
    impl = resolve_tick_impl(tick_impl, dev)
    link_id, active, done, total, bw, mode = (
        t.to(dev) for t in (link_id, active, done, total, bw, mode))
    if impl.use_kernel:
        engine = CarouselEngine(link_id, active, done, total, bw, mode, dt,
                                n_ticks)
        engine.advance(n_ticks)
        return engine.active, engine.done, engine.completions
    per_tick = []
    for _ in range(n_ticks):
        done, completed, _ = ref.carousel_tick(link_id, active, done, total,
                                               bw, mode, dt)
        active = active & ~completed
        per_tick.append(completed.sum(dtype=torch.int32))
    completions = (torch.stack(per_tick) if per_tick
                   else torch.zeros(0, dtype=torch.int32, device=dev))
    return active, done, completions
