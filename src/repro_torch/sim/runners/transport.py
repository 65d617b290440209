"""Dispatcher <-> worker transports of the port's fleet, copied from
``repro.sim.runners.transport``.

A transport owns the channel to exactly one worker. The dispatcher
(``repro_torch.sim.runners.fleet``) drives it through five methods::

    start(init_msg)   spawn/attach the worker, deliver the init context
    send(msg)         deliver one message (job frames, the stop frame)
    poll()            -> ("frame", msg) | ("eof",) | None   (non-blocking)
    kill()            tear the worker down *now* (deadline reaping)
    alive             False once the channel is known dead

Messages are plain dicts moved as *frames*: an 8-byte big-endian length
prefix followed by a pickle payload (numpy arrays ride along
efficiently), byte for byte the JAX package's frames. ``("eof",)``
reports a dead channel — a crashed, killed, or cleanly exited worker —
exactly once; with one job in flight per worker, the dispatcher
attributes it to precisely that job.

``SubprocessTransport`` is the local fleet: one ``python -m
repro_torch.sim.runners.worker`` per transport, started with
``subprocess.Popen`` (never a fork of a process that may hold CUDA), frames
over its stdin/stdout pipes, a daemon reader thread feeding the poll
queue. ``LocalTransport`` executes the same worker logic inline in the
dispatcher process (no pickling, no process) — the determinism-test and
debugging path. ``resolve_transport`` accepts any zero-argument factory,
the seam a remote-host transport plugs into.
"""

from __future__ import annotations

import os
import pickle
import queue
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, BinaryIO, Callable, Dict, Optional, Tuple

_LEN = struct.Struct(">Q")


class TransportError(RuntimeError):
    """The channel to a worker failed (send on a dead pipe, bad frame)."""


def send_frame(stream: BinaryIO, msg: Any) -> None:
    """Write one length-prefixed pickle frame and flush."""
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_LEN.pack(len(payload)) + payload)
    stream.flush()


def recv_frame(stream: BinaryIO) -> Any:
    """Read one frame; raises ``EOFError`` on a closed stream."""
    header = _read_exact(stream, _LEN.size)
    (n,) = _LEN.unpack(header)
    return pickle.loads(_read_exact(stream, n))


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise EOFError("stream closed mid-frame"
                           if buf else "stream closed")
        buf += chunk
    return buf


class Transport:
    """Interface every fleet transport implements (see module docstring)."""

    def start(self, init_msg: Dict[str, Any]) -> None:
        raise NotImplementedError

    def send(self, msg: Dict[str, Any]) -> None:
        raise NotImplementedError

    def poll(self) -> Optional[Tuple]:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    @property
    def alive(self) -> bool:
        raise NotImplementedError


class SubprocessTransport(Transport):
    """One spawned local worker process, frames over its stdio pipes.

    The child runs ``python -m repro_torch.sim.runners.worker`` with
    ``PYTHONPATH`` extended to the ``src`` directory this ``repro_torch``
    package was imported from, and otherwise the parent's environment:
    ``CUDA_VISIBLE_DEVICES`` as the parent has it, so a worker sent
    ``device="cuda"`` opens its own context on the parent's cards.
    stderr is inherited, so worker logs land in the parent's; stdout is
    the frame channel (the worker re-points stray prints at stderr). A
    daemon thread drains stdout into the poll queue so ``poll`` never
    blocks; worker death surfaces as one ``("eof",)`` event.
    """

    def __init__(self, python: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None):
        self._python = python or sys.executable
        self._env_extra = dict(env or {})
        self._proc: Optional[subprocess.Popen] = None
        self._events: "queue.Queue[Tuple]" = queue.Queue()
        self._alive = False
        self._eof_seen = False

    def start(self, init_msg: Dict[str, Any]) -> None:
        import repro_torch

        src_root = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        prior = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (src_root if not prior
                             else src_root + os.pathsep + prior)
        env.update(self._env_extra)
        self._proc = subprocess.Popen(
            [self._python, "-m", "repro_torch.sim.runners.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self._alive = True
        threading.Thread(target=self._read_loop, daemon=True).start()
        self.send(init_msg)

    def _read_loop(self) -> None:
        stream = self._proc.stdout
        try:
            while True:
                self._events.put(("frame", recv_frame(stream)))
        except (EOFError, OSError, pickle.UnpicklingError):
            self._events.put(("eof",))

    def send(self, msg: Dict[str, Any]) -> None:
        if not self._alive or self._proc is None:
            raise TransportError("transport is not alive")
        try:
            send_frame(self._proc.stdin, msg)
        except (BrokenPipeError, OSError) as e:
            self._alive = False
            raise TransportError(f"send to worker failed: {e}") from e

    def poll(self) -> Optional[Tuple]:
        try:
            event = self._events.get_nowait()
        except queue.Empty:
            return None
        if event[0] == "eof":
            self._alive = False
            if self._eof_seen:  # deliver a dead channel exactly once
                return None
            self._eof_seen = True
        return event

    def kill(self) -> None:
        self._alive = False
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=2.0)
        except Exception:
            try:
                proc.kill()
                proc.wait(timeout=2.0)
            except Exception:
                pass

    @property
    def alive(self) -> bool:
        return self._alive


class LocalTransport(Transport):
    """Worker logic executed inline in the dispatcher process.

    ``send`` runs the job synchronously and queues the result frame for
    the next ``poll`` — same protocol, no process, no pickling — so
    fleet tests assert bitwise determinism without subprocess variance.
    Fault directives are acted out with in-process semantics: ``crash``
    marks the channel dead and queues the ``("eof",)`` the dispatcher
    expects (without killing the dispatcher!); ``hang`` sleeps its full
    duration before the job runs — inline work cannot be preempted, so
    the deadline is enforced by the dispatcher's next poll pass, exactly
    like ``repro_torch.sim.jobs.run_local_jobs``'s simulated deadlines.
    """

    def __init__(self):
        self._runner: Optional[Callable] = None
        self._events: deque = deque()
        self._alive = False

    def start(self, init_msg: Dict[str, Any]) -> None:
        from repro_torch.sim.runners import worker

        self._runner = worker.build_runner(init_msg["ctx"])
        self._alive = True
        self._events.append(("frame", {"op": "ready", "startup_s": 0.0}))

    def send(self, msg: Dict[str, Any]) -> None:
        if not self._alive:
            raise TransportError("transport is not alive")
        if msg.get("op") == "stop":
            self._alive = False
            return
        from repro_torch.sim.runners import worker

        directive = msg.get("directive")
        if directive is not None and directive["kind"] == "crash":
            self._alive = False
            self._events.append(("eof",))
            return
        if directive is not None and directive["kind"] == "hang":
            time.sleep(float(directive["seconds"]))
        # snapshot=False: inline work already lands in the dispatcher's
        # own registry — a snapshot/merge round trip would steal its
        # counters when the frame is dropped (deadline overrun).
        self._events.append(
            ("frame", worker.attempt(self._runner, msg, snapshot=False)))

    def poll(self) -> Optional[Tuple]:
        if not self._events:
            return None
        return self._events.popleft()

    def kill(self) -> None:
        self._alive = False
        self._events.clear()

    @property
    def alive(self) -> bool:
        return self._alive


def resolve_transport(transport: Any) -> Callable[[], Transport]:
    """Coerce a ``transport=`` argument to a zero-arg transport factory.

    ``"subprocess"`` (the default fleet) and ``"local"`` name the
    built-ins; any callable passes through — the seam a remote-host
    transport plugs into.
    """
    if transport in (None, "subprocess"):
        return SubprocessTransport
    if transport == "local":
        return LocalTransport
    if callable(transport):
        return transport
    raise ValueError(f"unknown transport {transport!r} "
                     "(expected 'subprocess', 'local', or a factory)")


__all__ = [
    "LocalTransport", "SubprocessTransport", "Transport", "TransportError",
    "recv_frame", "resolve_transport", "send_frame",
]
