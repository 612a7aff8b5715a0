"""Transport-agnostic RPC boundary for fleet replicas (counterpart of
``deepspeed_tpu/serving/frontdoor/transport.py``, on the same wire: a
frame either package writes reads in the other).

The router, supervisor and autoscaler route against a duck-typed
replica surface; this module is that surface's wire boundary:

* **one codec** — :func:`dispatch` maps op dicts onto the replica
  surface and :func:`encode_error` / :func:`raise_wire` round-trip the
  serving exception taxonomy (``ServingQueueFull`` / ``Overloaded`` /
  ``Draining`` reconstruct as their EXACT class with ``retry_after``
  intact — previously any process boundary collapsed them and the
  client lost the backoff hint);
* **two transports** — :class:`InProcTransport` (direct dispatch, no
  serialization fidelity loss for same-process fleets) and
  :class:`StreamTransport` (length-prefixed, crc-framed JSON over any
  byte stream: a socket, or a child process's stdio pipes via
  :class:`ProcessTransport`);
* **one replica** — :class:`TransportReplica` implements the full
  fleet surface over either transport, so ``FleetRouter``,
  ``ReplicaSupervisor`` and ``FleetAutoscaler`` work unchanged.

Framing (the socket codec): ``b"DSRP" + len:u32be + crc32:u32be +
payload`` where payload is UTF-8 JSON.  The frame reader treats ANY
defect — short header, bad magic, oversized length, short payload, crc
mismatch, non-JSON bytes — as :class:`TransportFrameError`; the
transport maps that (and EOF) to ``ReplicaDeadError`` and marks itself
dead, so a torn frame takes the breaker + supervisor path and never
hangs the router.  Fault site ``transport.frame`` perturbs the framer
(fail / latency / stall) for the chaos matrix.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.faults import InjectedFault
from deepspeed_tpu_torch.serving.fleet.replica import ReplicaDeadError
from deepspeed_tpu_torch.serving.frontdoor.tenants import TenantThrottled
from deepspeed_tpu_torch.serving.scheduler import (
    ServingDraining,
    ServingOverloaded,
    ServingQueueFull,
)
from deepspeed_tpu_torch.utils.logging import logger

# ---------------------------------------------------------------------------
# codec: exceptions
# ---------------------------------------------------------------------------

#: exception classes that reconstruct as THEMSELVES across the wire
#: (everything else degrades to RuntimeError with the original type
#: name in the message).  The serving triple carries ``retry_after`` —
#: the client's backoff hint — through ``__init__(msg, retry_after=)``.
WIRE_EXCEPTIONS: Dict[str, type] = {
    "ServingQueueFull": ServingQueueFull,
    "ServingOverloaded": ServingOverloaded,
    "ServingDraining": ServingDraining,
    "ReplicaDeadError": ReplicaDeadError,
    "TenantThrottled": TenantThrottled,
    "InjectedFault": InjectedFault,
    "ValueError": ValueError,
    "KeyError": KeyError,
}


def encode_error(exc: BaseException) -> Dict[str, Any]:
    """Serve-side half of the exception codec."""
    return {
        "err": str(exc),
        "type": type(exc).__name__,
        "retry_after": getattr(exc, "retry_after", None),
    }


def raise_wire(resp: Dict[str, Any]) -> None:
    """Client-side half: reconstruct the exact exception class when it
    is part of the wire taxonomy, preserving ``retry_after``."""
    name = resp.get("type", "RuntimeError")
    cls = WIRE_EXCEPTIONS.get(name)
    if cls is None:
        raise RuntimeError(f"{name}: {resp['err']}")
    if issubclass(cls, ServingQueueFull):
        raise cls(resp["err"], retry_after=resp.get("retry_after"))
    raise cls(resp["err"])


# ---------------------------------------------------------------------------
# codec: op dispatch (shared by the in-process transport and the
# stream-serve loop — the "one codec" contract)
# ---------------------------------------------------------------------------

def dispatch(rep, cmd: Dict[str, Any]) -> Dict[str, Any]:
    """Map one op dict onto the replica surface; returns a JSON-plain
    ``{"ok": ...}`` or ``{"err": ..., "type": ..., "retry_after": ...}``
    response.  ``rep`` is anything with the LocalReplica surface (the
    worker side wraps its engine in a LocalReplica so migration fault
    sites and dead-replica semantics come along for free)."""
    op = cmd.get("op")
    try:
        if op == "submit":
            rid = rep.submit(
                np.asarray(cmd["prompt"], np.int32),
                client_key=cmd.get("client_key"),
                **cmd.get("kw", {}),
            )
            return {"ok": int(rid)}
        if op == "step":
            return {"ok": bool(rep.step())}
        if op == "has_work":
            return {"ok": bool(rep.has_work())}
        if op == "pop":
            return {"ok": {
                str(rid): {
                    "tokens": [int(t) for t in r.tokens()],
                    "finish_reason": r.finish_reason,
                    "first_token_time": r.first_token_time,
                    "submit_time": r.submit_time,
                    "retry_after": r.retry_after,
                }
                for rid, r in rep.pop_results().items()
            }}
        if op == "cancel":
            return {"ok": bool(rep.cancel(int(cmd["id"])))}
        if op == "result":
            r = rep.result(int(cmd["id"]))
            if r is None:
                return {"ok": None}
            finished = r.finish_time is not None
            return {"ok": {
                "first_token": r.first_token_time is not None,
                "finished": finished,
                "finish_time": r.finish_time,
                "first_token_time": r.first_token_time,
                "submit_time": r.submit_time,
                "finish_reason": r.finish_reason,
                "retry_after": getattr(r, "retry_after", None),
                # the full token view only once retired: the router may
                # surface a deduped finished request's result directly
                "tokens": ([int(t) for t in r.tokens()]
                           if finished else None),
            }}
        if op == "partial":
            # streaming pull: tokens generated SO FAR for an in-flight
            # request (the HTTP front-door's chunk source)
            r = rep.result(int(cmd["id"]))
            return {"ok": None if r is None else {
                "generated": [int(t) for t in getattr(r, "generated", [])],
                "finished": r.finish_time is not None,
                "finish_reason": r.finish_reason,
            }}
        if op == "ck":
            rid = rep.client_request_id(str(cmd["key"]))
            return {"ok": None if rid is None else int(rid)}
        if op == "recover":
            return {"ok": [int(r) for r in rep.engine.recover()]}
        if op == "affinity":
            return {"ok": float(rep.kv_affinity(
                np.asarray(cmd["prompt"], np.int32),
                session_id=cmd.get("session_id"),
            ))}
        if op == "export":
            return {"ok": rep.export_sessions(cmd["dir"])}
        if op == "import":
            return {"ok": rep.import_sessions(cmd["dir"])}
        if op == "sweep":
            return {"ok": int(rep.sweep_sessions(
                float(cmd.get("now", time.monotonic()))))}
        if op == "kvstats":
            kv = getattr(rep, "kv_stats", None)
            if kv is not None:
                return {"ok": kv()}
            pool = getattr(getattr(rep, "engine", None), "pool", None)
            return {"ok": pool.stats()
                    if pool is not None and hasattr(pool, "sessions") else {}}
        if op == "health":
            est = rep.estimate_ttft(int(cmd.get("len", 8)))
            return {"ok": {
                "depth": int(rep.queue_depth()),
                "level": int(rep.degrade_level()),
                "draining": bool(rep.draining()),
                "est": est if est is None else float(est),
            }}
        if op == "stats":
            return {"ok": _json_safe(rep.stats())}
        if op == "exit":
            return {"ok": True}
        return {"err": f"unknown op {op!r}", "type": "ValueError",
                "retry_after": None}
    except Exception as e:  # noqa: BLE001 — becomes the wire error
        return encode_error(e)


def _json_safe(obj):
    """Best-effort scrub of numpy scalars out of a stats tree."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return [_json_safe(v) for v in obj.tolist()]
    return obj


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

MAGIC = b"DSRP"
_HEADER = struct.Struct(">4sII")  # magic, payload len, crc32
MAX_FRAME_BYTES = 64 * 1024 * 1024


class TransportFrameError(RuntimeError):
    """A frame failed to parse: short header, bad magic, oversized or
    short payload, crc mismatch, or non-JSON bytes.  The transport maps
    this to ``ReplicaDeadError`` — a torn frame means the peer (or the
    pipe between) can no longer be trusted."""


def write_frame(wfile, obj: Any) -> None:
    """Encode + frame one message.  Fault site ``transport.frame``."""
    faults.check("transport.frame")
    faults.check_latency("transport.frame")
    faults.check_stall("transport.frame")
    payload = json.dumps(obj).encode("utf-8")
    import zlib

    wfile.write(_HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)))
    wfile.write(payload)
    wfile.flush()


def read_frame(rfile) -> Any:
    """Read one framed message; ``EOFError`` on a clean EOF at a frame
    boundary, :class:`TransportFrameError` on any torn/garbage frame."""
    header = rfile.read(_HEADER.size)
    if not header:
        raise EOFError("transport: EOF")
    if len(header) < _HEADER.size:
        raise TransportFrameError(
            f"torn frame header ({len(header)}/{_HEADER.size} bytes)")
    magic, length, crc = _HEADER.unpack(header)
    if magic != MAGIC:
        raise TransportFrameError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME_BYTES:
        raise TransportFrameError(f"frame length {length} exceeds cap")
    payload = rfile.read(length)
    if len(payload) < length:
        raise TransportFrameError(
            f"torn frame payload ({len(payload)}/{length} bytes)")
    import zlib

    if zlib.crc32(payload) != crc:
        raise TransportFrameError("frame crc mismatch")
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransportFrameError(f"frame payload not JSON: {e}") from e


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class InProcTransport:
    """Direct dispatch against an in-process replica — the codec's
    identity path.  ``kill``/``restart`` forward to the backing
    replica, so chaos tests keep their exact semantics."""

    def __init__(self, replica):
        self.local_replica = replica

    def alive(self) -> bool:
        return self.local_replica.alive()

    def call(self, cmd: Dict[str, Any]) -> Any:
        resp = dispatch(self.local_replica, cmd)
        if "err" in resp:
            raise_wire(resp)
        return resp["ok"]

    def kill(self, reason: str = "killed") -> None:
        self.local_replica.kill(reason)

    def restart(self) -> List[int]:
        return self.local_replica.restart()

    def close(self) -> None:
        pass

    @property
    def kills(self) -> int:
        return self.local_replica.kills

    @property
    def first_rc(self):
        return None


class StreamTransport:
    """The framed codec over any (readable, writable) binary stream
    pair.  EOF and torn frames mark the transport dead and raise
    ``ReplicaDeadError`` — there is no recovery short of ``restart()``
    (which subclasses that own the peer implement)."""

    def __init__(self, rfile, wfile, name: str = "stream",
                 local_replica=None):
        self._rfile = rfile
        self._wfile = wfile
        self.name = name
        self._dead = False
        self.kills = 0
        self.first_rc: Optional[int] = None
        self._lock = threading.Lock()
        # set when the peer is an in-process serve thread (tests): lets
        # TransportReplica expose ``.engine`` for white-box assertions
        self.local_replica = local_replica

    def alive(self) -> bool:
        return not self._dead

    def _mark_dead(self, why: str) -> None:
        if not self._dead:
            self._dead = True
            self.kills += 1
            if self.first_rc is None:
                self.first_rc = self._peer_rc()
        self._close_files()
        raise ReplicaDeadError(f"replica {self.name}: {why}")

    def _peer_rc(self) -> Optional[int]:
        return None

    def _close_files(self) -> None:
        for f in (self._rfile, self._wfile):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass

    def call(self, cmd: Dict[str, Any]) -> Any:
        with self._lock:
            if self._dead:
                raise ReplicaDeadError(f"replica {self.name} transport is dead")
            try:
                write_frame(self._wfile, cmd)
                resp = read_frame(self._rfile)
            except (EOFError, TransportFrameError, BrokenPipeError,
                    OSError, ValueError) as e:
                self._mark_dead(f"{type(e).__name__}: {e}")
        if "err" in resp:
            raise_wire(resp)
        return resp["ok"]

    def kill(self, reason: str = "killed") -> None:
        """Sever the stream (tests); process transports override with a
        real SIGKILL."""
        self._dead = True
        self.kills += 1
        self._close_files()
        logger.warning(f"fleet: transport {self.name} killed ({reason})")

    def restart(self) -> List[int]:
        raise ReplicaDeadError(
            f"replica {self.name}: stream transport cannot respawn its peer")

    def close(self) -> None:
        if self._dead:
            return
        try:
            with self._lock:
                write_frame(self._wfile, {"op": "exit"})
                read_frame(self._rfile)
        except (EOFError, TransportFrameError, OSError, ValueError,
                ReplicaDeadError):
            pass
        self._dead = True
        self._close_files()


class SocketTransport(StreamTransport):
    """:class:`StreamTransport` over a connected socket."""

    def __init__(self, sock: socket.socket, name: str = "socket",
                 local_replica=None):
        self._sock = sock
        super().__init__(sock.makefile("rb"), sock.makefile("wb"),
                         name=name, local_replica=local_replica)

    @classmethod
    def connect(cls, host: str, port: int, name: str = "socket",
                timeout: Optional[float] = None) -> "SocketTransport":
        sock = socket.create_connection((host, port), timeout=timeout)
        return cls(sock, name=name)

    def _close_files(self) -> None:
        super()._close_files()
        try:
            self._sock.close()
        except OSError:
            pass


class ProcessTransport(StreamTransport):
    """The framed codec over a child process's stdio pipes.  The child
    runs :func:`serve_stdio` (see ``deepspeed_tpu_torch/tools/fleet_chaos.py
    --role worker``).  ``restart()`` respawns over the same journal directory
    (sans fault plan) and replays via the ``recover`` op — the
    parent-side half of the lossless-restart contract.

    Every child this transport ends is reaped (``wait()``) before the
    next one starts: a killed child's device memory is only freed once
    its parent has collected it, and replicas that share one card need
    it back.  ``stderr_path`` (default: discard) appends every
    incarnation's standard error to that file."""

    def __init__(self, name: str, argv: List[str],
                 fault_plan: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 stderr_path: Optional[str] = None):
        self.name = name
        self._argv = list(argv)
        self._base_env = dict(os.environ if env is None else env)
        self._stderr_path = stderr_path
        self.proc: Optional[subprocess.Popen] = None
        super().__init__(None, None, name=name)
        self._spawn(fault_plan)

    def _spawn(self, fault_plan: Optional[str] = None) -> None:
        env = dict(self._base_env)
        env.pop("DS_FAULT_PLAN", None)
        if fault_plan is not None:
            env["DS_FAULT_PLAN"] = fault_plan
        if self._stderr_path is None:
            err = subprocess.DEVNULL
        else:
            err = open(self._stderr_path, "ab")
        try:
            self.proc = subprocess.Popen(
                self._argv, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err,
            )
        finally:
            if err is not subprocess.DEVNULL:
                err.close()  # the child holds its own descriptor
        self._rfile = self.proc.stdout
        self._wfile = self.proc.stdin
        self._dead = False

    def alive(self) -> bool:
        return (not self._dead and self.proc is not None
                and self.proc.poll() is None)

    def _peer_rc(self) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            return self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            return self.proc.poll()

    def call(self, cmd: Dict[str, Any]) -> Any:
        if self.proc is None or self.proc.poll() is not None:
            if not self._dead:
                with self._lock:
                    if not self._dead:
                        self._mark_dead(f"process exited rc={self.proc.poll()}"
                                        if self.proc is not None
                                        else "never spawned")
            raise ReplicaDeadError(f"replica {self.name} process is gone")
        return super().call(cmd)

    def kill(self, reason: str = "killed") -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.first_rc is None and self.proc is not None:
            self.first_rc = self.proc.poll()
        super().kill(reason)

    def restart(self) -> List[int]:
        if self.proc is not None:
            if self.proc.poll() is None:  # torn stream, live peer: end it
                self.proc.kill()
            rc = self.proc.wait()  # reaped: its device memory is free again
            if self.first_rc is None:
                self.first_rc = rc
        self._spawn()  # same argv / journal dir, no fault plan
        return self.call({"op": "recover"})

    def close(self) -> None:
        super().close()
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


# ---------------------------------------------------------------------------
# serve loops
# ---------------------------------------------------------------------------

def serve_stream(rep, rfile, wfile) -> None:
    """Serve one framed op stream against a replica until ``exit``, a
    clean EOF, or a torn frame (the server closes; the client's next
    read EOFs into ``ReplicaDeadError``)."""
    while True:
        try:
            cmd = read_frame(rfile)
        except EOFError:
            return
        except TransportFrameError as e:
            logger.warning(f"transport: dropping connection on {e}")
            return
        resp = dispatch(rep, cmd)
        try:
            write_frame(wfile, resp)
        except (BrokenPipeError, OSError):
            return
        if cmd.get("op") == "exit":
            return


def serve_socket(rep, sock: socket.socket) -> None:
    with sock:
        serve_stream(rep, sock.makefile("rb"), sock.makefile("wb"))


def serve_stdio(rep) -> None:
    """Child-process entry: claim fd 0/1 as the private framed channel
    BEFORE anything logs — fd 1 is re-pointed at stderr so framework
    prints cannot corrupt the framing.  A child that imports the port
    before it calls this must claim the descriptors first itself (the
    port's logger binds ``sys.stdout`` at import)."""
    rfile = os.fdopen(os.dup(0), "rb")
    wfile = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    serve_stream(rep, rfile, wfile)


class LoopbackTransport(SocketTransport):
    """A REAL socketpair + serve thread over an in-process replica —
    the full framed codec without a child process (the both-transports
    test rig).  ``kill``/``restart`` compose the stream semantics with
    the backing replica's, so the supervisor's kill → restart → replay
    cycle behaves exactly as it does over a child process."""

    def __init__(self, rep, name: Optional[str] = None):
        self._rep = rep
        self._serve_thread: Optional[threading.Thread] = None
        sock = self._start_serve(name or rep.name)
        super().__init__(sock, name=name or rep.name, local_replica=rep)

    def _start_serve(self, name: str) -> socket.socket:
        a, b = socket.socketpair()
        self._serve_thread = threading.Thread(
            target=serve_socket, args=(self._rep, b), daemon=True,
            name=f"serve-{name}")
        self._serve_thread.start()
        return a

    def kill(self, reason: str = "killed") -> None:
        # kill the replica FIRST (drop the engine — only journal-durable
        # state survives), then sever the stream
        if self._rep.alive():
            self._rep.kill(reason)
        super().kill(reason)

    def restart(self) -> List[int]:
        with self._lock:
            self._close_files()
            replayed = self._rep.restart()
            sock = self._start_serve(self.name)
            self._sock = sock
            self._rfile = sock.makefile("rb")
            self._wfile = sock.makefile("wb")
            self._dead = False
            return replayed

    def close(self) -> None:
        super().close()
        if self._serve_thread is not None:
            # the closed socketpair EOFs the serve loop; reap it
            self._serve_thread.join(timeout=5)
            self._serve_thread = None


def loopback_transport(rep, name: Optional[str] = None) -> LoopbackTransport:
    return LoopbackTransport(rep, name=name)


# ---------------------------------------------------------------------------
# the replica over a transport
# ---------------------------------------------------------------------------

class _WireResult:
    """Client-side view of a retired request (the fields the router and
    the fleet tests consume)."""

    def __init__(self, d: Dict[str, Any]):
        self._tokens = d["tokens"]
        self.finish_reason = d["finish_reason"]
        self.first_token_time = d["first_token_time"]
        self.submit_time = d["submit_time"]
        self.retry_after = d.get("retry_after")
        # ``result`` op views carry the liveness gates the router's
        # client_key dedup path reads; pop records are retired by
        # construction, so default them finished
        self.finish_time = d.get("finish_time", d["submit_time"])
        self.first_token = bool(d.get("first_token",
                                      d["first_token_time"] is not None))
        self.finished = bool(d.get("finished", True))

    def tokens(self):
        return self._tokens


class TransportReplica:
    """The full fleet replica surface over a :class:`Transport` — the
    router, supervisor and autoscaler cannot tell it from a
    :class:`LocalReplica`.  Dead-transport reads return the same
    neutral values LocalReplica returns for a dead engine; submit/step
    raise ``ReplicaDeadError`` (safe-retry signal)."""

    def __init__(self, name: str, transport):
        self.name = str(name)
        self.transport = transport

    # -- white-box access (in-process transports only) --------------------
    @property
    def engine(self):
        rep = getattr(self.transport, "local_replica", None)
        return None if rep is None else rep.engine

    @property
    def kills(self) -> int:
        return self.transport.kills

    @property
    def first_rc(self):
        return self.transport.first_rc

    # -- liveness ---------------------------------------------------------
    def alive(self) -> bool:
        return self.transport.alive()

    def kill(self, reason: str = "killed") -> None:
        self.transport.kill(reason)

    def restart(self) -> List[int]:
        return self.transport.restart()

    def close(self) -> None:
        self.transport.close()

    # -- request surface --------------------------------------------------
    def submit(self, prompt, client_key=None, **kw) -> int:
        return self.transport.call({
            "op": "submit", "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "client_key": client_key, "kw": kw,
        })

    def cancel(self, request_id: int) -> bool:
        if not self.alive():
            return False
        try:
            return bool(self.transport.call({"op": "cancel",
                                             "id": int(request_id)}))
        except ReplicaDeadError:
            return False

    def step(self) -> bool:
        return bool(self.transport.call({"op": "step"}))

    def has_work(self) -> bool:
        if not self.alive():
            return False
        return bool(self.transport.call({"op": "has_work"}))

    def pop_results(self) -> Dict[int, Any]:
        if not self.alive():
            return {}
        return {int(rid): _WireResult(d)
                for rid, d in self.transport.call({"op": "pop"}).items()}

    def result(self, request_id: int) -> Optional[Any]:
        if not self.alive():
            return None
        d = self.transport.call({"op": "result", "id": int(request_id)})
        return None if d is None else _WireResult(d)

    def partial_result(self, request_id: int) -> Optional[Dict[str, Any]]:
        if not self.alive():
            return None
        return self.transport.call({"op": "partial", "id": int(request_id)})

    def first_token_seen(self, request_id: int) -> bool:
        r = self.result(request_id)
        return bool(r and r.first_token)

    def client_request_id(self, client_key: str) -> Optional[int]:
        if not self.alive():
            return None
        return self.transport.call({"op": "ck", "key": str(client_key)})

    # -- load / health feeds ----------------------------------------------
    def estimate_ttft(self, prompt_len: int) -> Optional[float]:
        if not self.alive():
            return None
        return self.transport.call({"op": "health",
                                    "len": int(prompt_len)})["est"]

    def kv_affinity(self, prompt, session_id: Optional[str] = None) -> float:
        if not self.alive():
            return 0.0
        return float(self.transport.call({
            "op": "affinity",
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "session_id": session_id,
        }))

    def queue_depth(self) -> int:
        if not self.alive():
            return 0
        return int(self.transport.call({"op": "health"})["depth"])

    def degrade_level(self) -> int:
        if not self.alive():
            return 0
        return int(self.transport.call({"op": "health"})["level"])

    def draining(self) -> bool:
        if not self.alive():
            return False
        return bool(self.transport.call({"op": "health"})["draining"])

    def stats(self) -> Dict[str, Any]:
        if not self.alive():
            return {"dead": True}
        return self.transport.call({"op": "stats"})

    # -- live migration (the elastic fleet's scale-down) -------------------
    def export_sessions(self, dest_dir: str) -> List[str]:
        return self.transport.call({"op": "export", "dir": dest_dir})

    def import_sessions(self, src_dir: str) -> Dict[str, int]:
        return self.transport.call({"op": "import", "dir": src_dir})

    def sweep_sessions(self, now: float) -> int:
        if not self.alive():
            return 0
        return int(self.transport.call({"op": "sweep", "now": float(now)}))

    def kv_stats(self) -> Dict[str, Any]:
        if not self.alive():
            return {}
        return self.transport.call({"op": "kvstats"})


def wrap_replica(rep, transport: str = "inproc"):
    """Wrap a LocalReplica behind the named transport (``inproc`` |
    ``socket``) — the rig the fleet suites use to prove the router /
    supervisor / autoscaler run unchanged over both."""
    if transport == "inproc":
        return TransportReplica(rep.name, InProcTransport(rep))
    if transport == "socket":
        return TransportReplica(rep.name, loopback_transport(rep))
    raise ValueError(f"unknown transport {transport!r}")


__all__ = [
    "WIRE_EXCEPTIONS", "encode_error", "raise_wire", "dispatch",
    "TransportFrameError", "write_frame", "read_frame", "MAGIC",
    "MAX_FRAME_BYTES", "InProcTransport", "StreamTransport",
    "SocketTransport", "ProcessTransport", "serve_stream", "serve_socket",
    "serve_stdio", "loopback_transport", "TransportReplica", "wrap_replica",
]
