"""Stdlib HTTP front-door over a serving engine (counterpart of
``deepspeed_tpu/serving/frontdoor/http.py``).

One :class:`FrontDoor` wraps one :class:`~deepspeed_tpu_torch.serving.engine.
ServingEngine` behind a ``ThreadingHTTPServer``:

* ``POST /v1/generate`` — submit a token-id prompt.  ``"stream": true``
  answers with a chunked (HTTP/1.1 ``Transfer-Encoding: chunked``)
  JSON-lines body: one ``{"tokens": [...]}`` delta per poll that found
  new tokens, then a final ``{"done": true, ...}`` line.  Without
  ``stream`` the handler blocks until the request retires and returns
  one JSON object.
* ``GET /healthz`` — liveness + drain/degrade state (503 while
  draining, so a balancer stops sending).
* ``GET /statsz`` — the engine's full stats tree, JSON.

Overload answers carry machine-readable backpressure: a queue-full or
tenant-throttled submit is HTTP 429, overload-shed and draining are
HTTP 503, and every one of them surfaces the scheduler's
``retry_after`` both as a ``Retry-After`` header (integer seconds,
per RFC 9110) and exactly in the JSON error body.

Client deadlines map onto scheduler deadlines: ``"deadline_seconds"``
in the body bounds the request's queue wait exactly like
``ServingEngine.submit(deadline_seconds=...)`` — an expired request
answers 503 with ``"finish_reason": "expired"``.

Graceful drain composes with the serving watchdog: SIGTERM (via
``engine.install_watchdog()``) makes the pump thread's next
``engine.step()`` run the drain — admission stops (new submits answer
503 + Retry-After), in-flight requests keep decoding and stream out,
the journal commits, and only then does the process exit 43
(:func:`FrontDoor._pump` converts the engine's ``SystemExit`` into
``os._exit`` after the last active stream flushes).

Fault sites ``frontdoor.accept`` (request admission) and
``frontdoor.stream`` (every streamed chunk) feed the chaos matrix —
a ``sigkill`` plan at ``frontdoor.stream`` is the kill -9 mid-stream
proof (``deepspeed_tpu_torch/tools/frontdoor_chaos.py``).

One ``RLock`` serializes every touch of the engine: the pump thread
holds it for each step and the handler threads for each submit and
poll, so the card is only ever driven by one thread at a time.
"""
from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving.scheduler import (
    ServingDraining,
    ServingOverloaded,
    ServingQueueFull,
)
from deepspeed_tpu_torch.serving.frontdoor.tenants import TenantThrottled
from deepspeed_tpu_torch.serving.frontdoor.transport import _json_safe
from deepspeed_tpu_torch.utils.logging import logger


def _retry_after_header(retry_after: Optional[float]) -> Optional[str]:
    """RFC 9110 Retry-After is integer delta-seconds; round up so the
    client never retries early."""
    if retry_after is None:
        return None
    return str(max(0, int(math.ceil(float(retry_after)))))


def _status_for(exc: ServingQueueFull) -> int:
    """The satellite bugfix: the subclass distinction survives to the
    HTTP layer — queue-full and tenant-throttle are the client's fault
    (429 Too Many Requests), overload-shed and draining are the
    server's (503 Service Unavailable)."""
    if isinstance(exc, (ServingOverloaded, ServingDraining)):
        return 503
    return 429


class FrontDoor:
    """The HTTP surface over one engine.  ``start()`` binds the server
    and (by default) a pump thread that turns ``engine.step()``;
    ``serve_forever()`` instead runs the pump in the calling thread —
    the standalone-server mode, where the watchdog's drain
    ``SystemExit(43)`` must unwind the main thread."""

    def __init__(self, engine, config=None, host: Optional[str] = None,
                 port: Optional[int] = None):
        cfg = config if config is not None else getattr(
            engine.config, "frontdoor", None)
        self.engine = engine
        self.host = host if host is not None else (
            cfg.host if cfg is not None else "127.0.0.1")
        self._port = port if port is not None else (
            cfg.port if cfg is not None else 0)
        self.stream_poll_seconds = (
            cfg.stream_poll_seconds if cfg is not None else 0.01)
        self.max_body_bytes = (
            cfg.max_body_bytes if cfg is not None else 1 << 20)
        # ONE lock serializes every engine touch: the pump thread holds
        # it per step, handler threads per submit/poll — the engine
        # itself is not thread-safe
        self.lock = threading.RLock()
        self._streams = 0  # active chunked responses (drain barrier)
        self._streams_cv = threading.Condition()
        self._stop = threading.Event()
        # set once the engine's drain has committed the journal and the
        # process is about to exit: any still-unfinished request was
        # queued (or spilled), will replay after restart, and its
        # stream must be CUT, not waited on
        self._drain_exiting = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self.requests_served = 0

    # -- lifecycle --------------------------------------------------------

    @property
    def port(self) -> int:
        return (self._server.server_address[1]
                if self._server is not None else self._port)

    def start(self, pump: bool = True) -> "FrontDoor":
        """Bind + serve in background threads; returns self (the bound
        ephemeral port is ``self.port``)."""
        self._bind()
        if pump:
            self._pump_thread = threading.Thread(
                target=self._pump, name="frontdoor-pump", daemon=True)
            self._pump_thread.start()
        return self

    def serve_forever(self) -> None:
        """Standalone-server mode: bind, serve HTTP in background
        threads, and run the pump in THIS thread so the watchdog's
        drain ``SystemExit(43)`` unwinds normally."""
        self._bind()
        self._pump()

    def _bind(self) -> None:
        if self._server is not None:
            return
        fd = self

        class Handler(_Handler):
            frontdoor = fd

        self._server = ThreadingHTTPServer((self.host, self._port), Handler)
        self._server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="frontdoor-http",
            daemon=True)
        self._server_thread.start()
        logger.info(f"frontdoor: serving on {self.host}:{self.port}")

    def close(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10)
            self._pump_thread = None

    # -- the pump ---------------------------------------------------------

    def _pump(self) -> None:
        """Turn the engine until stopped.  A drain signal surfaces as
        ``SystemExit`` out of ``engine.step()`` (journal already
        committed) — wait for active streams to flush their final
        chunk, then exit the PROCESS with the watchdog's code: exit 43
        only after journal commit AND stream-out."""
        try:
            while not self._stop.is_set():
                with self.lock:
                    busy = self.engine.step()
                if not busy:
                    time.sleep(self.stream_poll_seconds)
                else:
                    # hand the GIL to a handler thread woken by the
                    # release, or this loop retakes the lock at once and
                    # a stream's poll waits out the whole generation
                    time.sleep(0)
        except SystemExit as e:
            code = 0 if e.code is None else int(e.code)
            self._drain_exiting.set()
            self._await_streams(timeout=30.0)
            logger.info(f"frontdoor: drained; exiting {code}")
            os._exit(code)

    def _await_streams(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self._streams_cv:
            while self._streams > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    logger.warning(
                        f"frontdoor: {self._streams} stream(s) still "
                        "active at drain-exit deadline")
                    return
                self._streams_cv.wait(left)

    def _stream_enter(self) -> None:
        with self._streams_cv:
            self._streams += 1

    def _stream_exit(self) -> None:
        with self._streams_cv:
            self._streams -= 1
            self._streams_cv.notify_all()

    # -- engine access (all under self.lock) ------------------------------

    def submit(self, body: Dict[str, Any]) -> int:
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of token ids")
        kw: Dict[str, Any] = {}
        for key in ("max_new_tokens", "eos_token_id", "top_k", "seed",
                    "priority"):
            if body.get(key) is not None:
                kw[key] = int(body[key])
        for key in ("deadline_seconds", "temperature"):
            if body.get(key) is not None:
                kw[key] = float(body[key])
        if body.get("deadline_ms") is not None:
            kw["deadline_seconds"] = float(body["deadline_ms"]) / 1000.0
        if body.get("do_sample") is not None:
            kw["do_sample"] = bool(body["do_sample"])
        for key in ("client_key", "session_id", "tenant"):
            if body.get(key) is not None:
                kw[key] = str(body[key])
        with self.lock:
            return self.engine.submit(np.asarray(prompt, np.int32), **kw)

    def poll(self, rid: int) -> Optional[Dict[str, Any]]:
        """Tokens generated so far + finish state — the stream chunk
        source (the `partial` RPC op's twin)."""
        with self.lock:
            r = self.engine.result(rid)
            if r is None:
                return None
            return {
                "generated": [int(t) for t in getattr(r, "generated", [])],
                "finished": r.finish_time is not None,
                "finish_reason": r.finish_reason,
            }

    def retire(self, rid: int) -> None:
        """Drop a fully-answered request from the finished map (the
        front-door owns the engine; nothing else pops results)."""
        with self.lock:
            self.engine.scheduler._finished.pop(rid, None)

    def health(self) -> Dict[str, Any]:
        with self.lock:
            eng = self.engine
            wd = eng._watchdog
            return {
                "ok": True,
                "draining": bool(wd is not None and wd.draining),
                "queue_depth": int(eng.scheduler.queue_depth),
                "degrade_level": int(eng.scheduler.ladder.level),
            }

    def stats(self) -> Dict[str, Any]:
        with self.lock:
            return _json_safe(self.engine.stats())


class _Handler(BaseHTTPRequestHandler):
    frontdoor: FrontDoor  # bound by FrontDoor._bind's subclass
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        logger.debug(f"frontdoor: {self.address_string()} {format % args}")

    # -- plumbing ---------------------------------------------------------

    def _send_json(self, status: int, obj: Dict[str, Any],
                   retry_after: Optional[float] = None) -> None:
        payload = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        ra = _retry_after_header(retry_after)
        if ra is not None:
            self.send_header("Retry-After", ra)
        self.end_headers()
        self.wfile.write(payload)

    def _send_error_for(self, exc: BaseException) -> None:
        if isinstance(exc, ServingQueueFull):
            ra = getattr(exc, "retry_after", None)
            self._send_json(
                _status_for(exc),
                {"error": str(exc), "type": type(exc).__name__,
                 "retry_after": ra},
                retry_after=ra,
            )
        elif isinstance(exc, ValueError):
            self._send_json(400, {"error": str(exc), "type": "ValueError"})
        else:
            self._send_json(
                500, {"error": str(exc), "type": type(exc).__name__})

    def _read_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length > self.frontdoor.max_body_bytes:
            raise ValueError(
                f"request body {length} bytes exceeds cap "
                f"{self.frontdoor.max_body_bytes}")
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"request body is not JSON: {e}") from e
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    # -- routes -----------------------------------------------------------

    def do_GET(self):  # noqa: N802 — stdlib dispatch name
        try:
            if self.path == "/healthz":
                h = self.frontdoor.health()
                self._send_json(503 if h["draining"] else 200, h)
            elif self.path == "/statsz":
                self._send_json(200, self.frontdoor.stats())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — must answer something
            try:
                self._send_error_for(e)
            except OSError:
                pass

    def do_POST(self):  # noqa: N802 — stdlib dispatch name
        if self.path != "/v1/generate":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            faults.check("frontdoor.accept")
            faults.check_latency("frontdoor.accept")
            body = self._read_body()
            rid = self.frontdoor.submit(body)
        except BrokenPipeError:
            return
        except Exception as e:  # noqa: BLE001 — becomes the HTTP error
            try:
                self._send_error_for(e)
            except OSError:
                pass
            return
        if body.get("stream"):
            self._stream_response(rid, body)
        else:
            self._block_response(rid)
        self.frontdoor.requests_served += 1

    # -- response modes ---------------------------------------------------

    def _block_response(self, rid: int) -> None:
        poll = self.frontdoor.stream_poll_seconds
        while True:
            r = self.frontdoor.poll(rid)
            if r is None:
                self._send_json(
                    500, {"error": f"request {rid} vanished", "request_id": rid})
                return
            if r["finished"]:
                break
            time.sleep(poll)
        self.frontdoor.retire(rid)
        status = 200 if r["finish_reason"] in ("eos", "length") else 503
        self._send_json(status, {
            "request_id": rid,
            "tokens": r["generated"],
            "finish_reason": r["finish_reason"],
            "n_tokens": len(r["generated"]),
        })

    def _write_chunk(self, obj: Dict[str, Any]) -> None:
        # every streamed chunk is a fault site: a sigkill plan here IS
        # the kill -9 mid-stream proof (tools/frontdoor_chaos.py)
        faults.check("frontdoor.stream")
        faults.check_latency("frontdoor.stream")
        data = (json.dumps(obj) + "\n").encode("utf-8")
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        self.wfile.write(data + b"\r\n")
        self.wfile.flush()

    def _stream_response(self, rid: int, body: Dict[str, Any]) -> None:
        self.frontdoor._stream_enter()
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonlines")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._write_chunk({"request_id": rid})
            sent = 0
            poll = self.frontdoor.stream_poll_seconds
            while True:
                r = self.frontdoor.poll(rid)
                if r is None:
                    # vanished mid-stream (recovery raced us): the
                    # missing terminating chunk tells the client
                    return
                if len(r["generated"]) > sent:
                    self._write_chunk({"tokens": r["generated"][sent:]})
                    sent = len(r["generated"])
                if r["finished"]:
                    break
                if self.frontdoor._drain_exiting.is_set():
                    # drain committed with this request unfinished — it
                    # was queued (never held a slot) or spilled, and
                    # will replay from the journal after restart.  Cut
                    # the stream so the client retries its client_key.
                    return
                time.sleep(poll)
            self.frontdoor.retire(rid)
            self._write_chunk({
                "done": True,
                "finish_reason": r["finish_reason"],
                "n_tokens": sent,
            })
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; generation retires on its own
        finally:
            self.frontdoor._stream_exit()


__all__ = ["FrontDoor"]
