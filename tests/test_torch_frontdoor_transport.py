"""The port's RPC transport (``deepspeed_tpu_torch.serving.frontdoor.
transport``) on the CPU, a mirror of ``tests/test_frontdoor_transport.py``
held against the JAX package.

* The JAX file's tests on the port: a frame round trip; a torn frame at
  every truncation point; seeded byte-flip fuzz, pure garbage and an
  oversized frame; the serving exceptions round-tripping as their exact
  class with ``retry_after``; the dispatch table; ``wrap_replica`` parity
  across ``inproc``, ``loopback`` (a socketpair and a serve thread) and
  ``socket`` (a TCP connection to ``serve_socket``); a torn or fuzzed
  socket response raising ``ReplicaDeadError``, never a hang; a dead
  transport's neutral values.
* Across packages: for the same object the JAX ``write_frame`` writes the
  port's bytes, and each package's ``read_frame`` reads the other's; a
  port ``TransportReplica`` over a socket to the JAX ``serve_stream`` (a
  JAX engine in a thread), and the reverse, give the same tokens and the
  same exception classes by name.
* A ``ProcessTransport`` child (``tools/fleet_chaos.py --replica``) killed
  by ``DS_FAULT_PLAN`` raises ``ReplicaDeadError`` with rc -9, and its
  restart replays the journal to solo ``generate()``'s tokens.
"""
import dataclasses
import io
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience.faults import InjectedFault
from deepspeed_tpu_torch.serving.fleet.replica import ReplicaDeadError
from deepspeed_tpu_torch.serving.frontdoor.tenants import TenantThrottled
from deepspeed_tpu_torch.serving.frontdoor.transport import (
    MAGIC,
    InProcTransport,
    LoopbackTransport,
    SocketTransport,
    TransportFrameError,
    TransportReplica,
    dispatch,
    encode_error,
    raise_wire,
    read_frame,
    serve_socket,
    wrap_replica,
    write_frame,
)
from deepspeed_tpu_torch.serving.scheduler import (
    ServingDraining,
    ServingOverloaded,
    ServingQueueFull,
)

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TTINY = tgpt2.GPT2_TINY
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcp_replica(rep):
    """``rep`` served by ``serve_socket`` on a localhost TCP listener in a
    thread, and a ``TransportReplica`` connected to it."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def accept():
        conn, _ = srv.accept()
        srv.close()
        serve_socket(rep, conn)

    threading.Thread(target=accept, daemon=True).start()
    return TransportReplica(rep.name, SocketTransport.connect("127.0.0.1", port, name=rep.name))


def _over(rep, mode):
    if mode == "inproc":
        return wrap_replica(rep, "inproc")
    if mode == "loopback":
        return TransportReplica(rep.name, LoopbackTransport(rep))
    return _tcp_replica(rep)


# ---------------------------------------------------------------------------
# fakes: the minimal LocalReplica duck surface, no engine
# ---------------------------------------------------------------------------

class _Result:
    def __init__(self, tokens, reason="eos"):
        self._tokens = list(tokens)
        self.finish_reason = reason
        self.first_token_time = 1.0
        self.submit_time = 0.5
        self.retry_after = None

    def tokens(self):
        return self._tokens


class _FakeReplica:
    def __init__(self, name="fake", submit_raises=None):
        self.name = name
        self._next = 0
        self._raises = submit_raises
        self._done = {}
        self._keys = {}
        self.kills = 0

    def alive(self):
        return True

    def submit(self, prompt, client_key=None, **kw):
        if self._raises is not None:
            raise self._raises
        rid = self._next
        self._next += 1
        if client_key:
            self._keys[client_key] = rid
        self._done[rid] = _Result(int(t) for t in np.asarray(prompt))
        return rid

    def step(self):
        return False

    def has_work(self):
        return False

    def pop_results(self):
        out, self._done = self._done, {}
        return out

    def cancel(self, rid):
        return False

    def result(self, rid):
        return None

    def client_request_id(self, key):
        return self._keys.get(key)

    def estimate_ttft(self, n):
        return 0.002

    def queue_depth(self):
        return 3

    def degrade_level(self):
        return 1

    def draining(self):
        return False

    def stats(self):
        return {"queued": np.int64(3), "rates": np.asarray([1.5])}

    def kill(self, reason="killed"):
        self.kills += 1

    def restart(self):
        return []


def _frame_bytes(obj):
    buf = io.BytesIO()
    write_frame(buf, obj)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def test_frame_roundtrip():
    for obj in ({"op": "step"}, {"ok": [1, 2, 3]}, {"nested": {"a": None}},
                {"unicode": "héllo", "f": 1.25}):
        assert read_frame(io.BytesIO(_frame_bytes(obj))) == obj


def test_frame_stream_of_frames():
    objs = [{"i": i} for i in range(5)]
    stream = io.BytesIO(b"".join(_frame_bytes(o) for o in objs))
    assert [read_frame(stream) for _ in objs] == objs
    with pytest.raises(EOFError):
        read_frame(stream)


def test_torn_frame_every_truncation_point():
    """Satellite (a): a frame cut at ANY byte boundary is a clean
    error — EOFError exactly at zero bytes, TransportFrameError at
    every other cut — never a hang, never a parse."""
    buf = _frame_bytes({"op": "submit", "prompt": [1, 2, 3], "kw": {}})
    for cut in range(len(buf)):
        exc = EOFError if cut == 0 else TransportFrameError
        with pytest.raises(exc):
            read_frame(io.BytesIO(buf[:cut]))
    assert read_frame(io.BytesIO(buf))["op"] == "submit"


def test_garbage_frame_fuzz_seeded():
    """Seeded byte-flip fuzz: every single-byte corruption of a valid
    frame must raise TransportFrameError (magic, length, crc and
    payload are ALL covered by the header checks + crc32)."""
    buf = bytearray(_frame_bytes({"op": "pop", "blob": "x" * 64}))
    rng = np.random.default_rng(1234)
    for _ in range(200):
        pos = int(rng.integers(0, len(buf)))
        flip = bytes(buf[:pos]) + bytes([buf[pos] ^ (1 + int(rng.integers(0, 255)))]) \
            + bytes(buf[pos + 1:])
        with pytest.raises(TransportFrameError):
            read_frame(io.BytesIO(flip))


def test_pure_garbage_is_bad_magic():
    with pytest.raises(TransportFrameError):
        read_frame(io.BytesIO(b"not a frame at all, definitely"))
    assert MAGIC == b"DSRP"


def test_oversized_frame_rejected():
    import struct
    import zlib

    hdr = struct.Struct(">4sII").pack(MAGIC, 1 << 30, zlib.crc32(b""))
    with pytest.raises(TransportFrameError):
        read_frame(io.BytesIO(hdr))


# ---------------------------------------------------------------------------
# exception codec (satellite c)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [ServingQueueFull, ServingOverloaded,
                                 ServingDraining, TenantThrottled])
def test_exception_roundtrip_exact_class_and_retry_after(cls):
    resp = encode_error(cls("bucket empty", retry_after=2.5))
    with pytest.raises(cls) as ei:
        raise_wire(resp)
    assert type(ei.value) is cls  # EXACT class, not a collapsed parent
    assert ei.value.retry_after == 2.5


def test_exception_roundtrip_dead_and_injected():
    with pytest.raises(ReplicaDeadError):
        raise_wire(encode_error(ReplicaDeadError("gone")))
    with pytest.raises(InjectedFault):
        raise_wire(encode_error(InjectedFault("seeded")))


def test_unknown_exception_degrades_to_runtime_error():
    class Weird(Exception):
        pass

    with pytest.raises(RuntimeError, match="Weird"):
        raise_wire(encode_error(Weird("boom")))


def test_throttle_roundtrips_over_real_socket():
    """The regression for the satellite bugfix: a TenantThrottled (and
    its retry_after) crossing a REAL framed socket stays a
    TenantThrottled — the front-door's 429 depends on it."""
    rep = _FakeReplica(
        submit_raises=TenantThrottled("tenant over quota", retry_after=7.0))
    wrapped = wrap_replica(rep, "socket")
    try:
        with pytest.raises(TenantThrottled) as ei:
            wrapped.submit(np.asarray([1, 2, 3], np.int32))
        assert type(ei.value) is TenantThrottled
        assert ei.value.retry_after == 7.0
        assert wrapped.alive()  # a WIRE exception is not a dead peer
    finally:
        wrapped.close()


# ---------------------------------------------------------------------------
# dispatch table
# ---------------------------------------------------------------------------

def test_dispatch_submit_pop_ck_health_stats():
    rep = _FakeReplica()
    rid = dispatch(rep, {"op": "submit", "prompt": [5, 6],
                         "client_key": "k1", "kw": {}})["ok"]
    assert rid == 0
    popped = dispatch(rep, {"op": "pop"})["ok"]
    assert popped[str(rid)]["tokens"] == [5, 6]
    assert popped[str(rid)]["finish_reason"] == "eos"
    assert dispatch(rep, {"op": "ck", "key": "k1"})["ok"] == rid
    assert dispatch(rep, {"op": "ck", "key": "nope"})["ok"] is None
    h = dispatch(rep, {"op": "health"})["ok"]
    assert h == {"depth": 3, "level": 1, "draining": False,
                 "est": pytest.approx(0.002)}
    # stats must come back JSON-plain (numpy scrubbed)
    st = dispatch(rep, {"op": "stats"})["ok"]
    assert st == {"queued": 3, "rates": [1.5]}
    assert isinstance(st["queued"], int)


def test_dispatch_unknown_op_is_wire_valueerror():
    resp = dispatch(_FakeReplica(), {"op": "mystery"})
    assert resp["type"] == "ValueError" and "mystery" in resp["err"]
    with pytest.raises(ValueError):
        raise_wire(resp)


# ---------------------------------------------------------------------------
# both transports, one behavior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inproc", "loopback", "socket"])
def test_wrap_replica_parity(mode):
    rep = _FakeReplica()
    wrapped = _over(rep, mode)
    try:
        assert isinstance(wrapped, TransportReplica)
        rid = wrapped.submit(np.asarray([9, 8, 7], np.int32),
                             client_key="ck-1")
        assert rid == 0
        assert wrapped.client_request_id("ck-1") == rid
        out = wrapped.pop_results()
        assert list(out) == [rid] and out[rid].tokens() == [9, 8, 7]
        assert out[rid].finish_reason == "eos"
        assert wrapped.queue_depth() == 3
        assert wrapped.degrade_level() == 1
        assert wrapped.draining() is False
        assert wrapped.estimate_ttft(8) == pytest.approx(0.002)
        assert wrapped.has_work() is False
        assert wrapped.stats()["queued"] == 3
    finally:
        wrapped.close()


def test_wrap_replica_unknown_transport():
    with pytest.raises(ValueError):
        wrap_replica(_FakeReplica(), "carrier-pigeon")


def test_inproc_engine_passthrough():
    rep = _FakeReplica()
    t = InProcTransport(rep)
    assert t.local_replica is rep
    assert t.call({"op": "has_work"}) is False
    assert t.first_rc is None


# ---------------------------------------------------------------------------
# torn frames over a live socket -> ReplicaDeadError, never a hang
# ---------------------------------------------------------------------------

def _evil_peer(sock, payload):
    """Reads one request frame, answers with raw garbage, closes."""
    rfile = sock.makefile("rb")
    try:
        read_frame(rfile)
        sock.sendall(payload)
    finally:
        sock.close()


@pytest.mark.parametrize("payload", [
    b"",                                   # clean EOF mid-conversation
    b"DSRP",                               # torn header
    b"XXXX\x00\x00\x00\x04\x00\x00\x00\x00junk",  # bad magic
    _frame_bytes({"ok": True})[:-3],       # torn payload
    b"\x00" * 64,                          # zero garbage
], ids=["eof", "torn-header", "bad-magic", "torn-payload", "zeros"])
def test_torn_socket_frame_is_dead_replica_not_hang(payload):
    a, b = socket.socketpair()
    peer = threading.Thread(target=_evil_peer, args=(b, payload), daemon=True)
    peer.start()
    t = SocketTransport(a, name="evil")
    t0 = time.monotonic()
    with pytest.raises(ReplicaDeadError):
        t.call({"op": "step"})
    assert time.monotonic() - t0 < 5.0, "torn frame must not hang"
    assert not t.alive() and t.kills == 1
    # every subsequent call fails fast on the dead mark — no IO
    with pytest.raises(ReplicaDeadError):
        t.call({"op": "step"})
    assert t.kills == 1
    peer.join(5)


def test_fuzzed_socket_responses_seeded():
    """Byte-level fuzz loop over seeded truncation points of a VALID
    response frame: whatever prefix the peer manages to send, the
    client gets ReplicaDeadError promptly."""
    full = _frame_bytes({"ok": {"depth": 0, "level": 0,
                                "draining": False, "est": None}})
    rng = np.random.default_rng(99)
    cuts = sorted({int(rng.integers(0, len(full))) for _ in range(24)})
    for cut in cuts:
        a, b = socket.socketpair()
        peer = threading.Thread(target=_evil_peer, args=(b, full[:cut]),
                                daemon=True)
        peer.start()
        t = SocketTransport(a, name=f"fuzz-{cut}")
        with pytest.raises(ReplicaDeadError):
            t.call({"op": "health"})
        assert not t.alive()
        peer.join(5)


def test_dead_transport_replica_neutral_values():
    """A TransportReplica over a dead transport answers the same
    neutral values LocalReplica gives for a dead engine — the router
    health-gates it out instead of crashing."""
    rep = _FakeReplica()
    wrapped = wrap_replica(rep, "socket")
    wrapped.kill("test")
    assert not wrapped.alive()
    assert wrapped.has_work() is False
    assert wrapped.pop_results() == {}
    assert wrapped.result(0) is None
    assert wrapped.partial_result(0) is None
    assert wrapped.cancel(0) is False
    assert wrapped.client_request_id("k") is None
    assert wrapped.queue_depth() == 0
    assert wrapped.degrade_level() == 0
    assert wrapped.draining() is False
    assert wrapped.estimate_ttft(4) is None
    assert wrapped.kv_affinity(np.asarray([1], np.int32)) == 0.0
    assert wrapped.stats() == {"dead": True}
    with pytest.raises(ReplicaDeadError):
        wrapped.submit(np.asarray([1], np.int32))


# ---------------------------------------------------------------------------
# across packages: one wire
# ---------------------------------------------------------------------------

WIRE_OBJECTS = [
    {"op": "submit", "prompt": [1, 2, 3], "client_key": "k", "kw": {"max_new_tokens": 4}},
    {"ok": {"7": {"tokens": [5, 6], "finish_reason": "length", "first_token_time": 1.5,
                  "submit_time": 0.25, "retry_after": None}}},
    {"err": "bucket empty", "type": "TenantThrottled", "retry_after": 2.5},
    {"unicode": "héllo ✓", "f": 1.25, "nested": {"a": [None, True, -3]}},
    {"ok": list(range(300))},
]


@pytest.mark.parametrize("obj", WIRE_OBJECTS, ids=range(len(WIRE_OBJECTS)))
def test_frames_are_the_jax_packages_bytes(obj):
    """For the same object the JAX ``write_frame`` writes the port's bytes,
    and each package's ``read_frame`` reads the other's frame."""
    from deepspeed_tpu.serving.frontdoor import transport as jt

    buf = io.BytesIO()
    jt.write_frame(buf, obj)
    jax_bytes = buf.getvalue()
    assert _frame_bytes(obj) == jax_bytes
    assert read_frame(io.BytesIO(jax_bytes)) == obj
    assert jt.read_frame(io.BytesIO(_frame_bytes(obj))) == obj
    assert jt.MAGIC == MAGIC and jt.MAX_FRAME_BYTES == 64 * 1024 * 1024


def test_torn_port_frame_is_a_frame_error_in_the_jax_package():
    from deepspeed_tpu.serving.frontdoor import transport as jt

    buf = _frame_bytes(WIRE_OBJECTS[0])
    for cut in range(1, len(buf)):
        with pytest.raises(jt.TransportFrameError):
            jt.read_frame(io.BytesIO(buf[:cut]))


def _params(seed=7):
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


@pytest.fixture(scope="module")
def engines():
    import jax.numpy as jnp

    import deepspeed_tpu

    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=_params(),
                                        dtype=jnp.float32, max_out_tokens=JTINY.n_positions)
    teng = deepspeed_tpu_torch.init_inference(model_config=TTINY, params=_params(),
                                              dtype=torch.float32, device="cpu",
                                              max_out_tokens=TTINY.n_positions)
    return jeng, teng


def _serve(pkg, rep):
    """A socketpair whose far end ``pkg``'s ``serve_socket`` serves ``rep``
    in a thread; returns the near end."""
    if pkg == "jax":
        from deepspeed_tpu.serving.frontdoor.transport import serve_socket as serve
    else:
        serve = serve_socket
    a, b = socket.socketpair()
    threading.Thread(target=serve, args=(rep, b), daemon=True).start()
    return a


def _client(pkg, sock, name):
    if pkg == "jax":
        from deepspeed_tpu.serving.frontdoor import transport as jt

        return jt.TransportReplica(name, jt.SocketTransport(sock, name=name))
    return TransportReplica(name, SocketTransport(sock, name=name))


def _drive(client, prompts):
    rids = [client.submit(p, max_new_tokens=6) for p in prompts]
    out = {}
    for _ in range(400):
        if not client.has_work():
            break
        client.step()
        out.update(client.pop_results())
    out.update(client.pop_results())
    return [list(map(int, out[r].tokens())) for r in rids]


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_a_replica_across_packages(engines, tmp_path, server, client):
    """A port ``TransportReplica`` over a socket to the JAX ``serve_stream``
    (a JAX engine behind it), and the reverse: the same tokens as each
    package's solo ``generate()``; and a refusal crosses as the same
    exception class by name, ``retry_after`` intact."""
    from deepspeed_tpu.serving import ServingEngine as JServingEngine
    from deepspeed_tpu.serving.fleet import LocalReplica as JLocalReplica
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.serving.fleet import LocalReplica

    jeng, teng = engines
    kw = dict(num_slots=2, prefill_chunk=8, max_len=64, max_queue=2)
    if server == "jax":
        rep = JLocalReplica("x", lambda: JServingEngine(
            jeng, journal_dir=str(tmp_path / "j"), **kw))
    else:
        rep = LocalReplica("x", lambda: ServingEngine(teng, journal_dir=str(tmp_path / "t"), **kw))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, TTINY.vocab_size, int(rng.integers(4, 14)), dtype=np.int32)
               for _ in range(2)]
    c = _client(client, _serve(server, rep), "x")
    try:
        got = _drive(c, prompts)
        for toks, p in zip(got, prompts):
            want = np.asarray(teng.generate(p[None, :], max_new_tokens=6))[0]
            np.testing.assert_array_equal(np.asarray(toks), want)
        # fill the queue (max_queue 2): the third submit is refused
        c.submit(prompts[0], max_new_tokens=6)
        c.submit(prompts[1], max_new_tokens=6)
        with pytest.raises(Exception) as ei:
            c.submit(prompts[0], max_new_tokens=6)
        assert type(ei.value).__name__ in ("ServingQueueFull", "ServingOverloaded")
        assert type(ei.value).__module__.startswith(
            "deepspeed_tpu_torch" if client == "port" else "deepspeed_tpu.")
        assert c.alive()  # a wire exception is not a dead peer
    finally:
        c.close()


@pytest.mark.parametrize("exc_name", ["ServingQueueFull", "ServingOverloaded",
                                      "ServingDraining", "TenantThrottled",
                                      "ReplicaDeadError", "ValueError"])
def test_exceptions_cross_packages_by_name(exc_name):
    """A refusal raised by a JAX replica reaches a port client as the
    port's class of the same name, and the reverse."""
    from deepspeed_tpu.serving.frontdoor import transport as jt

    for raiser, client in ((jt.WIRE_EXCEPTIONS, "port"), (None, "jax")):
        table = raiser if raiser is not None else {
            "ServingQueueFull": ServingQueueFull, "ServingOverloaded": ServingOverloaded,
            "ServingDraining": ServingDraining, "TenantThrottled": TenantThrottled,
            "ReplicaDeadError": ReplicaDeadError, "ValueError": ValueError}
        cls = table[exc_name]
        err = cls("refused", retry_after=3.0) if issubclass(
            cls, table["ServingQueueFull"]) else cls("refused")
        rep = _FakeReplica(submit_raises=err)
        c = _client(client, _serve("jax" if client == "port" else "port", rep), "f")
        try:
            with pytest.raises(Exception) as ei:
                c.submit(np.asarray([1, 2], np.int32))
            assert type(ei.value).__name__ == exc_name
            if exc_name not in ("ReplicaDeadError", "ValueError"):
                assert ei.value.retry_after == 3.0
        finally:
            c.close()


# ---------------------------------------------------------------------------
# a child process killed by DS_FAULT_PLAN
# ---------------------------------------------------------------------------

def test_process_transport_sigkill_and_replay(engines, tmp_path):
    """``ProcessTransport`` over ``tools/fleet_chaos.py --replica``: the
    child dies to ``DS_FAULT_PLAN`` at its 2nd decode; the parent sees
    ``ReplicaDeadError`` and rc -9; ``restart()`` respawns over the same
    journal and replays exactly the submitted ids, which drain to solo
    ``generate()``'s tokens."""
    from deepspeed_tpu_torch.resilience.faults import plan_json
    from deepspeed_tpu_torch.serving.frontdoor.transport import ProcessTransport
    from deepspeed_tpu_torch.tools import fleet_chaos

    _, teng = engines
    # the child's CPU engine: fleet_chaos.make_inference (seed 7, wpe x 40)
    ref = fleet_chaos.make_inference("cpu")
    argv = [sys.executable, fleet_chaos.__file__, "--replica", "--name", "p0",
            "--device", "cpu", "--journal", str(tmp_path / "journal")]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    plan = plan_json([{"site": "serving.decode", "action": "sigkill", "after": 1}])
    rep = TransportReplica("p0", ProcessTransport("p0", argv, fault_plan=plan, env=env))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, TTINY.vocab_size, 6, dtype=np.int32) for _ in range(2)]
    try:
        rids = [rep.submit(p, max_new_tokens=5) for p in prompts]
        with pytest.raises(ReplicaDeadError):
            for _ in range(50):
                rep.step()
        assert not rep.alive() and rep.first_rc == -9
        assert sorted(rep.restart()) == sorted(rids)
        out = {}
        while rep.has_work():
            rep.step()
            out.update(rep.pop_results())
        out.update(rep.pop_results())
        for rid, p in zip(rids, prompts):
            want = np.asarray(ref.generate(p[None, :], max_new_tokens=5))[0]
            np.testing.assert_array_equal(np.asarray(out[rid].tokens()), want)
        assert rep.first_rc == -9 and rep.alive()
    finally:
        rep.close()
    assert rep.transport.proc.poll() is not None  # reaped
