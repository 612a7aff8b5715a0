"""The port's HTTP front door (``deepspeed_tpu_torch.serving.frontdoor.http``)
on the CPU, a mirror of ``tests/test_frontdoor_http.py`` held against the
JAX package: blocking and chunked streaming answers that match each other
and the JAX ``FrontDoor``'s for the same weights; 400, 404 and 413-style
oversize refusals; 429 for a tenant throttle and for a full queue with
``Retry-After``; ``deadline_ms``; ``/healthz`` and ``/statsz``; a SIGTERM
drain in a subprocess that exits 43 after the stream completes; and
``tools/frontdoor_chaos.py`` on the CPU (kill -9 mid-stream, recovery
under the same ``client_key``, SIGTERM, the bill)."""
import dataclasses
import http.client
import json
import os
import signal

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.serving import (
    ServingDraining,
    ServingEngine,
    ServingOverloaded,
    ServingQueueFull,
)
from deepspeed_tpu_torch.serving.frontdoor.http import (
    FrontDoor,
    _retry_after_header,
    _status_for,
)
from deepspeed_tpu_torch.serving.frontdoor.tenants import TenantThrottled

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TINY = tgpt2.GPT2_TINY


def _params(seed=7):
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


@pytest.fixture(scope="module")
def eng():
    """Position-sensitive engine (wpe scaled) shared across the module."""
    return deepspeed_tpu_torch.init_inference(
        model_config=TINY, params=_params(), dtype=torch.float32, device="cpu",
        max_out_tokens=TINY.n_positions)


@pytest.fixture()
def fd(eng):
    """A started FrontDoor over a fresh 2-slot serving engine."""
    srv = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64)
    door = FrontDoor(srv).start()
    yield door
    door.close()


def _conn(door):
    return http.client.HTTPConnection(door.host, door.port, timeout=30)


def _post(door, body, conn=None):
    c = conn or _conn(door)
    c.request("POST", "/v1/generate", body=json.dumps(body).encode(),
              headers={"Content-Type": "application/json"})
    return c, c.getresponse()


def _prompt(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, TINY.vocab_size, n)]


# ---------------------------------------------------------------------------
# pure-function units (no server)
# ---------------------------------------------------------------------------

def test_retry_after_header_rounds_up_and_clamps():
    assert _retry_after_header(None) is None
    assert _retry_after_header(0.0) == "0"
    assert _retry_after_header(0.2) == "1"      # never retry early
    assert _retry_after_header(2.0) == "2"
    assert _retry_after_header(2.001) == "3"
    assert _retry_after_header(-1.5) == "0"     # clamp, not negative


def test_status_for_subclass_mapping():
    """Client-fault rejections are 429, server states are 503 — the
    exception SUBCLASS picks the code."""
    assert _status_for(ServingQueueFull("full")) == 429
    assert _status_for(TenantThrottled("slow down", retry_after=1.0)) == 429
    assert _status_for(ServingOverloaded("shed")) == 503
    assert _status_for(ServingDraining("bye")) == 503


# ---------------------------------------------------------------------------
# generate: blocking + streaming
# ---------------------------------------------------------------------------

def test_blocking_generate_roundtrip(fd):
    prompt = _prompt(seed=1)
    c, resp = _post(fd, {"prompt": prompt, "max_new_tokens": 8})
    out = json.loads(resp.read())
    assert resp.status == 200
    assert out["finish_reason"] in ("eos", "length")
    assert out["n_tokens"] == len(out["tokens"]) > 0
    # greedy decode is deterministic: a re-run bit-matches
    c2, resp2 = _post(fd, {"prompt": prompt, "max_new_tokens": 8})
    out2 = json.loads(resp2.read())
    assert out2["tokens"] == out["tokens"]
    c.close()
    c2.close()


def test_streaming_matches_blocking(fd):
    prompt = _prompt(seed=2)
    c, resp = _post(fd, {"prompt": prompt, "max_new_tokens": 8})
    blocking = json.loads(resp.read())
    c.close()

    c, resp = _post(fd, {"prompt": prompt, "max_new_tokens": 8,
                         "stream": True})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "application/jsonlines"
    first = json.loads(resp.readline())
    assert isinstance(first["request_id"], int)
    tokens, done = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        rec = json.loads(line)
        if "tokens" in rec:
            tokens.extend(rec["tokens"])
        if rec.get("done"):
            done = rec
            break
    c.close()
    assert done is not None and done["finish_reason"] in ("eos", "length")
    assert done["n_tokens"] == len(tokens)
    assert tokens == blocking["tokens"]


def test_streamed_request_retires_from_engine(fd):
    c, resp = _post(fd, {"prompt": _prompt(seed=3), "max_new_tokens": 4,
                         "stream": True})
    rid = json.loads(resp.readline())["request_id"]
    resp.read()  # drain the stream to the terminating chunk
    c.close()
    assert fd.engine.scheduler.request(rid) is None


# ---------------------------------------------------------------------------
# error mapping over the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body", [
    {"prompt": []},
    {"prompt": "not a list"},
    {"prompt": [1, "x", 3]},
    {"max_new_tokens": 4},
])
def test_bad_prompt_is_400(fd, body):
    c, resp = _post(fd, body)
    out = json.loads(resp.read())
    assert resp.status == 400 and out["type"] == "ValueError"
    c.close()


def test_non_json_body_is_400(fd):
    c = _conn(fd)
    c.request("POST", "/v1/generate", body=b"{nope")
    resp = c.getresponse()
    assert resp.status == 400
    assert json.loads(resp.read())["type"] == "ValueError"
    c.close()


def test_unknown_routes_404(fd):
    c = _conn(fd)
    c.request("GET", "/nope")
    assert c.getresponse().status == 404
    c.close()
    c, resp = _post(fd, {"prompt": [1]}, conn=None)
    resp.read()
    c.close()
    c = _conn(fd)
    c.request("POST", "/v2/other", body=b"{}")
    resp = c.getresponse()
    assert resp.status == 404
    resp.read()
    c.close()


def test_oversized_body_rejected(fd):
    fd.max_body_bytes = 64
    try:
        c, resp = _post(fd, {"prompt": list(range(1, 200))})
        assert resp.status == 400
        assert "exceeds cap" in json.loads(resp.read())["error"]
        c.close()
    finally:
        fd.max_body_bytes = 1 << 20


# ---------------------------------------------------------------------------
# Retry-After satellite at the HTTP layer
# ---------------------------------------------------------------------------

def test_tenant_throttle_is_429_with_retry_after(eng):
    """A throttled tenant answers 429 with the scheduler's retry_after
    in BOTH the Retry-After header (integer, rounded up) and the JSON
    body (exact float), plus the exception subclass name."""
    srv = ServingEngine(
        eng, num_slots=2, prefill_chunk=8, max_len=64,
        tenants={
            "enabled": True,
            # no refill: the second admit is deterministically throttled
            # no matter how long the first request took to serve
            "refill_tokens_per_second": 0.0,
            "burst_tokens": 16.0,
        },
    )
    door = FrontDoor(srv).start()
    try:
        # cost = len(prompt) + max_new = 10 <= burst 16: admitted
        c, resp = _post(door, {"prompt": _prompt(seed=4), "max_new_tokens": 4,
                               "tenant": "acme"})
        assert resp.status == 200
        resp.read()
        c.close()
        # second submit: bucket has 6 left, cost 10 → throttled
        c, resp = _post(door, {"prompt": _prompt(seed=5), "max_new_tokens": 4,
                               "tenant": "acme"})
        out = json.loads(resp.read())
        assert resp.status == 429
        assert out["type"] == "TenantThrottled"
        assert out["retry_after"] is not None and out["retry_after"] > 0
        header = resp.getheader("Retry-After")
        assert header is not None
        assert int(header) >= int(out["retry_after"])  # rounded UP
        c.close()
    finally:
        door.close()


def test_queue_full_is_429_with_retry_after(eng):
    srv = ServingEngine(eng, num_slots=1, prefill_chunk=8, max_len=64,
                        max_queue=1, slo_ttft_ms=0)
    door = FrontDoor(srv).start(pump=False)  # no pump: queue stays put
    try:
        rejected = None
        for seed in range(10, 20):
            c, resp = _post(door, {"prompt": _prompt(seed=seed),
                                   "max_new_tokens": 4, "stream": True})
            if resp.status != 200:
                rejected = (resp.status, json.loads(resp.read()),
                            resp.getheader("Retry-After"))
                c.close()
                break
            json.loads(resp.readline())  # request_id chunk; leave stream open
        assert rejected is not None, "queue never filled"
        status, out, header = rejected
        assert status in (429, 503)
        assert out["type"] in ("ServingQueueFull", "ServingOverloaded")
        if out["retry_after"] is not None:
            assert header is not None
    finally:
        door.close()


# ---------------------------------------------------------------------------
# deadline mapping
# ---------------------------------------------------------------------------

def test_deadline_ms_maps_to_scheduler_deadline(fd):
    rid = fd.submit({"prompt": _prompt(seed=6), "max_new_tokens": 8,
                     "deadline_ms": 1500})
    r = fd.engine.scheduler.request(rid)
    assert r is not None and r.deadline_seconds == pytest.approx(1.5)
    rid2 = fd.submit({"prompt": _prompt(seed=7), "max_new_tokens": 8,
                      "deadline_seconds": 2.0})
    assert fd.engine.scheduler.request(rid2).deadline_seconds == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# health + stats routes
# ---------------------------------------------------------------------------

def test_healthz_and_statsz(fd):
    c = _conn(fd)
    c.request("GET", "/healthz")
    resp = c.getresponse()
    h = json.loads(resp.read())
    assert resp.status == 200
    assert h["ok"] is True and h["draining"] is False
    assert "queue_depth" in h and "degrade_level" in h
    c.request("GET", "/statsz")
    resp = c.getresponse()
    stats = json.loads(resp.read())
    assert resp.status == 200
    assert "scheduler" in stats or "requests" in stats or stats
    c.close()


# ---------------------------------------------------------------------------
# against the JAX package's FrontDoor
# ---------------------------------------------------------------------------

def _stream(door, body):
    c, resp = _post(door, dict(body, stream=True))
    tokens = []
    while True:
        line = resp.readline()
        if not line:
            break
        rec = json.loads(line)
        tokens.extend(rec.get("tokens", []))
        if rec.get("done"):
            break
    c.close()
    return tokens


def test_tokens_equal_the_jax_frontdoors(eng):
    """The same weights behind the JAX package's ``FrontDoor`` and the
    port's: blocking and streaming answers agree across the two, and with
    solo ``generate()``."""
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.serving import ServingEngine as JServingEngine
    from deepspeed_tpu.serving.frontdoor.http import FrontDoor as JFrontDoor

    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=_params(),
                                        dtype=jnp.float32, max_out_tokens=JTINY.n_positions)
    doors = {"jax": JFrontDoor(JServingEngine(jeng, num_slots=2, prefill_chunk=8,
                                              max_len=64)).start(),
             "port": FrontDoor(ServingEngine(eng, num_slots=2, prefill_chunk=8,
                                             max_len=64)).start()}
    try:
        for seed in (21, 22, 23):
            prompt = _prompt(seed=seed, n=5 + seed % 7)
            body = {"prompt": prompt, "max_new_tokens": 8}
            got = {}
            for name, door in doors.items():
                c, resp = _post(door, body)
                got[name, "block"] = json.loads(resp.read())["tokens"]
                c.close()
                got[name, "stream"] = _stream(door, body)
            want = np.asarray(eng.generate(np.asarray([prompt]), max_new_tokens=8))[0]
            for key, toks in got.items():
                assert toks == [int(t) for t in want[len(prompt):]], key
    finally:
        for door in doors.values():
            door.close()


# ---------------------------------------------------------------------------
# process level: SIGTERM drain, and the chaos tool on the CPU
# ---------------------------------------------------------------------------

def test_sigterm_drain_exits_43_after_the_stream_completes(tmp_path):
    """A ``FrontDoor`` server child (``tools/frontdoor_chaos.py --role
    server``) gets SIGTERM after the first token chunk of a stream: the
    stream still completes with its terminating chunk, the journal
    commits, and the process exits 43."""
    from deepspeed_tpu_torch.tools import fleet_chaos, frontdoor_chaos

    proc, port = frontdoor_chaos.spawn_server("cpu", str(tmp_path), str(tmp_path / "journal"))
    try:
        prompt = _prompt(seed=31, n=8)
        conn, resp = frontdoor_chaos.post(port, {"prompt": prompt, "max_new_tokens": 40,
                                                 "stream": True, "client_key": "drain"})
        pre = []
        while not pre:
            pre.extend(json.loads(resp.readline()).get("tokens", []))
        os.kill(proc.pid, signal.SIGTERM)
        tail, _, done = frontdoor_chaos.read_stream(resp)
        conn.close()
        assert proc.wait(timeout=60) == 43
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert done
    ref = fleet_chaos.make_inference("cpu")  # the server's weights
    want = np.asarray(ref.generate(np.asarray([prompt]), max_new_tokens=40))[0]
    assert pre + tail == [int(t) for t in want[len(prompt):]]


def test_frontdoor_chaos_tool_on_the_cpu(tmp_path):
    """``tools/frontdoor_chaos.py`` at GPT2_TINY: 429 for the starved
    tenant, kill -9 mid-stream (rc -9), the same id and a full stream
    after recovery, SIGTERM -> 43 with 503 for a probe, the bill."""
    from deepspeed_tpu_torch.tools import frontdoor_chaos

    out = frontdoor_chaos.run("cpu", root=str(tmp_path))
    assert out["ok"], out["failures"]
    assert out["kill9"]["victim_rc"] == -signal.SIGKILL
    assert out["recover"]["request_id"] == out["kill9"]["request_id"]
    assert out["sigterm"]["exit_code"] == 43
    assert out["throttle"]["status"] == 429
    assert all(row["admitted"] >= 1 for row in out["accounting"].values())
