"""Front-door chaos run: a real HTTP server process streaming tokens,
killed with ``kill -9`` mid-stream, restarted over the same journal, then
drained by SIGTERM (counterpart of the repo's ``tools/frontdoor_chaos.py``).

    python -m deepspeed_tpu_torch.tools.frontdoor_chaos                 # GPT-2 124M, bf16, the card
    python -m deepspeed_tpu_torch.tools.frontdoor_chaos --device cpu    # GPT2_TINY, f32, the CPU
        [--root DIR] [--out result.json]

The server is a child process (this file with ``--role server``):
``FrontDoor(engine).serve_forever()`` over a journaled slot-pool engine
with two tenants, one of them starved; on the card GPT-2 124M at full
width in bf16 with weights drawn on the device from seed 0, on the CPU
GPT2_TINY in f32 (``fleet_chaos.make_inference``).  The parent is the
HTTP client and holds the solo ``generate()`` references.

1. The starved tenant's POST answers 429 with ``Retry-After`` and
   ``"type": "TenantThrottled"``.
2. The server carries ``DS_FAULT_PLAN`` ``{"site": "frontdoor.stream",
   "action": "sigkill"}``: the chunked response dies without its
   terminating chunk (rc -9); the client keeps the prefix it read.
3. A fresh server over the same journal recovers; re-POSTing the same
   ``client_key`` returns the original id and a full stream that extends
   the prefix and equals solo ``generate()`` (or first differs on a
   near-tie, ``fleet_chaos.first_difference``).  Then TTFT through HTTP
   (POST to the first token chunk) beside the same requests submitted to
   an engine in this process.
4. SIGTERM after the first token chunk of a new stream: the stream still
   completes, a probe POST answers 503 with ``Retry-After`` (when it
   lands before the exit), and the server exits 43.
5. ``journal_tenant_totals`` shows one admission per ``client_key`` and
   each tenant's billed tokens equal what the client read.

``run(device)`` returns ``{"ok", "failures", "launches", ...}``;
``launches`` are the recovered server's kernel launches (``/statsz``).
"""
from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KILL_AFTER_CHUNKS = 2
EXIT_DRAINED = 43


def sizes(device: str) -> Dict[str, Any]:
    if device == "cuda":
        return {"slots": 4, "chunk": 64, "max_len": 1024, "warm": 64, "prompt": 128,
                "new": 64, "drain_new": 96, "ttft_requests": 8, "ttft_prompt": (64, 256),
                "ttft_new": 16}
    return {"slots": 2, "chunk": 8, "max_len": 64, "warm": 6, "prompt": 8,
            "new": 24, "drain_new": 48, "ttft_requests": 4, "ttft_prompt": (4, 20),
            "ttft_new": 4}


def serving_block(z, journal_dir: str) -> Dict[str, Any]:
    return {"num_slots": z["slots"], "prefill_chunk": z["chunk"], "max_len": z["max_len"],
            "journal_dir": journal_dir,
            # an unlimited default bucket (rate 0 + burst 0); one tenant
            # starved to a 1-token burst for the 429 probe
            "tenants": {"enabled": True, "overrides": {
                "starved": {"refill_tokens_per_second": 0.001, "burst_tokens": 1.0}}}}


# -- the server child ---------------------------------------------------------

def run_server(args) -> None:
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.resilience import faults
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.serving.frontdoor.http import FrontDoor
    from deepspeed_tpu_torch.tools.fleet_chaos import make_inference

    faults.install_from_env(rank=0)
    srv = ServingEngine(make_inference(args.device),
                        serving_block(sizes(args.device), args.journal))
    replayed = srv.recover()
    if replayed:
        print(f"[frontdoor_chaos] server: replayed {replayed}", file=sys.stderr, flush=True)
    srv.install_watchdog()
    kernels.reset_launches()

    class CountingFrontDoor(FrontDoor):
        """``/statsz`` also reports this process's kernel launches."""

        def stats(self):
            out = super().stats()
            with self.lock:
                out["launches"] = {k: int(n) for k, n in kernels.launches().items() if n}
            return out

    fd = CountingFrontDoor(srv, host="127.0.0.1", port=0).start(pump=False)
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(fd.port))
    os.rename(tmp, args.port_file)  # atomic: the parent never reads a torn port
    fd.serve_forever()  # the pump in this thread: the drain's exit 43 unwinds here


# -- the HTTP client ------------------------------------------------------------

def wait_port(port_file: str, proc, timeout: float = 600) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                return int(f.read())
        if proc.poll() is not None:
            raise RuntimeError(f"server died during boot rc={proc.poll()}")
        time.sleep(0.05)
    raise RuntimeError("server never published its port")


def post(port: int, body: Dict[str, Any], timeout: float = 600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def read_stream(resp):
    """JSON lines off a chunked response until the terminating chunk, EOF
    or a torn connection: (tokens, request_id, done) — ``done`` False is a
    stream cut mid-flight."""
    tokens, rid, done = [], None, False
    try:
        while True:
            line = resp.readline()
            if not line:
                break
            rec = json.loads(line)
            if "request_id" in rec:
                rid = rec["request_id"]
            if "tokens" in rec:
                tokens.extend(rec["tokens"])
            if rec.get("done"):
                done = True
                break
    except (http.client.IncompleteRead, http.client.HTTPException,
            ConnectionResetError, OSError, json.JSONDecodeError):
        pass
    return tokens, rid, done


def spawn_server(device: str, root: str, journal: str, fault_plan: Optional[str] = None,
                 wait: bool = True):
    """Start a server child; with ``wait``, block until it serves and
    return ``(proc, port)``, else return ``(proc, None)`` at once
    (:func:`wait_port` then gives the port)."""
    port_file = os.path.join(root, "port")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DS_FAULT_PLAN", None)
    if fault_plan is not None:
        env["DS_FAULT_PLAN"] = fault_plan
    if os.path.exists(port_file):
        os.unlink(port_file)
    log = open(os.path.join(root, "server.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--role", "server", "--device", device,
         "--journal", journal, "--port-file", port_file],
        env=env, cwd=REPO, stdout=log, stderr=log)
    log.close()
    if not wait:
        return proc, None
    try:
        return proc, wait_port(port_file, proc)
    except Exception:
        proc.kill()
        proc.wait()
        raise


def _tail(root: str) -> str:
    try:
        with open(os.path.join(root, "server.log"), errors="replace") as f:
            return f.read()[-3000:]
    except OSError:
        return ""


def _ints(a) -> List[int]:
    return [int(t) for t in a]


# -- the run ------------------------------------------------------------------

def run(device: str = "cuda", root: Optional[str] = None) -> Dict[str, Any]:
    from deepspeed_tpu_torch.resilience.faults import plan_json
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.serving.frontdoor.tenants import journal_tenant_totals
    from deepspeed_tpu_torch.tools.fleet_chaos import (
        NEAR_TIE,
        SERVING_KERNELS,
        first_difference,
        make_inference,
        solo,
    )

    own = root is None
    root = root or tempfile.mkdtemp(prefix="frontdoor_chaos_")
    os.makedirs(root, exist_ok=True)
    if device == "cuda":
        from deepspeed_tpu_torch.ops import kernels

        kernels.build(SERVING_KERNELS)  # the server only loads what is built here
    z = sizes(device)
    t_run = time.perf_counter()
    failures: List[str] = []
    procs: List[subprocess.Popen] = []
    out: Dict[str, Any] = {"device": device, "launches": {}}

    def need(cond, msg):
        if not cond:
            failures.append(msg)
        return cond

    journal = os.path.join(root, "journal")
    tol = NEAR_TIE[device]
    armed = [{"site": "frontdoor.stream", "action": "sigkill", "after": KILL_AFTER_CHUNKS}]
    if device == "cpu":
        # GPT2_TINY decodes a whole answer within one stream poll: slow
        # each decode step so the kill lands mid-answer, as on the card
        armed.append({"site": "serving.decode", "action": "latency", "seconds": 0.01})
    t_boot = time.perf_counter()
    # the armed server boots while this process draws the references
    proc, _ = spawn_server(device, root, journal, fault_plan=plan_json(armed), wait=False)
    procs.append(proc)
    eng = None
    try:
        eng = make_inference(device)
        vocab = int(eng.model_config.vocab_size)
        rng = np.random.default_rng(0)
        warm_p = rng.integers(1, vocab, z["warm"], dtype=np.int32)
        kill_p = rng.integers(1, vocab, z["prompt"], dtype=np.int32)
        drain_p = rng.integers(1, vocab, z["prompt"], dtype=np.int32)
        lo, hi = z["ttft_prompt"]
        ttft_ps = [rng.integers(1, vocab, int(rng.integers(lo, hi + 1)), dtype=np.int32)
                   for _ in range(z["ttft_requests"])]
        want_kill = solo(eng, kill_p, z["new"])
        want_drain = solo(eng, drain_p, z["drain_new"])

        def check_tokens(label, prompt, tokens, want):
            d = first_difference(eng, len(prompt), np.concatenate([prompt, np.asarray(
                tokens, np.int32)]), want, tol)
            if d is not None:
                need(d["ok"], f"{label}: differs from solo generate() off a near-tie: {d}")
            return d

        # -- 1 + 2: the armed server: warm-up, the throttle probe, kill -9
        port = wait_port(os.path.join(root, "port"), proc)
        out["boot_s"] = time.perf_counter() - t_boot
        conn, resp = post(port, {"prompt": _ints(warm_p), "max_new_tokens": 4,
                                 "tenant": "warm", "client_key": "fd-warm"})
        warm = json.loads(resp.read())
        conn.close()
        need(warm.get("finish_reason") in ("eos", "length"), f"warm-up failed: {warm}")
        warm_tokens = len(warm.get("tokens", []))

        conn, resp = post(port, {"prompt": _ints(warm_p), "max_new_tokens": 4,
                                 "tenant": "starved"})
        throttle = {"status": resp.status, "retry_after": resp.getheader("Retry-After"),
                    "type": json.loads(resp.read()).get("type")}
        conn.close()
        need(throttle["status"] == 429 and throttle["retry_after"] is not None
             and throttle["type"] == "TenantThrottled",
             f"starved tenant: want 429 + Retry-After + TenantThrottled, got {throttle}")
        out["throttle"] = throttle

        conn, resp = post(port, {"prompt": _ints(kill_p), "max_new_tokens": z["new"],
                                 "tenant": "acme", "client_key": "fd-kill", "stream": True})
        prefix, rid1, done = read_stream(resp)
        conn.close()
        rc1 = proc.wait(timeout=120)
        need(not done and rc1 == -signal.SIGKILL,
             f"kill -9: stream done={done} rc={rc1}, want a cut stream and rc "
             f"{-signal.SIGKILL}:\n{_tail(root)}")
        out["kill9"] = {"victim_rc": rc1, "observed_prefix": len(prefix), "request_id": rid1}

        # -- 3: recover; the same client_key gives the same id and the full stream
        t0 = time.perf_counter()
        proc, port = spawn_server(device, root, journal)
        procs.append(proc)
        out["restart_s"] = time.perf_counter() - t0
        conn, resp = post(port, {"prompt": _ints(kill_p), "max_new_tokens": z["new"],
                                 "tenant": "acme", "client_key": "fd-kill", "stream": True})
        full, rid2, done = read_stream(resp)
        conn.close()
        need(done, "the stream after recovery never finished")
        need(rid2 == rid1, f"at-most-once broken: request id {rid1} -> {rid2} across the crash")
        need(full[:len(prefix)] == prefix,
             f"the replayed stream does not extend the prefix: {prefix} vs {full[:len(prefix)]}")
        d = check_tokens("the recovered stream", kill_p, full, want_kill)
        out["recover"] = {"request_id": rid2, "tokens": len(full),
                          "bit_identical": d is None, "near_tie": d}

        # TTFT through HTTP beside the engine in this process, one request at a time
        http_ttft, http_tokens = [], 0
        for i, p in enumerate(ttft_ps):
            t0 = time.perf_counter()
            conn, resp = post(port, {"prompt": _ints(p), "max_new_tokens": z["ttft_new"],
                                     "tenant": "ttft", "client_key": f"fd-ttft-{i}",
                                     "stream": True})
            first = None
            toks: List[int] = []
            while True:
                line = resp.readline()
                if not line:
                    break
                rec = json.loads(line)
                if rec.get("tokens"):
                    if first is None:
                        first = time.perf_counter() - t0
                    toks.extend(rec["tokens"])
                if rec.get("done"):
                    break
            conn.close()
            need(first is not None and len(toks) == z["ttft_new"],
                 f"TTFT request {i}: {len(toks)} tokens")
            http_ttft.append((first or 0.0) * 1e3)
            http_tokens += len(toks)
        one = ServingEngine(eng, serving_block(z, os.path.join(root, "one-journal")))
        one_ttft = []
        for p in ttft_ps:
            rid = one.submit(p, max_new_tokens=z["ttft_new"])
            while one.result(rid).first_token_time is None:
                one.step()
            r = one.result(rid)
            one_ttft.append((r.first_token_time - r.submit_time) * 1e3)
            one.drain()
        del one
        status, stats = get(port, "/statsz")
        out["launches"] = dict(stats.get("launches", {}))
        need(device == "cpu" or out["launches"].get("flash_decode", 0) > 0,
             f"flash_decode not launched in the server: {out['launches']}")
        hz, health = get(port, "/healthz")
        need(hz == 200 and health.get("ok") and not health.get("draining"),
             f"/healthz answered {hz} {health}")
        out["ttft_ms"] = {"http": http_ttft, "in_process": one_ttft,
                          "http_p50": float(np.percentile(http_ttft, 50)),
                          "in_process_p50": float(np.percentile(one_ttft, 50))}

        # -- 4: SIGTERM mid-stream: drain, 503, exit 43
        conn, resp = post(port, {"prompt": _ints(drain_p), "max_new_tokens": z["drain_new"],
                                 "tenant": "acme2", "client_key": "fd-drain", "stream": True})
        # SIGTERM must land while the request holds a slot (a queued one
        # replays from the journal instead): read to the first token delta
        pre: List[int] = []
        while not pre:
            rec = json.loads(resp.readline())
            if "tokens" in rec:
                pre.extend(rec["tokens"])
        t_term = time.perf_counter()
        os.kill(proc.pid, signal.SIGTERM)
        # the probe goes once /healthz says draining (503): sent earlier it
        # could land before the signal is handled and be admitted
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                if get(port, "/healthz")[0] == 503:
                    break
            except OSError:  # already exited
                break
            time.sleep(0.005)
        try:
            c2, r2 = post(port, {"prompt": _ints(warm_p), "max_new_tokens": 4,
                                 "tenant": "warm"}, timeout=60)
            probe = {"status": r2.status, "retry_after": r2.getheader("Retry-After")}
            try:
                probe["type"] = json.loads(r2.read()).get("type")
            except (OSError, http.client.HTTPException, ValueError) as e:
                probe["body_error"] = repr(e)  # the exit cut the body short
            c2.close()
        except (OSError, http.client.HTTPException) as e:  # the drain ended first
            probe = {"status": None, "error": repr(e)}
        tail, _, done = read_stream(resp)
        drained = pre + tail
        conn.close()
        rc2 = proc.wait(timeout=300)
        need(done, "SIGTERM cut the in-flight stream; the drain must stream it out")
        need(rc2 == EXIT_DRAINED, f"server exit rc={rc2}, expected {EXIT_DRAINED}:\n"
                                  f"{_tail(root)}")
        need(probe["status"] is None or (probe["status"] == 503
                                         and probe["retry_after"] is not None
                                         and probe.get("type", "ServingDraining")
                                         == "ServingDraining"),
             f"drain probe: want 503 + Retry-After + ServingDraining, got {probe}")
        d = check_tokens("the drained stream", drain_p, drained, want_drain)
        out["sigterm"] = {"exit_code": rc2, "tokens": len(drained), "probe": probe,
                          "term_to_exit_s": time.perf_counter() - t_term,
                          "bit_identical": d is None, "near_tie": d}

        # -- 5: per-tenant accounting reconciles with the journal
        totals = journal_tenant_totals(journal)
        observed = {"warm": (1, warm_tokens), "acme": (1, len(full)),
                    "acme2": (1, len(drained)), "ttft": (len(ttft_ps), http_tokens)}
        for tn, (n, toks) in observed.items():
            row = totals.get(tn)
            need(row is not None and row["admitted"] == n and row["billed_tokens"] == toks,
                 f"tenant {tn}: want {n} admission(s) billed {toks} token(s), the journal has "
                 f"{row}")
        out["accounting"] = {tn: totals.get(tn) for tn in observed}
    except Exception as e:  # a phase that raised fails the run, never passes over
        failures.append(f"{type(e).__name__}: {e}\n{_tail(root)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    del eng
    out["wall_s"] = time.perf_counter() - t_run
    out["failures"] = failures
    out["ok"] = not failures
    if own and not failures:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=None, help="working directory (a temp dir if absent)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    ap.add_argument("--role", default=None, choices=(None, "server"), help=argparse.SUPPRESS)
    ap.add_argument("--journal", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.role == "server":
        run_server(args)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("frontdoor_chaos: no CUDA device; pass --device cpu", file=sys.stderr)
            return 2
    out = run(args.device, args.root)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
