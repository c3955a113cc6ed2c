"""The port's HTTP gateway (``runtime/server.py``) under the JAX package's
gateway contracts (tests/runtime/test_server.py, test_overload.py and
test_faults.py), driven over a real loopback socket, some through the
port's ``ServingClient`` (``cluster/client.py``) as the reference drives
them:

- stop sequences truncate and free the row; a stop hit before the
  deadline reports ``stop``;
- ``timeout_s`` (and the server's default) answer ``timeout`` with the
  tokens so far, blocking and streamed; a request whose deadline passes
  while QUEUED sheds 503 with ``Retry-After``;
- a client that disconnects cancels its row;
- graceful drain finishes in-flight work and 503s new requests (and
  ``/healthz``); ``force_stop`` cuts it short; a request queued as the
  server stops is answered;
- ``max_pending`` back-pressure and the cost gate 429 with
  ``Retry-After``, leaving no mailbox behind;
- priority preemption over HTTP: a storm at ~2.5x the pool completes
  byte-exact or sheds structured, and the pool audits clean;
- ``ServingClient`` honours ``Retry-After`` with jittered backoff, fails
  over across endpoints without sleeping at a dead one, and validates
  its tenant id with the gateway's rule.

Every completed text equals a solo port batcher's temperature-0 text for
the prompt.  float32 on the CPU, llama-tiny width, weights drawn with
numpy (tests/test_torch_overlap.py).
"""

import asyncio
import json
import random
import time

import pytest
import torch

from distributed_llms_tpu_torch.cluster.client import ServingClient
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.faults import FaultPlane
from distributed_llms_tpu_torch.runtime.server import InferenceServer, _Mailbox
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights

TOK = ByteTokenizer()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def make_batcher(w, faults=None, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("paged_pages", 8)  # 7 usable = 112-token capacity
    kw.setdefault("page_size", 16)
    return tb.ContinuousBatcher(w[1], w[3], tokenizer=TOK, eos_id=TOK.eos_id,
                                pad_id=TOK.pad_id, faults=faults, **kw)


def expected_texts(w, reqs, finish=False):
    """Solo reference texts from a roomy, unfaulted batcher (with
    ``finish``: and each stream's finish reason, "stop" at an EOS)."""
    b = make_batcher(w, paged_pages=40, batch_slots=4)
    rids = [b.submit(p, max_new_tokens=n) for p, n in reqs]
    res = b.run()
    texts = {p: TOK.decode(res[rid]) for rid, (p, n) in zip(rids, reqs)}
    if not finish:
        return texts
    return texts, {p: ("stop" if res[rid][-1] == TOK.eos_id else "length")
                   for rid, (p, n) in zip(rids, reqs)}


async def _request(host, port, method, path, body=None):
    """Raw HTTP/1.1 request: (status, headers, body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    data = await reader.read()
    writer.close()
    return status, headers, data


def _post(host, port, body):
    return _request(host, port, "POST", "/v1/completions", body)


def run_with_server(batcher, fn, **srv_kw):
    async def drive():
        srv = InferenceServer(batcher, model_name="tiny", host="127.0.0.1",
                              port=0, **srv_kw)
        host, port = await srv.start()
        try:
            return await asyncio.wait_for(fn(host, port, srv), timeout=300)
        finally:
            await srv.stop()

    return asyncio.run(drive())


async def _until(pred, n=500, dt=0.01):
    for _ in range(n):
        if pred():
            return True
        await asyncio.sleep(dt)
    return pred()


def _rows_free(srv):
    return all(r.rid is None for r in srv.batcher.rows)


# -- stop sequences --------------------------------------------------------------

def test_stop_sequence_truncates_and_frees_row(w):
    # A 24-token budget (the reference's test uses 12): the stop character
    # must fall inside the budget on these weights.
    full = expected_texts(w, [("stopper", 24)])["stopper"]
    assert len(full) >= 2
    stop = full[len(full) // 2]
    want = full[: full.find(stop)]

    async def fn(host, port, srv):
        status, _, body = await _post(host, port, {
            "prompt": "stopper", "max_tokens": 24, "stop": stop})
        assert status == 200
        out = json.loads(body)
        assert out["choices"][0]["text"] == want
        assert out["choices"][0]["finish_reason"] == "stop"
        assert await _until(lambda: _rows_free(srv), 100, 0.05)
        assert not srv._cancelled
        srv.batcher.assert_pool_consistent()

    run_with_server(make_batcher(w, batch_slots=4), fn)


def test_stop_hit_before_deadline_reports_stop(w):
    """A stop hit followed by the deadline lapsing during the cancel's
    drain is a STOP: the response ended before the deadline."""
    want = expected_texts(w, [("halt", 8)])["halt"]
    plane = FaultPlane.parse("batcher.decode:stall@2+:1.5")

    async def fn(host, port, srv):
        status, _, raw = await _post(host, port, {
            "prompt": "halt", "max_tokens": 64, "timeout_s": 0.6,
            "stop": [want[0]]})
        assert status == 200
        assert json.loads(raw)["choices"][0]["finish_reason"] == "stop"
        assert await _until(lambda: _rows_free(srv), 100, 0.05)
        srv.batcher.assert_pool_consistent()

    run_with_server(make_batcher(w, faults=plane), fn)


# -- deadlines ----------------------------------------------------------------------

def test_request_timeout_returns_partial_and_frees_row(w):
    plane = FaultPlane.parse("batcher.decode:stall@1+:0.1")

    async def fn(host, port, srv):
        status, _, raw = await _post(host, port, {
            "prompt": "slow", "max_tokens": 64, "timeout_s": 0.25})
        assert status == 200
        out = json.loads(raw)
        assert out["choices"][0]["finish_reason"] == "timeout"
        assert 0 < out["usage"]["completion_tokens"] < 64
        assert await _until(lambda: _rows_free(srv), 100, 0.05)
        srv.batcher.assert_pool_consistent()

    run_with_server(make_batcher(w, faults=plane), fn)


def test_server_default_timeout_applies(w):
    plane = FaultPlane.parse("batcher.decode:stall@1+:0.1")

    async def fn(host, port, srv):
        status, _, raw = await _post(host, port, {"prompt": "slow",
                                                  "max_tokens": 64})
        assert status == 200
        assert json.loads(raw)["choices"][0]["finish_reason"] == "timeout"
        for bad in (0, -1, "soon", True):
            status, _, _ = await _post(host, port, {
                "prompt": "x", "max_tokens": 2, "timeout_s": bad})
            assert status == 400, bad

    run_with_server(make_batcher(w, faults=plane), fn,
                    request_timeout_s=0.25)


def test_streamed_timeout_carries_finish_reason(w):
    plane = FaultPlane.parse("batcher.decode:stall@1+:0.1")

    async def fn(host, port, srv):
        status, _, raw = await _post(host, port, {
            "prompt": "slow", "max_tokens": 64, "timeout_s": 0.25,
            "stream": True})
        assert status == 200
        finish = None
        for line in raw.split(b"\n"):
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            fr = json.loads(line[6:])["choices"][0].get("finish_reason")
            finish = fr if fr is not None else finish
        assert finish == "timeout"

    run_with_server(make_batcher(w, faults=plane), fn)


def test_timeout_of_queued_request_is_shed_503(w):
    """A deadline that passes while the request is still QUEUED sheds it
    at the next chunk boundary: 503 + Retry-After, not an empty 200."""
    plane = FaultPlane.parse("batcher.decode:stall@1+:0.05")

    async def fn(host, port, srv):
        shed0 = METRICS.get_counter("server.requests_shed_total")
        hog = asyncio.create_task(_post(host, port, {"prompt": "slot hog",
                                                     "max_tokens": 48}))
        assert await _until(lambda: srv._requests)
        t0 = time.perf_counter()
        status, headers, raw = await _post(host, port, {
            "prompt": "queued", "max_tokens": 8, "timeout_s": 0.2})
        assert status == 503, raw
        out = json.loads(raw)
        assert out["error"]["type"] == "overloaded_error"
        assert "shed" in out["error"]["message"]
        assert int(headers["retry-after"]) >= 1
        assert time.perf_counter() - t0 < 5.0
        assert METRICS.get_counter("server.requests_shed_total") > shed0
        assert (await hog)[0] == 200

    run_with_server(make_batcher(w, batch_slots=1, faults=plane), fn)


# -- disconnects, drains, shutdown --------------------------------------------

def test_client_disconnect_cancels_row(w):
    async def fn(host, port, srv):
        reader, writer = await asyncio.open_connection(host, port)
        body = json.dumps({"prompt": "bye now", "max_tokens": 100,
                           "stream": True}).encode()
        writer.write(
            f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        await reader.readline()  # the status line: generation is live
        for _ in range(6):
            await reader.readline()
        writer.close()
        await writer.wait_closed()
        # A 100-token budget ends quickly only if the cancel works.
        assert await _until(lambda: _rows_free(srv) and not srv._requests,
                            200, 0.05)
        srv.batcher.assert_pool_consistent()

    run_with_server(make_batcher(w, max_len=128, paged_pages=16), fn)


def test_graceful_drain_finishes_in_flight(w):
    async def fn(host, port, srv):
        req = asyncio.create_task(_post(host, port, {"prompt": "hello",
                                                     "max_tokens": 64}))
        assert await _until(lambda: srv._requests)
        stop = asyncio.create_task(srv.stop(drain_timeout=60.0))
        await asyncio.sleep(0)  # let stop() flip _draining
        status, _, raw = await _request(host, port, "GET", "/healthz")
        assert status == 503 and json.loads(raw)["status"] == "draining"
        status, _, body = await _post(host, port, {"prompt": "x",
                                                   "max_tokens": 2})
        assert status == 503 and b"draining" in body
        status, _, body = await req
        assert status == 200
        assert json.loads(body)["usage"]["completion_tokens"] == 64
        await stop

    run_with_server(make_batcher(w), fn)


def test_force_stop_cuts_graceful_drain_short(w):
    plane = FaultPlane.parse("batcher.decode:stall@1+:0.05")

    async def fn(host, port, srv):
        req = asyncio.create_task(_post(host, port, {"prompt": "linger",
                                                     "max_tokens": 64}))
        assert await _until(lambda: srv._requests)
        t0 = asyncio.get_running_loop().time()
        stop = asyncio.create_task(srv.stop(drain_timeout=60.0))
        await asyncio.sleep(0.05)
        assert not stop.done()
        srv.force_stop()  # the second SIGTERM
        status, _, body = await req
        await asyncio.wait_for(stop, timeout=30)
        assert asyncio.get_running_loop().time() - t0 < 30
        assert status == 200
        assert 0 < json.loads(body)["usage"]["completion_tokens"] < 64

    run_with_server(make_batcher(w, max_len=128, paged_pages=16,
                                 faults=plane), fn)


@pytest.mark.parametrize("how", ["force_stop", "stopping"])
def test_request_queued_at_shutdown_is_answered(w, how):
    """A request lands in the batcher queue just as the server stops: the
    engine's stopping drain answers its mailbox with a structured
    shutdown error instead of stranding the handler."""
    async def fn(host, port, srv):
        rid = srv.batcher.next_rid
        mbox = _Mailbox()
        srv._requests[rid] = mbox
        assert srv.batcher.submit("raced", max_new_tokens=8) == rid
        if how == "force_stop":
            srv.force_stop()
        else:
            srv._stopping = True
        srv._work.set()
        toks, done, err, _ = await asyncio.wait_for(mbox.queue.get(), 10)
        assert done and err == "server is shutting down"
        srv._requests.pop(rid, None)

    run_with_server(make_batcher(w), fn)


# -- back-pressure and the cost gate ---------------------------------------------

def test_max_pending_backpressure(w):
    async def fn(host, port, srv):
        results = await asyncio.gather(*[
            _post(host, port, {"prompt": f"req {i}", "max_tokens": 4})
            for i in range(6)])
        statuses = sorted(s for s, _, _ in results)
        assert statuses.count(200) >= 2
        assert all(s in (200, 429) for s in statuses)
        for s, headers, _ in results:
            if s == 429:
                assert int(headers["retry-after"]) >= 1

    run_with_server(make_batcher(w), fn, max_pending=2)


def test_queue_full_429_retry_after_and_no_mailbox_leak(w):
    async def fn(host, port, srv):
        status, headers, raw = await _post(host, port, {"prompt": "hello",
                                                        "max_tokens": 4})
        body = json.loads(raw)
        assert status == 429 and body["error"]["type"] == "overloaded_error"
        assert "queue is full" in body["error"]["message"]
        assert int(headers["retry-after"]) >= 1
        assert not srv._requests and not srv.batcher.queue

    run_with_server(make_batcher(w), fn, max_pending=0)


def test_cost_gate_429_retry_after_and_no_mailbox_leak(w):
    async def fn(host, port, srv):
        shed0 = METRICS.get_counter("server.requests_shed_total")
        status, headers, raw = await _post(host, port, {
            "prompt": "too big to ever fit", "max_tokens": 400})
        body = json.loads(raw)
        assert status == 429 and body["error"]["type"] == "overloaded_error"
        assert int(headers["retry-after"]) >= 1
        assert METRICS.get_counter("server.requests_shed_total") > shed0
        assert not srv._requests and not srv.batcher.queue
        status, _, _ = await _post(host, port, {"prompt": "small",
                                                "max_tokens": 4})
        assert status == 200 and not srv._requests

    run_with_server(make_batcher(w), fn, shed_cost_factor=1.0)


def test_submit_crash_does_not_strand_mailboxes(w):
    async def fn(host, port, srv):
        orig = srv.batcher.submit

        def boom(*a, **kw):
            raise RuntimeError("batcher invariant violated")

        srv.batcher.submit = boom
        try:
            await _post(host, port, {"prompt": "doomed", "max_tokens": 4})
        except (IndexError, ConnectionError, asyncio.IncompleteReadError):
            pass  # a torn connection is acceptable, a leaked mailbox not
        assert not srv._requests
        srv.batcher.submit = orig
        status, _, _ = await _post(host, port, {"prompt": "fine",
                                                "max_tokens": 4})
        assert status == 200 and not srv._requests

    run_with_server(make_batcher(w), fn)


def test_priority_field_validation(w):
    async def fn(host, port, srv):
        for bad in ("high", 1.5, True):
            status, _, raw = await _post(host, port, {
                "prompt": "x", "max_tokens": 2, "priority": bad})
            assert status == 400, (bad, raw)
        status, _, _ = await _post(host, port, {
            "prompt": "x", "max_tokens": 2, "priority": -3})
        assert status == 200

    run_with_server(make_batcher(w), fn)


def test_overload_storm_completes_or_sheds_structured(w):
    """~2.5x the pool's token capacity, a priority-5 request among them
    and a forced growth exhaustion: every request completes byte-exact
    (preemption + recompute invisible) or sheds 429/503 with Retry-After;
    never an engine_error; the pool audits clean."""
    prompts = [(f"storm request {i}", 40) for i in range(5)]
    wants, finishes = expected_texts(w, prompts, finish=True)
    plane = FaultPlane.parse("batcher.page_alloc/grow:exhaust@1")

    async def fn(host, port, srv):
        preempt0 = METRICS.get_counter("batcher.preemptions_total")
        outs = await asyncio.gather(*[
            _post(host, port, {"prompt": p, "max_tokens": n,
                               "priority": (5 if i == 0 else 0)})
            for i, (p, n) in enumerate(prompts)])
        completed = shed = 0
        for (status, headers, raw), (p, n) in zip(outs, prompts):
            body = json.loads(raw)
            if status == 200:
                assert body["choices"][0]["finish_reason"] == finishes[p]
                assert body["choices"][0]["text"] == wants[p], p
                completed += 1
            else:
                assert status in (429, 503), (status, body)
                assert body["error"]["type"] == "overloaded_error", body
                assert int(headers["retry-after"]) >= 1
                shed += 1
        assert completed >= 1 and shed >= 1
        assert outs[0][0] == 200  # the priority request is served
        assert METRICS.get_counter("batcher.preemptions_total") > preempt0
        assert await _until(lambda: _rows_free(srv), 200, 0.05)
        srv.batcher.assert_pool_consistent()
        _, _, raw = await _request(host, port, "GET", "/metrics")
        for fam in ("batcher_pool_free_pages", "batcher_pool_held_pages",
                    "batcher_preemptions_total",
                    "server_requests_shed_total"):
            assert fam in raw.decode(), fam

    run_with_server(make_batcher(w, faults=plane), fn, shed_cost_factor=1.0)


# -- ServingClient -------------------------------------------------------------------

def test_serving_client_backoff_honors_retry_after(w):
    plane = FaultPlane.parse("batcher.decode:stall@1+:0.05")
    want = expected_texts(w, [("patient", 4)])["patient"]

    async def fn(host, port, srv):
        hog = asyncio.create_task(_post(host, port, {"prompt": "hog",
                                                     "max_tokens": 48}))
        assert await _until(lambda: srv._requests)
        client = ServingClient(host, port, max_retries=60,
                               backoff_base_s=0.02, backoff_cap_s=0.2,
                               retry_after_cap_s=0.1, rng=random.Random(1))
        status, body = await client.completions({"prompt": "patient",
                                                 "max_tokens": 4})
        assert status == 200, body
        assert body["choices"][0]["text"] == want
        assert client.retries_taken >= 1
        assert client.last_shed_reason is None or isinstance(
            client.last_shed_reason, str)
        await hog

    run_with_server(make_batcher(w, faults=plane), fn, max_pending=1)


def test_serving_client_endpoint_failover_and_tenant(w):
    """A dead endpoint rotates to the live one at once (no backoff sleep
    at a severed socket); the tenant id rides X-Tenant and is validated
    by the gateway's own rule; a tenant-quota 429 is counted."""
    want = expected_texts(w, [("fail over to me", 4)])["fail over to me"]

    async def drive():
        s1 = InferenceServer(make_batcher(w), model_name="tiny",
                             host="127.0.0.1", port=0)
        s2 = InferenceServer(make_batcher(w), model_name="tiny",
                             host="127.0.0.1", port=0,
                             tenant_weights={"gold": 1.0},
                             tenant_quota_tps=6.0, tenant_rate_window_s=5.0)
        h1, p1 = await s1.start()
        h2, p2 = await s2.start()
        try:
            await s1.kill()  # endpoint 1 is a dead socket
            client = ServingClient(endpoints=[(h1, p1), (h2, p2)],
                                   max_retries=4, backoff_base_s=0.05,
                                   backoff_cap_s=0.2, tenant="gold",
                                   retry_after_cap_s=0.0,
                                   rng=random.Random(0))
            status, body = await client.completions(
                {"prompt": "fail over to me", "max_tokens": 4})
            assert status == 200, body
            assert body["choices"][0]["text"] == want
            assert client.failovers >= 1 and client.retries_taken == 0
            # gold's allowance is 6 tok/s x 5 s = 30 tokens a window, the
            # first request took 20: the next 20 sheds on the quota.
            status, body = await client.completions(
                {"prompt": "fail over to me", "max_tokens": 4})
            assert status == 429
            assert client.last_shed_reason == "tenant_quota"
            assert client.tenant_sheds >= 1
        finally:
            await s2.stop()

    asyncio.run(asyncio.wait_for(drive(), 120))
    for bad in ("-", "has space", "x" * 65, "üni"):
        with pytest.raises(ValueError, match="tenant must be"):
            ServingClient("127.0.0.1", 1, tenant=bad)
    with pytest.raises(ValueError, match="host\\+port"):
        ServingClient()
