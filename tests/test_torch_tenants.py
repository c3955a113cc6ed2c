"""Tenant QoS on the port against the JAX package, on the CPU.

- ``parse_tenant_weights`` parses (and refuses) exactly what the
  reference's does, with its messages.
- ``TenantScheduler``: the same queues driven through both policies give
  the same admission order, the same virtual token counters and the same
  resident-row deferrals (weighted-fair under skew, the starvation lift,
  the row cap, the anonymous bucket, priority within a tenant).
- A tenant-weighted, row-capped batcher's temperature-0 streams (and its
  final counters) equal the reference batcher's on the same weights and
  queue.
- The gateway: ``X-Tenant`` / the ``tenant`` field, malformed ids 400, the
  token-rate quota sheds 429 with the ``Retry-After`` the reference's gate
  computes from the same ledger (the reference function run on the port's
  state under one frozen clock), the ``tenant.quota:exhaust`` drill, the
  backstop factor.
- ``dlt-serve-torch --device cpu --preset llama-tiny`` boots with the three
  tenant flags and serves a tagged request.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import asyncio
import json
import time

import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import scheduler as js
from distributed_llms_tpu.runtime import server as jserver
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import scheduler as ts
from distributed_llms_tpu_torch.runtime.faults import FaultPlane
from distributed_llms_tpu_torch.runtime.server import InferenceServer
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


# -- the policy -------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, "a:4, b:1.5", {"a": 2}, "gold:4,free:1,*:2", "a=4", "a:0",
    "a:lots", "a:inf", ":3",
])
def test_parse_tenant_weights_matches_reference(spec):
    def run(fn):
        try:
            return "ok", fn(spec)
        except ValueError as e:
            return "error", str(e)

    assert run(ts.parse_tenant_weights) == run(js.parse_tenant_weights)


class _Req:
    """A queue entry: the hooks read (rid, priority, tenant, ids,
    max_new_tokens)."""

    def __init__(self, rid, tenant=None, priority=0, prompt=10, budget=10):
        self.rid = rid
        self.priority = priority
        self.tenant = tenant
        self.ids = [0] * prompt
        self.max_new_tokens = budget


def _drive(mod, script):
    """Run one admission script through ``mod``'s TenantScheduler and
    record every decision and the counters after each step."""
    sched = mod.make_scheduler("mixed", **script["knobs"])
    reqs = {rid: _Req(rid, *args) for rid, *args in script["reqs"]}
    queue = [reqs[r] for r in script["queue"]]
    trace = []
    for op, *arg in script["ops"]:
        if op == "admit":
            got = sched.admission_order(queue)
            trace.append(None if got is None else got.rid)
            if got is not None:
                queue.remove(got)
                sched.note_admitted(got, len(got.ids) + got.max_new_tokens)
        elif op == "free":
            sched.note_freed(reqs[arg[0]], arg[1])
        elif op == "arrive":
            queue.append(reqs[arg[0]])
        trace.append(sorted(sched._vtc.items()))
        trace.append(sorted(sched._resident.items()))
    return type(sched).__name__, trace


SCRIPTS = {
    "weighted_skew": dict(
        knobs=dict(tenant_weights="gold:4,free:1"),
        reqs=[(i, "gold" if i < 3 else "free") for i in range(12)],
        queue=list(range(12)),
        ops=[("admit",), ("free", 0, 10), ("admit",), ("admit",),
             ("free", 1, 3), ("admit",), ("admit",), ("free", 3, 0),
             ("admit",), ("admit",), ("admit",)],
    ),
    "row_cap": dict(
        knobs=dict(tenant_weights="a:8,b:1", tenant_max_rows=1),
        reqs=[(0, "a"), (1, "a"), (2, "b"), (3, "b")],
        queue=[0, 1, 2, 3],
        ops=[("admit",), ("admit",), ("admit",), ("free", 0, 10),
             ("admit",), ("free", 2, 4), ("admit",), ("admit",)],
    ),
    "starvation_lift": dict(
        knobs=dict(tenant_weights="agg:1,late:1"),
        reqs=[(i, "agg") for i in range(6)] + [(6, "late"), (7, "late")],
        queue=list(range(6)),
        ops=[("admit",), ("free", 0, 10), ("admit",), ("free", 1, 10),
             ("admit",), ("arrive", 6), ("arrive", 7), ("admit",),
             ("admit",), ("admit",)],
    ),
    "anon_and_priority": dict(
        knobs=dict(tenant_weights="*:2,a:2", tenant_max_rows=2),
        reqs=[(0, "a"), (1, "a", 5), (2, None), (3, None, 1), (4, "a")],
        queue=[0, 1, 2, 3, 4],
        ops=[("admit",), ("admit",), ("admit",), ("admit",), ("admit",),
             ("free", 1, 1), ("admit",)],
    ),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tenant_scheduler_order_and_cap_match_reference(name):
    got = _drive(ts, SCRIPTS[name])
    assert got[0] == "TenantScheduler"
    assert got == _drive(js, SCRIPTS[name])


def test_make_scheduler_refusals_match_reference():
    for knobs in (dict(tenant_weights="a:1"),
                  dict(tenant_weights="a:1", speculative=True),
                  dict(tenant_max_rows=0)):
        for sched_name in ("alternate", "mixed"):
            msgs = []
            for mod in (ts, js):
                try:
                    msgs.append(type(mod.make_scheduler(
                        sched_name, **dict(knobs))).__name__)
                except ValueError as e:
                    msgs.append(str(e))
            assert msgs[0] == msgs[1], (sched_name, knobs)


# -- the batcher --------------------------------------------------------------

PROMPTS = [  # (tenant, prompt ids, budget)
    ("b", [5, 6, 7, 8, 9], 6), ("b", [11, 12], 5), ("b", [13, 14, 15], 7),
    ("a", [21, 22, 23], 6), ("b", [31], 4), ("a", [41, 42, 43, 44], 5),
    (None, [51, 52], 6), ("a", [61, 62], 3),
]


def _tenant_batcher(mod, w, **kw):
    kw = dict(batch_slots=3, max_len=64, chunk_steps=4,
              tenant_weights="a:3,b:1", tenant_max_rows=2, **kw)
    if mod is jb:
        kw.pop("overlap", None)
        return jb.ContinuousBatcher(w[0], w[2], **kw)
    return tb.ContinuousBatcher(w[1], w[3], **kw)


@pytest.mark.parametrize("mode", ["paged", "contiguous"])
def test_tenant_weighted_batcher_streams_match_reference(w, mode):
    kw = dict(paged_pages=16, page_size=16, prefix_cache=True) \
        if mode == "paged" else {}
    out = []
    for mod in (jb, tb):
        b = _tenant_batcher(mod, w, **kw)
        assert type(b.sched).__name__ == "TenantScheduler"
        order = []
        admitted = b.sched.note_admitted
        b.sched.note_admitted = lambda req, est: (order.append(req.rid),
                                                  admitted(req, est))
        rids = [b.submit(ids, max_new_tokens=n, tenant=t)
                for t, ids, n in PROMPTS]
        res = b.run()
        out.append(([res[r] for r in rids], order,
                    sorted(b.sched._vtc.items()),
                    sorted(b.sched._resident.items())))
    assert out[0] == out[1]
    # Weighted-fair, not FIFO: the anonymous bucket and tenant a (weight
    # 3) overtake b's three-deep backlog, and a's counter lets it take two
    # rows (its cap) before b's second request.
    assert out[1][1] == [6, 3, 0, 5, 7, 1, 2, 4]
    with pytest.raises(ValueError, match="tenant must be"):
        _tenant_batcher(tb, w).submit([1, 2], tenant="x" * 65)


# -- the gateway ------------------------------------------------------------

async def _post(port, body, tenant=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    hdr = f"X-Tenant: {tenant}\r\n" if tenant is not None else ""
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n{hdr}"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), headers, rest


def _server(w, **srv_kw):
    b = tb.ContinuousBatcher(
        w[1], w[3], tokenizer=TOK, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
        batch_slots=2, max_len=64, chunk_steps=4, paged_pages=12,
        page_size=16, prefix_cache=True, tenant_weights="a:3,b:1")
    return InferenceServer(b, host="127.0.0.1", port=0,
                           tenant_weights={"a": 3.0, "b": 1.0}, **srv_kw)


def _serve(server, fn):
    async def main():
        await server.start()
        try:
            return await fn(server.bound_port)
        finally:
            await server.stop()

    return asyncio.run(main())


def test_gateway_tenant_quota_matches_reference_retry_after(w, monkeypatch):
    # 1 token/s per unit weight over a 10 s window: tenant b holds 10
    # admission tokens, tenant a 30.
    server = _server(w, tenant_quota_tps=1.0)
    req = {"prompt": [5, 6, 7, 8], "max_tokens": 2}  # est 6 tokens

    async def fn(port):
        out = []
        for tenant in ("b", "b", "a", "a", "a", "a", "a", "a"):
            status, headers, body = await _post(port, req, tenant=tenant)
            out.append((tenant, status, headers.get("Retry-After")))
        # Header wins over the body field; a malformed id is a 400 with
        # the reference's message.
        status, _, body = await _post(port, {**req, "tenant": "a"},
                                      tenant="bad id")
        out.append(("bad", status, json.loads(body)["error"]["message"]))
        return out

    shed0 = METRICS.get_counter("tenant.shed.b")
    out = _serve(server, fn)
    assert [o[:2] for o in out[:8]] == [
        ("b", 200), ("b", 429), ("a", 200), ("a", 200), ("a", 200),
        ("a", 200), ("a", 200), ("a", 429)]
    assert out[8][:2] == ("bad", 400)
    assert "1-64 chars of [A-Za-z0-9._-]" in out[8][2]
    assert METRICS.get_counter("tenant.shed.b") == shed0 + 1
    # The Retry-After each 429 carried is the reference gate's answer on
    # the same ledger: replay the ledger under a frozen clock through
    # both the port's method and the reference function.
    now = time.perf_counter()
    monkeypatch.setattr(time, "perf_counter", lambda: now)
    for tenant, est in (("b", 6), ("a", 6), ("a", 30), ("b", 4)):
        mine = server._tenant_retry_after(tenant, est)
        theirs = jserver.InferenceServer._tenant_retry_after(
            server, tenant, est)
        assert mine == theirs
    assert server._tenant_retry_after("b", 6) is not None
    assert server._tenant_retry_after("b", 4) is None
    for tenant, status, hint in out[:8]:
        if status == 429:
            assert 1 <= int(hint) <= 10


def test_gateway_quota_drill_and_backstop(w):
    plane = FaultPlane.parse("tenant.quota/a:exhaust@2", strict=True)
    server = _server(w, tenant_quota_tps=1.0, tenant_backstop_x=2.0)
    server.batcher.faults = plane
    req = {"prompt": [5, 6, 7, 8], "max_tokens": 2}

    async def fn(port):
        got = []
        for tenant in ("a", "a", "a", "b", "b", "b", "b"):
            status, _, body = await _post(port, req, tenant=tenant)
            got.append((status, json.loads(body).get("error", {})
                        .get("reason") if status != 200 else None))
        return got

    got = _serve(server, fn)
    # a's second request is the drill's forced shed; b's backstop is 2x
    # its 10-token window: three 6-token requests fit in 20, a fourth
    # does not.
    assert got == [(200, None), (429, "tenant_backstop"), (200, None),
                   (200, None), (200, None), (200, None),
                   (429, "tenant_backstop")]
    assert plane.rules[0].fired == 1
    with pytest.raises(ValueError, match="tenant_backstop_x must be >= 1"):
        _server(w, tenant_backstop_x=0.5)


def test_cli_boots_with_tenant_flags():
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "24",
        "--page-size", "16", "--prefix-cache", "--slots", "2",
        "--max-len", "64", "--host", "127.0.0.1", "--port", "0",
        "--tenant-weights", "a:3,b:1", "--tenant-max-rows", "1",
        "--tenant-quota-tps", "2"])
    server = serve_main.build_server(args)
    assert type(server.batcher.sched).__name__ == "TenantScheduler"
    assert server.batcher.sched.tenant_max_rows == 1
    assert server.tenant_weights == {"a": 3.0, "b": 1.0}
    assert server.tenant_quota_tps == 2.0

    async def fn(port):
        return [await _post(port, {"prompt": "hi", "max_tokens": 3},
                            tenant="a") for _ in range(2)]

    got = _serve(server, fn)
    assert [g[0] for g in got] == [200, 200]
    with pytest.raises(ValueError, match="name:weight"):
        serve_main.build_server(serve_main.parser().parse_args([
            "--preset", "llama-tiny", "--device", "cpu",
            "--tenant-weights", "a=3"]))
