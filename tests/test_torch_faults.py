"""The fault plane on the port's serving path (``runtime/faults.py`` and its
sites in the batcher), against the JAX package's, on the CPU.

- The grammar: the same specs parse to the same rules in both stacks
  (``describe`` round-trips), windows and tags fire alike, ``raise`` and
  ``stall`` apply themselves.  A strict parse accepts every site the port
  wires (each a site of the reference's registry, with its name) and
  refuses the reference's sites of parts not ported yet by name, and
  unknown ones.
- Batcher drills, each held to the reference batcher under the same rule
  (streams and firing counts) or to the undisturbed run: a crash at
  ``batcher.decode`` / ``batcher.admit`` / ``batcher.preempt`` propagates
  and the respawn (sharing the plane: the rule stays fired) serves the
  request exactly; ``batcher.page_alloc:exhaust`` back-pressures, then
  serves; the ``batcher.mixed_step`` and ``batcher.spec_verify`` raise and
  stall drills; ``kv.swap_out`` / ``kv.swap_in`` drop and corrupt fall
  back to exact recompute; ``kv.spill`` drop and corrupt degrade toward a
  cold prefill with the same tokens.
- The served engine: a decode crash respawns the batcher, re-admits the
  zero-streamed requests (streams equal an undisturbed run) and fails the
  partly streamed ones with the structured ``engine_error``; a crash on
  every chunk exhausts the retry budget; a stall flips ``/healthz`` to
  unhealthy and back; ``dlt-serve-torch --fault`` (repeatable) parses
  strictly before the engine builds and the supervisor's respawn keeps the
  plane; ``InferenceEngine.continuous_batcher`` takes ``faults=`` and
  parses ``runtime.faults`` strictly.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import asyncio
import json
import time

import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import faults as JF
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JTok
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import faults as TF
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights
from test_torch_serving import _post

TOK = ByteTokenizer()
STORM = [([7, 1, 9, 2], 44), ([4, 4, 4, 4], 44), ([9, 8, 7, 3], 44)]
SHARED = list(range(40, 60)) + [3] * 5  # 25 tokens: 3 full pages of 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def make(mod, w, faults=None, **kw):
    kw = {"batch_slots": 2, "max_len": 96, "chunk_steps": 4,
          "paged_pages": 13, "page_size": 16, "eos_id": TOK.eos_id,
          "pad_id": TOK.pad_id, **kw}
    if mod is jb:
        kw.pop("overlap", None)
        return jb.ContinuousBatcher(w[0], w[2], tokenizer=JTok(),
                                    faults=faults, **kw)
    return tb.ContinuousBatcher(w[1], w[3], tokenizer=TOK, faults=faults,
                                **kw)


def undisturbed(w, prompt, n, **kw):
    b = make(tb, w, **kw)
    rid = b.submit(prompt, max_new_tokens=n)
    return b.run()[rid]


# -- the grammar ----------------------------------------------------------------

SPECS = ["batcher.decode:raise@3,batcher.page_alloc/grow:exhaust@2+,"
         "batcher.decode:stall@1:0.5,kv.spill/out:corrupt@*",
         "batcher.mixed_step/prefill:raise@1", "kv.swap_in:drop@2"]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_as_the_reference(spec):
    got, want = TF.FaultPlane.parse(spec), JF.FaultPlane.parse(spec)
    assert got.describe() == want.describe()
    assert [(r.site, r.tag, r.action, r.first, r.last, r.arg)
            for r in got.rules] == [(r.site, r.tag, r.action, r.first,
                                     r.last, r.arg) for r in want.rules]
    again = TF.FaultPlane.parse(got.describe(), strict=True)
    assert again.describe() == got.describe()
    assert TF.FaultPlane.parse(None).rules == []
    assert TF.FaultPlane.parse(" ").rules == []


@pytest.mark.parametrize("bad", ["decode", "decode:explode", "decode:raise@0",
                                 "decode:stall@1", ":raise",
                                 "decode:delay@2"])
def test_malformed_rules_raise(bad):
    with pytest.raises(ValueError):
        TF.FaultPlane.parse(bad)


def test_fire_windows_tags_and_self_applied_actions():
    plane = TF.FaultPlane.parse("s:drop@2,s/T:drop@1+")
    assert plane.fire("s") is None
    assert plane.fire("s").action == "drop"
    assert plane.fire("s") is None
    assert plane.fire("s", tag="T").action == "drop"
    assert plane.fire("s", tag="X") is None
    assert plane.rules[1].fired == 1
    rule = plane.add("s", "drop", when="*")
    assert plane.fire("s").action == "drop" and rule.fired == 1
    plane = TF.FaultPlane.parse("a:raise@1,b:stall@1:0.05")
    with pytest.raises(TF.InjectedFault, match="injected fault at a"):
        plane.fire("a")
    t0 = time.perf_counter()
    assert plane.fire("b").action == "stall"
    assert time.perf_counter() - t0 >= 0.05
    assert plane.fire("b") is None
    fired0 = METRICS.get_counter("faults.fired.raise")
    with pytest.raises(TF.InjectedFault):
        TF.FaultPlane.parse("c:raise@*").fire("c")
    assert METRICS.get_counter("faults.fired.raise") == fired0 + 1


def test_strict_parse_takes_the_wired_sites_only():
    # Every site of the reference is wired in the port: the control
    # plane's and the autoscaler's came last.
    assert set(TF.FAULT_SITES) == set(JF.FAULT_SITES)
    assert TF.ACTIONS == JF.ACTIONS
    assert not hasattr(TF, "UNPORTED_SITES")
    spec = ",".join(f"{s}:raise@9" for s in TF.FAULT_SITES)
    assert len(TF.FaultPlane.parse(spec, strict=True).rules) == len(
        TF.FAULT_SITES)
    for rule in ("worker.heartbeat:drop@1", "worker.result/GENERATE:close@1+",
                 "coordinator.dispatch:drop@1", "fleet.scale_up:raise@1",
                 "fleet.scale_down/r0:drop@4"):
        assert TF.FaultPlane.parse(rule, strict=True).describe() == \
            JF.FaultPlane.parse(rule, strict=True).describe()
    with pytest.raises(ValueError, match="unknown fault site"):
        TF.FaultPlane.parse("decode:raise@1", strict=True)


# -- batcher drills -------------------------------------------------------------


@pytest.mark.parametrize("site", ["batcher.decode", "batcher.admit"])
def test_crash_propagates_and_the_respawn_serves_exactly(w, site):
    want = undisturbed(w, "hello", 8)
    plane = TF.FaultPlane.parse(f"{site}:raise@1")
    b = make(tb, w, faults=plane)
    b.submit("hello", max_new_tokens=8)
    with pytest.raises(TF.InjectedFault):
        b.run()
    b2 = b.respawn()
    assert b2.faults is plane
    b2._next_rid = b._next_rid
    rid = b2.submit("hello", max_new_tokens=8)
    assert b2.run()[rid] == want
    b2.assert_pool_consistent()
    assert plane.rules[0].fired == 1


def _drilled(mod, w, spec, reqs, **kw):
    plane = (JF if mod is jb else TF).FaultPlane.parse(spec)
    b = make(mod, w, faults=plane, **kw)
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    b.assert_pool_consistent()
    return [res[r] for r in rids], [r.fired for r in plane.rules], \
        b.preemptions


DRILLS = {
    # spec, requests, batcher knobs
    "page_alloc_exhaust": ("batcher.page_alloc:exhaust@1",
                           [("pool", 6)], {}),
    "page_alloc_grow": ("batcher.page_alloc/grow:exhaust@2",
                        STORM, dict(batch_slots=3, max_len=64,
                                    paged_pages=16)),
    "swap_out_drop": ("kv.swap_out:drop@*", STORM,
                      dict(batch_slots=3, max_len=64, paged_pages=9,
                           host_pages=16)),
    "swap_out_corrupt": ("kv.swap_out:corrupt@1", STORM,
                         dict(batch_slots=3, max_len=64, paged_pages=9,
                              host_pages=16)),
    "swap_in_drop": ("kv.swap_in:drop@1", STORM,
                     dict(batch_slots=3, max_len=64, paged_pages=9,
                          host_pages=16)),
    "swap_in_corrupt": ("kv.swap_in:corrupt@1", STORM,
                        dict(batch_slots=3, max_len=64, paged_pages=9,
                             host_pages=16)),
}


@pytest.mark.parametrize("case", list(DRILLS))
def test_drills_equal_the_reference_and_the_solo_runs(w, case):
    spec, reqs, kw = DRILLS[case]
    reqs = [(TOK.encode(p) if isinstance(p, str) else p, n) for p, n in reqs]
    fb0 = METRICS.get_counter("batcher.kv_swaps.fallback")
    got = _drilled(tb, w, spec, reqs, overlap=True, **kw)
    assert got == _drilled(jb, w, spec, reqs, **kw)
    toks, fired, preempted = got
    assert fired[0] >= 1
    assert preempted >= (case != "page_alloc_exhaust")
    for out, (ids, n) in zip(toks, reqs):
        assert out == undisturbed(w, ids, n, batch_slots=1, paged_pages=13,
                                  max_len=kw.get("max_len", 96))
    if case.startswith("swap_") and case != "swap_in_drop":
        assert METRICS.get_counter("batcher.kv_swaps.fallback") > fb0


def test_preempt_raise_drill_respawn_serves_exact(w):
    kw = dict(batch_slots=3, max_len=64, paged_pages=9)
    plane = TF.FaultPlane.parse("batcher.preempt:raise@1")
    b = make(tb, w, faults=plane, **kw)
    for ids, n in STORM:
        b.submit(ids, max_new_tokens=n)
    with pytest.raises(TF.InjectedFault):
        b.run()
    assert plane.rules[0].fired == 1
    b2 = b.respawn()
    rids = [b2.submit(ids, max_new_tokens=n) for ids, n in STORM]
    res = b2.run()
    for rid, (ids, n) in zip(rids, STORM):
        assert res[rid] == undisturbed(w, ids, n, batch_slots=1,
                                       max_len=64)
    assert b2.preemptions >= 1
    b2.assert_pool_consistent()


def _spill(mod, w, spec):
    plane = (JF if mod is jb else TF).FaultPlane.parse(spec)
    b = make(mod, w, faults=plane, batch_slots=2, max_len=96, page_size=8,
             paged_pages=17, prefix_cache=True, host_pages=32)
    r1 = b.submit(SHARED + [9, 9], max_new_tokens=12)
    first = b.run()[r1]
    for i in range(3):
        b.submit([200 + i] * 30 + [i], max_new_tokens=20)
    b.run()
    r2 = b.submit(SHARED + [9, 9], max_new_tokens=12)
    out = b.run()[r2]
    b.assert_pool_consistent()
    return first, out, b.prefix_cached_tokens[r2], [r.fired
                                                    for r in plane.rules]


@pytest.mark.parametrize("spec", ["kv.spill/out:drop@*",
                                  "kv.spill/out:corrupt@*",
                                  "kv.spill/restore:drop@1"])
def test_spill_drills_degrade_with_the_same_tokens(w, spec):
    got = _spill(tb, w, spec)
    assert got == _spill(jb, w, spec)
    first, out, cached, fired = got
    assert out == first and fired[0] >= 1
    assert cached < 24  # the evicted head was not restored from the host


def test_mixed_step_drills(w):
    long = TOK.encode("a long prompt that chunks in bites " * 2)
    seed = TOK.encode("seed an active decode row")
    ref = make(tb, w, prefill_chunk=6)
    r0 = ref.submit(seed, max_new_tokens=16)
    want = ref.run()[r0]
    plane = TF.FaultPlane.parse("batcher.mixed_step/prefill:raise@1")
    b = make(tb, w, prefill_chunk=6, faults=plane)
    b.submit(seed, max_new_tokens=16)
    b.submit(long, max_new_tokens=4)
    with pytest.raises(TF.InjectedFault):
        b.run()
    assert plane.rules[0].fired == 1
    plane = TF.FaultPlane.parse("batcher.mixed_step:stall@1:0.05")
    b = make(tb, w, prefill_chunk=6, faults=plane)
    rid = b.submit(seed, max_new_tokens=16)
    t0 = time.perf_counter()
    assert b.run()[rid] == want
    assert time.perf_counter() - t0 >= 0.05 and plane.rules[0].fired == 1
    b.assert_pool_consistent()


def test_spec_verify_drills(w):
    spec_kw = dict(draft_params=w[3], draft_cfg=w[1], spec_k=3,
                   max_len=64, paged_pages=9)
    want = undisturbed(w, [7, 1, 9], 8, **spec_kw)
    plane = TF.FaultPlane.parse("batcher.spec_verify/verify:raise@2")
    b = make(tb, w, faults=plane, **spec_kw)
    b.submit([7, 1, 9], max_new_tokens=8)
    with pytest.raises(TF.InjectedFault):
        b.run()
    assert plane.rules[0].fired == 1
    b2 = b.respawn()
    rid = b2.submit([7, 1, 9], max_new_tokens=8)
    assert b2.run()[rid] == want
    b2.assert_pool_consistent()
    plane_d = TF.FaultPlane.parse("batcher.spec_verify/draft:raise@1")
    bd = make(tb, w, faults=plane_d, **spec_kw)
    bd.submit([4, 4], max_new_tokens=4)
    with pytest.raises(TF.InjectedFault):
        bd.run()
    assert plane_d.rules[0].fired == 1
    plane_s = TF.FaultPlane.parse("batcher.spec_verify/verify:stall@1:0.05")
    bs = make(tb, w, faults=plane_s, **spec_kw)
    rid = bs.submit([7, 1, 9], max_new_tokens=8)
    t0 = time.perf_counter()
    assert bs.run()[rid] == want
    assert time.perf_counter() - t0 >= 0.05 and plane_s.rules[0].fired == 1


# -- the served engine --------------------------------------------------------------


def serve(batcher, fn, **kw):
    async def driver():
        srv = InferenceServer(batcher, model_name="tiny", host="127.0.0.1",
                              port=0, **kw)
        await srv.start()
        try:
            return await asyncio.wait_for(fn(srv.bound_port, srv), 600)
        finally:
            await srv.stop()

    return asyncio.run(driver())


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_supervisor_restart_retries_and_fails_structured(w, overlap):
    prompts = ["alpha", "bravo!", "charlie?", "delta d"]
    wants = {p: TOK.decode(undisturbed(w, p, 8)) for p in prompts}
    plane = TF.FaultPlane.parse("batcher.decode:raise@1")
    restarts0 = METRICS.get_counter("server.engine_restarts")
    retried0 = METRICS.get_counter("server.requests_retried")

    async def fn(port, srv):
        outs = await asyncio.gather(*[
            _post(port, "/v1/completions", {"prompt": p, "max_tokens": 8})
            for p in prompts])
        completed, errored = [], []
        for (status, raw), p in zip(outs, prompts):
            body = json.loads(raw)
            if status == 200:
                assert body["choices"][0]["text"] == wants[p], p
                completed.append(p)
            else:
                assert status == 500
                assert body["error"]["type"] == "engine_error", body
                assert "restarted" in body["error"]["message"]
                errored.append(p)
        assert len(completed) == 2 and len(errored) == 2
        assert METRICS.get_counter("server.engine_restarts") - restarts0 == 1
        assert METRICS.get_counter("server.requests_retried") - retried0 == 2
        assert srv.batcher.faults is plane and plane.rules[0].fired == 1
        for _ in range(100):
            if all(r.rid is None for r in srv.batcher.rows):
                break
            await asyncio.sleep(0.05)
        srv.batcher.assert_pool_consistent()
        status, raw = await _get(port, "/healthz")
        assert status == 200 and json.loads(raw)["engine_restarts"] == 1

    serve(make(tb, w, faults=plane, overlap=overlap), fn)


def test_retry_budget_exhausts_to_structured_error(w):
    plane = TF.FaultPlane.parse("batcher.decode:raise@1+")

    async def fn(port, srv):
        status, raw = await _post(port, "/v1/completions",
                                  {"prompt": "doomed", "max_tokens": 8})
        assert status == 500
        assert json.loads(raw)["error"]["type"] == "engine_error"
        assert srv._restarts >= 1

    serve(make(tb, w, faults=plane), fn, max_request_retries=1)


def test_watchdog_flips_healthz_on_stall(w):
    plane = TF.FaultPlane.parse("batcher.decode:stall@2:1.2")

    async def fn(port, srv):
        req = asyncio.create_task(_post(port, "/v1/completions",
                                        {"prompt": "wedge",
                                         "max_tokens": 16}))
        unhealthy = False
        for _ in range(100):
            status, raw = await _get(port, "/healthz")
            if status == 503 and json.loads(raw)["engine_stalled"]:
                unhealthy = True
                break
            await asyncio.sleep(0.05)
        assert unhealthy, "the watchdog never flipped /healthz"
        status, _ = await req
        assert status == 200
        for _ in range(100):
            status, _ = await _get(port, "/healthz")
            if status == 200:
                break
            await asyncio.sleep(0.05)
        assert status == 200

    serve(make(tb, w, faults=plane, overlap=False), fn,
          watchdog_timeout_s=0.3)


async def test_cli_fault_flag_arms_the_plane_strictly():
    from distributed_llms_tpu_torch.cli import serve_main

    base = ["--preset", "llama-tiny", "--device", "cpu", "--paged-pages",
            "12", "--page-size", "16", "--prefix-cache", "--slots", "2",
            "--host", "127.0.0.1", "--port", "0", "--max-len", "64"]
    with pytest.raises(ValueError, match="unknown fault site"):
        serve_main.build_server(serve_main.parser().parse_args(
            base + ["--fault", "fleet.scale:raise@1"]))
    args = serve_main.parser().parse_args(
        base + ["--fault", "batcher.decode:raise@2",
                "--fault", "kv.swap_out:drop@1"])
    server = serve_main.build_server(args)
    plane = server.batcher.faults
    assert plane.describe() == "batcher.decode:raise@2,kv.swap_out:drop@1"
    await server.start()
    try:
        status, body = await _post(server.bound_port, "/v1/completions",
                                   {"prompt": "cli drill", "max_tokens": 12})
        # The request streamed before the crash: a structured error.
        assert status == 500 and b"engine_error" in body
        assert server.batcher.faults is plane and plane.rules[0].fired == 1
        status, body = await _post(server.bound_port, "/v1/completions",
                                   {"prompt": "cli drill", "max_tokens": 12})
        assert status == 200, body
    finally:
        await server.stop()


def test_engine_takes_faults_and_parses_the_config_strictly():
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_preset(
        "llama-tiny", vocab_size=512, device="cpu",
        rt=RuntimeConfig(faults="batcher.admit:raise@1"))
    b = eng.continuous_batcher(batch_slots=2, max_len=64)
    assert b.faults.describe() == "batcher.admit:raise@1"
    assert eng.continuous_batcher(batch_slots=2, max_len=64).faults \
        is not b.faults
    plane = TF.FaultPlane.parse("batcher.decode:raise@1")
    assert eng.continuous_batcher(batch_slots=2, max_len=64,
                                  faults=plane).faults is plane
    bad = InferenceEngine.from_preset(
        "llama-tiny", vocab_size=512, device="cpu",
        rt=RuntimeConfig(faults="worker.beat:drop@1"))
    with pytest.raises(ValueError, match="unknown fault site"):
        bad.continuous_batcher(batch_slots=2, max_len=64)
