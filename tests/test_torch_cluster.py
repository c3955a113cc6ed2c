"""The port's control plane (``cluster/coordinator.py``, ``cluster/worker.py``,
``cluster/client.py``'s ``CoordinatorClient``, ``cluster/metrics_http.py``,
``cli/coordinator_main.py``, ``cli/host_main.py``) held against the JAX
package's on the CPU: real asyncio sockets on localhost.

- The control-plane frames are the reference's bytes, and a reference
  worker registers with, is placed by and serves the port's coordinator
  (and the reverse): the two planes are wire-compatible.
- The reference's coordinator/worker tests, on the port: registration,
  stable-id rejoin, heartbeat eviction provoked by ``worker.heartbeat``
  drops, retries under ``worker.result`` closes, ``worker.handle``
  raises and ``coordinator.dispatch`` drops, capacity-aware plans,
  orphan reassignment, rebalance, ``SCHEDULE_COMPUTATION`` and the
  ``SHUTDOWN`` broadcast, ``status`` and ``/metrics`` / ``/healthz`` /
  ``/status`` over HTTP.  Workers there run a stub engine, as in the
  reference.
- On a tiny store (llama-tiny width, float32, vocab 512): plan / place /
  generate through a port worker's default engine (``from_store`` on the
  CPU); the texts equal the reference engine's on the same store
  (``generate_text``) and the port batcher's (``generate_requests``,
  per-request budgets).  Exact text.
- ``dlt-coordinator-torch --local-proc 1 --device cpu`` converts a tiny
  HF checkpoint, writes the store, places it on a worker process and
  serves a piped ``batch``, with the texts of the in-process pair.
- A multi-device mesh and ``cluster.num_processes > 1`` are refused.
"""

import asyncio
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from distributed_llms_tpu.cluster import protocol as jprotocol
from distributed_llms_tpu.cluster.coordinator import Coordinator as JCoordinator
from distributed_llms_tpu.cluster.worker import WorkerHost as JWorkerHost
from distributed_llms_tpu.core.config import ClusterConfig as JClusterConfig
from distributed_llms_tpu_torch.cluster import protocol
from distributed_llms_tpu_torch.cluster.client import CoordinatorClient
from distributed_llms_tpu_torch.cluster.coordinator import Coordinator
from distributed_llms_tpu_torch.cluster.worker import (WorkerHost,
                                                       device_capabilities)
from distributed_llms_tpu_torch.core.config import (ClusterConfig, MeshConfig,
                                                    RuntimeConfig)
from distributed_llms_tpu_torch.core.observability import METRICS, Metrics
from distributed_llms_tpu_torch.runtime.faults import FaultPlane

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fast_cfg(cls=ClusterConfig, **kw):
    return cls(
        coordinator_host="127.0.0.1", coordinator_port=0,
        heartbeat_interval_s=0.2, heartbeat_timeout_s=0.6,
        connect_retry_s=0.1, connect_max_retries=3, task_timeout_s=10.0, **kw
    )


class FakeEngine:
    def generate_text(self, prompts, max_new_tokens=None):
        n = max_new_tokens or 4
        return types.SimpleNamespace(
            text=[p + "!" for p in prompts],
            generated_tokens=n * len(prompts), seconds=0.01,
            tokens_per_second=float(n * len(prompts)) / 0.01,
        )


def fake_factory(store_dir, shards, rt):
    return FakeEngine()


async def start_worker(coord, factory=fake_factory, cls=WorkerHost, **kw):
    if cls is WorkerHost:
        kw.setdefault("device", "cpu")
    w = cls("127.0.0.1", coord.port, cfg=fast_cfg(
        JClusterConfig if cls is JWorkerHost else ClusterConfig),
        engine_factory=factory, **kw)
    task = asyncio.create_task(w.run())
    for _ in range(100):
        if w.worker_id is not None:
            break
        await asyncio.sleep(0.02)
    assert w.worker_id is not None, "worker failed to register"
    return w, task


# -- the wire ------------------------------------------------------------------

@pytest.mark.parametrize("mtype", sorted(jprotocol.MESSAGE_TYPES - {"BATCH"}))
def test_frames_are_the_reference_bytes(mtype):
    assert protocol.MESSAGE_TYPES == jprotocol.MESSAGE_TYPES
    for payload in ({"worker_id": "w-0", "shards": [0, 1]},
                    {"text": ["y" * 5000], "generated_tokens": 3}):
        msg = protocol.message(mtype, payload, msg_id="abc")
        assert protocol.encode(msg) == jprotocol.encode(
            jprotocol.message(mtype, payload, msg_id="abc"))
    b = protocol.batch([protocol.message(mtype, {}),
                        protocol.message("HEARTBEAT", {})])
    assert protocol.encode(b) == jprotocol.encode(b)


@pytest.mark.parametrize("port_side", ["coordinator", "worker"])
async def test_wire_compatible_with_the_reference(port_side, tmp_path):
    """A reference worker on the port's coordinator, and a port worker on
    the reference's coordinator: register, place, generate, status."""
    if port_side == "coordinator":
        coord, wcls = Coordinator(fast_cfg()), JWorkerHost
    else:
        coord, wcls = JCoordinator(fast_cfg(JClusterConfig)), WorkerHost
    await coord.start()
    try:
        w, wt = await start_worker(coord, cls=wcls)
        assert isinstance(w, wcls) and w.worker_id in coord.workers
        coord.plan_shards(2, store_dir=str(tmp_path))
        placed = await coord.place_shards()
        assert placed[w.worker_id] == {"loaded": [0, 1],
                                       "resident": "full-model"}
        out = await coord.generate(["hello"], max_new_tokens=3)
        assert out["text"] == ["hello!"] and out["generated_tokens"] == 3
        assert coord.status()["workers"][w.worker_id]["shards"] == [0, 1]
        wt.cancel()
    finally:
        await coord.stop()


def test_device_capabilities():
    caps = device_capabilities("cpu")
    assert caps == {"platform": "cpu", "num_devices": 1, "device_kind": "cpu",
                    "process_count": 1}


@pytest.mark.parametrize("kind", ["mesh", "processes"])
def test_multi_device_and_multi_process_are_refused(kind):
    """A worker on a multi-device mesh and a multi-process host are served
    now (tests/test_torch_multihost.py runs them); what is still refused
    is a layout that cannot be joined: no coordinator address, or a mesh
    whose size is not the processes'."""
    if kind == "mesh":
        w = WorkerHost("127.0.0.1", 1, mesh_cfg=MeshConfig(data=2, model=2))
        assert w.mesh_cfg.num_devices == 4
        WorkerHost("127.0.0.1", 1, mesh_cfg=MeshConfig())  # one device: fine
    else:
        from distributed_llms_tpu_torch.cli import host_main

        args = host_main.parser().parse_args(
            ["--device", "cpu", "--override", "cluster.num_processes=2"])
        with pytest.raises(ValueError, match="distributed_coordinator"):
            asyncio.run(host_main.amain(args))
        args = host_main.parser().parse_args(
            ["--device", "cpu", "--override", "cluster.num_processes=2",
             "--override", "mesh.model=4"])
        with pytest.raises(ValueError, match="needs 4 processes"):
            asyncio.run(host_main.amain(args))


# -- the coordinator and its workers ---------------------------------------

async def test_compressed_and_batched_over_the_wire():
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", coord.port)
        big_caps = {"note": "y" * 50_000}
        await protocol.send_messages(writer, [
            protocol.message("REGISTER", {"worker_id": "b",
                                          "capabilities": big_caps}),
            protocol.message("HEARTBEAT", {}),
        ])
        ack = await protocol.receive_message(reader, timeout=5)
        assert ack["type"] == "REGISTER_ACK"
        for _ in range(50):
            if "b" in coord.workers:
                break
            await asyncio.sleep(0.02)
        assert coord.workers["b"].capabilities == big_caps
        writer.close()
    finally:
        await coord.stop()


async def test_receive_timeout_and_protocol_frame_faults():
    """close severs a request, delay stalls it, drop loses a RESULT frame:
    deterministic, through the real coordinator socket."""
    import time

    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", coord.port)
        with pytest.raises(asyncio.TimeoutError):
            await protocol.receive_message(reader, timeout=0.2)
        writer.close()
        protocol.set_fault_plane(
            FaultPlane.parse("proto.send/GET_STATUS:close@1"))
        with pytest.raises(ConnectionError, match="fault injection"):
            async with CoordinatorClient("127.0.0.1", coord.port) as c:
                await c.status()
        protocol.set_fault_plane(
            FaultPlane.parse("proto.send/GET_STATUS:delay@1:0.2"))
        t0 = time.perf_counter()
        async with CoordinatorClient("127.0.0.1", coord.port) as c:
            status = await c.status()
        assert time.perf_counter() - t0 >= 0.2 and "workers" in status
        protocol.set_fault_plane(FaultPlane.parse("proto.recv/RESULT:drop@1"))
        with pytest.raises(asyncio.TimeoutError):
            async with CoordinatorClient("127.0.0.1", coord.port) as c:
                await c.request("GET_STATUS", timeout=0.5)
    finally:
        protocol.set_fault_plane(None)
        await coord.stop()


async def test_register_heartbeat_and_eviction():
    """A `worker.heartbeat:drop@1+` rule swallows every beat of a live
    worker: the deadline eviction fires."""
    plane = FaultPlane()
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        w, wt = await start_worker(coord, faults=plane)
        assert w.worker_id in coord.workers
        assert coord.workers[w.worker_id].capabilities["platform"] == "cpu"
        await asyncio.sleep(0.9)  # heartbeats keep it past the timeout
        assert w.worker_id in coord.workers
        ev0 = METRICS.get_counter("coordinator.evictions")
        rule = plane.add("worker.heartbeat", "drop", when="1+")
        for _ in range(200):
            if w.worker_id not in coord.workers:
                break
            await asyncio.sleep(0.05)
        assert w.worker_id not in coord.workers and rule.fired >= 1
        assert METRICS.get_counter("coordinator.evictions") == ev0 + 1
        wt.cancel()
    finally:
        await coord.stop()


async def _register(coord, wid, caps=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", coord.port)
    await protocol.send_message(writer, protocol.message(
        "REGISTER", {"worker_id": wid, "capabilities": caps or {}}))
    ack = await protocol.receive_message(reader, timeout=5)
    assert ack["type"] == "REGISTER_ACK" and ack["payload"]["worker_id"] == wid
    return reader, writer


async def test_stable_id_reregistration_and_rejoin_replaces_shards(tmp_path):
    coord = Coordinator(dataclasses.replace(fast_cfg(),
                                            heartbeat_timeout_s=60.0))
    await coord.start()
    try:
        r1, w1 = await _register(coord, "pod-0")
        old = coord.workers["pod-0"]
        coord.plan_shards(2, store_dir=str(tmp_path))
        place = asyncio.create_task(coord.place_shards())
        msg = await protocol.receive_message(r1, timeout=5)
        assert msg["type"] == "PLACE_SHARDS"
        await protocol.send_message(w1, protocol.message(
            "RESULT", {"loaded": [0, 1], "resident": "x"},
            msg_id=msg["msg_id"]))
        await place
        # Restart under the same id: the fresh registration re-places.
        r2, w2 = await _register(coord, "pod-0")
        assert coord.workers["pod-0"].writer is not old.writer
        msg2 = await protocol.receive_message(r2, timeout=5)
        assert msg2["type"] == "PLACE_SHARDS"
        assert sorted(msg2["payload"]["shards"]) == [0, 1]
        w1.close()  # the stale socket's close does not evict the fresh one
        await asyncio.sleep(0.3)
        assert "pod-0" in coord.workers
        w2.close()
        await asyncio.sleep(0.3)
        assert "pod-0" not in coord.workers
    finally:
        await coord.stop()


async def test_a_plan_racing_a_fresh_registration_places_once(tmp_path,
                                                             monkeypatch):
    """A worker listed but not yet acknowledged when the first plan is
    made is no rejoin: it gets the one PLACE_SHARDS of place_shards, not a
    second one from its registration (on a mesh rank a second load builds
    a mesh the other ranks never join).  The acknowledgement is held back
    so that the plan lands inside the registration's await."""
    send = protocol.send_message

    async def slow_ack(writer, msg):
        if msg["type"] == "REGISTER_ACK":
            await asyncio.sleep(0.3)
        await send(writer, msg)

    monkeypatch.setattr(protocol, "send_message", slow_ack)
    coord = Coordinator(dataclasses.replace(fast_cfg(),
                                            heartbeat_timeout_s=60.0))
    await coord.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       coord.port)
        await send(writer, protocol.message(
            "REGISTER", {"worker_id": "pod-0", "capabilities": {}}))
        while "pod-0" not in coord.workers:
            await asyncio.sleep(0.01)
        coord.plan_shards(2, store_dir=str(tmp_path))
        place = asyncio.create_task(coord.place_shards())
        kinds = []
        while True:
            try:
                msg = await protocol.receive_message(reader, timeout=1.0)
            except asyncio.TimeoutError:
                break
            kinds.append(msg["type"])
            if msg["type"] == "PLACE_SHARDS":
                await send(writer, protocol.message(
                    "RESULT", {"loaded": [0, 1], "resident": "x"},
                    msg_id=msg["msg_id"]))
        assert sorted(kinds) == ["PLACE_SHARDS", "REGISTER_ACK"]
        assert (await place)["pod-0"]["loaded"] == [0, 1]
        writer.close()
    finally:
        await coord.stop()


async def test_plan_place_generate_roundtrip(tmp_path):
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        w, wt = await start_worker(coord)
        coord.plan_shards(2, store_dir=str(tmp_path))
        assert set(coord.shard_assignment) == {0, 1}
        placed = await coord.place_shards()
        assert placed[w.worker_id]["loaded"] == [0, 1]
        out = await coord.generate(["hello"], max_new_tokens=3)
        assert out["text"] == ["hello!"]
        wt.cancel()
    finally:
        await coord.stop()


async def test_task_retry_on_worker_death(tmp_path):
    """The first worker's `worker.result/GENERATE:close@1` severs its
    connection at the answer: evicted, and the task retried on the
    survivor."""
    calls = []

    def factory(store_dir, shards, rt):
        calls.append(shards)
        return FakeEngine()

    victim = FaultPlane.parse("worker.result/GENERATE:close@1", strict=True)
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        r0 = METRICS.get_counter("coordinator.tasks_retried")
        w1, t1 = await start_worker(coord, factory=factory,
                                    rt=RuntimeConfig(), faults=victim)
        w2, t2 = await start_worker(coord, factory=factory)
        coord.plan_shards(2, store_dir=str(tmp_path))
        await coord.place_shards()
        assert len(calls) == 2
        out = await asyncio.wait_for(coord.generate(["x"], max_new_tokens=2),
                                     timeout=15)
        assert out["text"] == ["x!"] and victim.rules[0].fired == 1
        assert w1.worker_id not in coord.workers
        assert METRICS.get_counter("coordinator.tasks_retried") >= r0 + 1
        for t in (t1, t2):
            t.cancel()
    finally:
        await coord.stop()


async def test_task_retry_on_injected_handler_fault(tmp_path):
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        plane = FaultPlane.parse("worker.handle/GENERATE:raise@1",
                                 strict=True)
        e0 = METRICS.get_counter("worker.errors")
        w, wt = await start_worker(coord, faults=plane)
        coord.plan_shards(1, store_dir=str(tmp_path))
        await coord.place_shards()
        out = await asyncio.wait_for(coord.generate(["y"], max_new_tokens=2),
                                     timeout=15)
        assert out["text"] == ["y!"] and plane.rules[0].fired == 1
        assert w.worker_id in coord.workers  # a handler crash, not a death
        assert METRICS.get_counter("worker.errors") == e0 + 1
        wt.cancel()
    finally:
        await coord.stop()


async def test_dispatch_drop_times_out_submitter_then_retry_lands(tmp_path):
    plane = FaultPlane.parse("coordinator.dispatch/GENERATE:drop@1",
                             strict=True)
    coord = Coordinator(fast_cfg(), faults=plane)
    await coord.start()
    try:
        w, wt = await start_worker(coord)
        coord.plan_shards(1, store_dir=str(tmp_path))
        await coord.place_shards()
        with pytest.raises(asyncio.TimeoutError):
            await coord.generate(["z"], max_new_tokens=2, timeout=1.0)
        assert plane.rules[0].fired == 1
        out = await asyncio.wait_for(coord.generate(["z"], max_new_tokens=2),
                                     timeout=15)
        assert out["text"] == ["z!"] and w.worker_id in coord.workers
        wt.cancel()
    finally:
        await coord.stop()


async def test_schedule_computation_and_shutdown_broadcast(tmp_path):
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        w, wt = await start_worker(coord)
        coord.plan_shards(1, store_dir=str(tmp_path))
        await coord.place_shards()
        out = await asyncio.wait_for(coord.schedule_computation(
            {"prompts": ["z"], "max_new_tokens": 2}), timeout=15)
        assert out["text"] == ["z!"]
        replies = await asyncio.wait_for(coord.shutdown_workers(), timeout=15)
        assert replies == {w.worker_id: {"ok": True}}
        await asyncio.wait_for(wt, timeout=10)  # the run loop exits
    finally:
        await coord.stop()


async def test_generate_without_placement_errors_then_retries_exhaust():
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        f0 = METRICS.get_counter("coordinator.tasks_failed")
        w, wt = await start_worker(coord)
        with pytest.raises(RuntimeError, match="failed after"):
            await coord.generate(["x"])
        assert METRICS.get_counter("coordinator.tasks_failed") == f0 + 1
        with pytest.raises(ValueError, match="max_new_tokens"):
            await coord.generate_requests([{"prompt": "a",
                                            "max_new_tokens": True}])
        wt.cancel()
    finally:
        await coord.stop()


async def test_capacity_aware_plan():
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        _, w1 = await _register(coord, "big", {"num_devices": 3})
        _, w2 = await _register(coord, "small", {"num_devices": 1})
        plan = coord.plan_shards(4)
        assert sorted(plan.values()) == ["big", "big", "big", "small"]
        plan_rr = coord.plan_shards(4, policy="round_robin")
        assert sorted(plan_rr.values()) == ["big", "big", "small", "small"]
        with pytest.raises(ValueError, match="unknown policy"):
            coord.plan_shards(4, policy="random")
        w1.close(), w2.close()
    finally:
        await coord.stop()


async def test_eviction_reassigns_shards(tmp_path):
    calls = []

    def factory(store_dir, shards, rt):
        calls.append(shards)
        return FakeEngine()

    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        w1, t1 = await start_worker(coord, factory=factory)
        w2, t2 = await start_worker(coord, factory=factory)
        coord.plan_shards(4, store_dir=str(tmp_path))
        await coord.place_shards()
        assert len(calls) == 2
        t1.cancel()  # dies silently -> deadline eviction
        for _ in range(100):
            await asyncio.sleep(0.05)
            if (w1.worker_id not in coord.workers
                    and set(coord.shard_assignment.values()) == {w2.worker_id}
                    and len(calls) >= 3):
                break
        assert set(coord.shard_assignment.values()) == {w2.worker_id}
        assert sorted(calls[-1]) == [0, 1, 2, 3]  # the survivor re-placed all
        t2.cancel()
    finally:
        await coord.stop()


async def test_rebalance_after_join(tmp_path):
    calls = []

    def factory(store_dir, shards, rt):
        calls.append(shards)
        return FakeEngine()

    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        w1, t1 = await start_worker(coord, factory=factory)
        with pytest.raises(RuntimeError, match="plan_shards first"):
            await coord.rebalance()
        coord.plan_shards(4, store_dir=str(tmp_path))
        await coord.place_shards()
        w2, t2 = await start_worker(coord, factory=factory)
        plan = await coord.rebalance()
        per = {}
        for s, wid in plan.items():
            per.setdefault(wid, []).append(s)
        assert sorted(per) == sorted([w1.worker_id, w2.worker_id])
        assert sorted(len(v) for v in per.values()) == [2, 2]
        assert coord.status()["workers"][w2.worker_id]["shards"] == \
            sorted(per[w2.worker_id])
        t1.cancel(), t2.cancel()
    finally:
        await coord.stop()


async def test_status_and_metrics_client():
    coord = Coordinator(fast_cfg())
    await coord.start()
    try:
        w, wt = await start_worker(coord)
        async with CoordinatorClient("127.0.0.1", coord.port) as c:
            status = await c.status()
            assert w.worker_id in status["workers"]
            assert status["queued_tasks"] == 0 and status["num_shards"] == 0
            assert "counters" in await c.metrics()
        wt.cancel()
    finally:
        await coord.stop()


async def test_worker_connect_retry_fails_cleanly():
    w = WorkerHost("127.0.0.1", 1, cfg=fast_cfg())  # port 1: nothing there
    with pytest.raises(ConnectionError, match="could not reach"):
        await w.run()


# -- /metrics, /healthz, /status ----------------------------------------------

def test_prometheus_text_rendering():
    m = Metrics()
    m.inc("coordinator.tasks_completed", 3)
    m.set_gauge("coordinator.workers", 2)
    for v in (0.1, 0.2, 0.3):
        m.observe("hop.latency_s", v)
    text = m.prometheus_text()
    assert "# TYPE coordinator_tasks_completed counter" in text
    assert "coordinator_tasks_completed 3.0" in text
    assert "# TYPE coordinator_workers gauge" in text
    assert "coordinator_workers 2" in text
    assert 'hop_latency_s{quantile="0.50"} 0.2' in text
    assert "hop_latency_s_count 3" in text and text.endswith("\n")


async def _http_get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.decode().partition("\r\n\r\n")
    lines = head.split("\r\n")
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split()[1]), headers, body


async def test_coordinator_metrics_scrape():
    coord = Coordinator(ClusterConfig(coordinator_host="127.0.0.1",
                                      coordinator_port=0, metrics_port=0))
    await coord.start()
    try:
        assert coord.metrics_port is not None
        METRICS.inc("scrape.test_counter")
        code, headers, body = await _http_get(coord.metrics_port, "/metrics")
        assert code == 200 and "scrape_test_counter" in body
        assert headers["content-type"].startswith("text/plain; version=0.0.4")
        assert await _http_get(coord.metrics_port, "/healthz") == (
            200, {"content-type": "text/plain", "content-length": "3",
                  "connection": "close"}, "ok\n")
        code, headers, body = await _http_get(coord.metrics_port, "/status")
        assert code == 200 and headers["content-type"] == "application/json"
        status = json.loads(body)
        assert status["workers"] == {} and status["queued_tasks"] == 0
        assert (await _http_get(coord.metrics_port, "/nope"))[0] == 404
    finally:
        await coord.stop()


async def test_metrics_server_edges():
    """Disabled by default; an idle client does not hold up shutdown; an
    oversized request line closes quietly."""
    coord = Coordinator(ClusterConfig(coordinator_host="127.0.0.1",
                                      coordinator_port=0))
    await coord.start()
    assert coord.metrics_port is None
    await coord.stop()
    coord = Coordinator(ClusterConfig(coordinator_host="127.0.0.1",
                                      coordinator_port=0, metrics_port=0))
    await coord.start()
    reader, writer = await asyncio.open_connection("127.0.0.1",
                                                   coord.metrics_port)
    writer.write(b"GET /" + b"x" * 70_000)
    await writer.drain()
    writer.write(b" HTTP/1.1\r\n\r\n")
    await writer.drain()
    body = await asyncio.wait_for(reader.read(), timeout=5.0)
    assert body == b"" or b"414" in body
    writer.close()
    _, idle = await asyncio.open_connection("127.0.0.1", coord.metrics_port)
    try:
        await asyncio.wait_for(coord.stop(), timeout=3.0)
    finally:
        idle.close()


# -- a real store ---------------------------------------------------------------

PROMPTS = ["the quick brown fox", "a", "serving traffic at all hours",
           "dock four"]
BUDGETS = [6, 3, 9, 4]


@pytest.fixture(scope="module")
def tiny_store(tmp_path_factory):
    from distributed_llms_tpu_torch.checkpoint.store import save_shards

    from test_torch_overlap import numpy_weights

    _, cfg_t, _, params_t = numpy_weights()
    out = tmp_path_factory.mktemp("store")
    save_shards(params_t, str(out), num_shards=2, model_config=cfg_t)
    return str(out)


def _batcher_texts(store, rt):
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_store(store, rt=rt, device="cpu")
    b = eng.continuous_batcher()
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, BUDGETS)]
    res = b.run()
    return [eng.tokenizer.decode(res[r]) for r in rids]


async def test_plan_place_generate_on_a_store(tiny_store):
    """A port worker's default engine (``from_store`` on the CPU) serves
    the store: ``generate`` equals the reference engine's text on the same
    store, ``generate_requests`` the port batcher's per-request streams;
    a ``worker.result`` close is retried on a second worker."""
    from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine

    rt = RuntimeConfig(max_seq_len=64, max_decode_steps=5)
    ref = JEngine.from_store(tiny_store).generate_text(PROMPTS, 5)
    want_batch = _batcher_texts(tiny_store, rt)
    plane = FaultPlane.parse("worker.result/GENERATE:close@2", strict=True)
    coord = Coordinator(dataclasses.replace(fast_cfg(), task_timeout_s=60.0,
                                            heartbeat_timeout_s=30.0))
    await coord.start()
    try:
        workers = []
        for faults in (plane, None):  # one at a time: worker-0 is drilled
            w = WorkerHost("127.0.0.1", coord.port, cfg=fast_cfg(), rt=rt,
                           device="cpu", faults=faults)
            workers.append((w, asyncio.create_task(w.run())))
            for _ in range(200):
                if w.worker_id is not None:
                    break
                await asyncio.sleep(0.02)
        assert [w.worker_id for w, _ in workers] == ["worker-0", "worker-1"]
        coord.plan_shards(2, store_dir=tiny_store)
        placed = await coord.place_shards()
        assert sorted(p["resident"] for p in placed.values()) == [
            "full-model", "full-model"]
        out = await coord.generate(PROMPTS, max_new_tokens=5)
        assert out["text"] == ref.text
        assert out["generated_tokens"] == 5 * len(PROMPTS)
        out = await coord.generate_requests([
            {"prompt": p, "max_new_tokens": n}
            for p, n in zip(PROMPTS, BUDGETS)])
        assert out["text"] == want_batch
        assert plane.rules[0].fired == 1  # the first batch answer was cut
        assert len(coord.workers) == 1  # ... its worker evicted, retried
        for _, t in workers:
            t.cancel()
    finally:
        await coord.stop()


def test_cli_converts_places_and_serves_a_batch(tmp_path):
    """The source system's whole path on the CPU: a tiny HF checkpoint
    (``pytorch_model.bin`` + ``config.json``) -> ``init`` (convert + store)
    -> ``assign`` -> ``distribute`` on a worker PROCESS -> ``batch`` ->
    ``status``; the texts equal the port batcher's on the written store."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(model.state_dict(), ckpt / "pytorch_model.bin")
    (ckpt / "config.json").write_text(json.dumps(cfg.to_dict()))
    store = tmp_path / "store"
    script = "\n".join([
        f"init {ckpt} 2", "assign 2", "distribute", "batch",
        *(f"{n} {p}" for p, n in zip(PROMPTS, BUDGETS)), "", "status",
        "exit"]) + "\n"
    overrides = [f"checkpoint.shard_dir={store}", "runtime.max_seq_len=64",
                 "runtime.paged_pages=20", "runtime.page_size=16",
                 "runtime.prefix_cache=true", "cluster.heartbeat_timeout_s=60"]
    out = subprocess.run(
        [sys.executable, "-m", "distributed_llms_tpu_torch.cli.coordinator_main",
         "--host", "127.0.0.1", "--port", "0", "--local-proc", "1",
         "--device", "cpu", *(x for o in overrides for x in ("--override", o))],
        input=script, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert f"sharded {ckpt} -> {store} (2 shards; convert" in text
    assert "[placed in" in text and "error:" not in text, text
    lines = {}
    for line in text.splitlines():
        for i in range(len(PROMPTS)):
            tag = f"[{i}] "
            if tag in line:
                lines[i] = json.loads(line[line.index(tag) + len(tag):])
    rt = RuntimeConfig(max_seq_len=64, paged_pages=20, page_size=16,
                       prefix_cache=True)
    assert [lines[i] for i in range(len(PROMPTS))] == _batcher_texts(
        str(store), rt)
    status = json.loads(text[text.index('{\n "workers"'):].split("\n> ")[0])
    (caps,) = [w["capabilities"] for w in status["workers"].values()]
    assert caps["platform"] == "cpu" and status["num_shards"] == 2
