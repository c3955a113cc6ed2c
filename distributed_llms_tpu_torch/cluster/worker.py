"""Worker host of the control plane (PyTorch port of
``distributed_llms_tpu/cluster/worker.py``): connects to the coordinator,
registers with its device capabilities, heartbeats, and runs the
coordinator's commands against a local engine.

- ``PLACE_SHARDS`` builds the engine from the shard store
  (``InferenceEngine.from_store`` on the worker's device, off the event
  loop); no tensor crosses the socket.  A single-device engine loads the
  whole model; the assignment says which worker answers for which shards.
- ``UNLOAD_SHARDS`` drops it; ``SHUTDOWN`` stops the worker.
- ``GENERATE`` / ``SCHEDULE_COMPUTATION`` run ``generate_text`` on a batch
  of prompts, or, with a ``requests`` list, a mixed-budget batch through
  the engine's continuous batcher (per-request budgets); a pipelined or
  sequence-parallel mesh, whose decode schedule batches for itself,
  serves that batch as one ``generate_text`` at the longest budget, each
  row cut to its own budget and at its first EOS.
- Heartbeats ride one asyncio task; connecting retries with a delay.

Fault sites (runtime/faults.py): ``worker.heartbeat`` (``drop`` skips a
beat), ``worker.handle`` (``raise`` fails a command: an ERROR reply the
coordinator retries), ``worker.result`` (``drop`` loses the reply,
``close`` severs the connection at the answer), tag = command type.

A worker serves one device, or one rank of a data x pipeline x tensor x
sequence-parallel mesh (``mesh_cfg`` with more than one device): every
process of the mesh joins
one ``torch.distributed`` group first (``cluster/distributed.py``), builds
its rank's shard of the store at ``PLACE_SHARDS`` and reports the group's
size as ``process_count``, so the coordinator dispatches every generate
to all of them at once (``Coordinator.generate_spmd``) and each rank runs
it in lockstep.  Engine commands run one at a time.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

import torch

from ..core.config import ClusterConfig, MeshConfig, RuntimeConfig
from ..core.device import resolve_device
from ..core.observability import METRICS, get_logger
from . import protocol

log = get_logger("worker")


def process_count() -> int:
    """The processes of this worker's runtime: the ``torch.distributed``
    group's size, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def device_capabilities(device: "str | torch.device | None" = None) -> dict:
    """What a worker registers with: platform ``gpu`` with the CUDA devices'
    name and count, or ``cpu`` when the worker runs there by request, and
    ``process_count``, the processes of its runtime (above 1, the
    coordinator routes every generate to all its workers at once)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {
            "platform": "gpu",
            "num_devices": torch.cuda.device_count(),
            "device_kind": torch.cuda.get_device_name(dev),
            "process_count": process_count(),
        }
    return {"platform": "cpu", "num_devices": 1, "device_kind": "cpu",
            "process_count": process_count()}


class WorkerHost:
    """Connects to the coordinator and executes control commands against
    the local engine.  ``engine_factory(store_dir, shards, rt)`` builds it
    (default: ``InferenceEngine.from_store`` on ``device``, which is CUDA
    unless the caller asks for the CPU)."""

    def __init__(
        self,
        coordinator_host: str,
        coordinator_port: int,
        cfg: ClusterConfig | None = None,
        rt: RuntimeConfig | None = None,
        engine_factory: Any = None,  # (store_dir, shards, rt) -> engine-like
        mesh_cfg: MeshConfig | None = None,
        faults: Any = None,  # FaultPlane | None (runtime/faults.py)
        device: "str | torch.device | None" = None,
    ) -> None:
        self.mesh_cfg = mesh_cfg
        self.cfg = cfg or ClusterConfig()
        self.rt = rt or RuntimeConfig()
        self.faults = faults
        self.device = device
        self.host = coordinator_host
        self.port = coordinator_port
        self.engine_factory = engine_factory or self._default_engine_factory
        self.engine = None
        self.worker_id: str | None = None
        self.loaded_shards: list[int] = []
        self._tasks: list[asyncio.Task] = []
        self._stop = asyncio.Event()
        # Engine commands one at a time: a mesh rank's collectives must run
        # in the same order on every rank.
        self._engine_lock = asyncio.Lock()

    # -- default engine: shard store -> InferenceEngine --------------------

    def _default_engine_factory(self, store_dir: str, shards: list[int],
                                rt: RuntimeConfig):
        from ..runtime.engine import InferenceEngine

        mesh = self.mesh_cfg if (self.mesh_cfg is not None
                                 and self.mesh_cfg.num_devices > 1) else None
        log.info("assigned shards %s; %s", shards,
                 "this rank loads its block of every leaf" if mesh
                 else "the single-device engine loads the full model")
        return InferenceEngine.from_store(store_dir, rt=rt, mesh_cfg=mesh,
                                          device=self.device)

    # -- lifecycle ---------------------------------------------------------

    async def run(self) -> None:
        """Connect (with retry), register, serve until stopped."""
        reader, writer = await self._connect_with_retry()
        try:
            await protocol.send_message(
                writer,
                protocol.message(
                    "REGISTER",
                    {"capabilities": device_capabilities(self.device),
                     "worker_id": self.worker_id},
                ),
            )
            ack = await protocol.receive_message(reader, timeout=10.0,
                                                 writer=writer)
            if ack["type"] != "REGISTER_ACK":
                raise protocol.ProtocolError(
                    f"expected REGISTER_ACK, got {ack['type']}")
            self.worker_id = ack["payload"]["worker_id"]
            interval = ack["payload"].get(
                "heartbeat_interval_s", self.cfg.heartbeat_interval_s
            )
            log.info("registered as %s", self.worker_id)
            hb = asyncio.create_task(self._heartbeat_loop(writer, interval))
            self._tasks.append(hb)
            try:
                await self._serve(reader, writer)
            except (asyncio.IncompleteReadError, ConnectionError):
                log.info("coordinator connection closed")
        finally:
            for t in self._tasks:
                t.cancel()
            writer.close()

    def stop(self) -> None:
        self._stop.set()

    async def _connect_with_retry(self):
        last_err: Exception | None = None
        for attempt in range(self.cfg.connect_max_retries):
            try:
                return await asyncio.open_connection(self.host, self.port)
            except OSError as e:
                last_err = e
                log.warning(
                    "connect to %s:%s failed (%s); retry %d/%d in %.1fs",
                    self.host, self.port, e, attempt + 1,
                    self.cfg.connect_max_retries, self.cfg.connect_retry_s,
                )
                await asyncio.sleep(self.cfg.connect_retry_s)
        raise ConnectionError(
            f"could not reach coordinator at {self.host}:{self.port}"
        ) from last_err

    async def _heartbeat_loop(self, writer: asyncio.StreamWriter,
                              interval: float) -> None:
        while not self._stop.is_set():
            await asyncio.sleep(interval)
            if self.faults is not None:
                # defer_stall: an event-loop site; a stall rule is awaited,
                # never slept (a blocking sleep would wedge the serve loop).
                rule = self.faults.fire("worker.heartbeat", defer_stall=True)
                if rule is not None and rule.action in ("delay", "stall"):
                    await asyncio.sleep(rule.arg or 0.0)
                if rule is not None and rule.action == "drop":
                    # The worker stays alive but its heartbeats stop: the
                    # coordinator's deadline eviction must fire.
                    continue
            try:
                await protocol.send_message(writer,
                                            protocol.message("HEARTBEAT", {}))
            except (ConnectionError, OSError):
                return

    # -- command handling --------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        while not self._stop.is_set():
            frame = await protocol.receive_message(reader, writer=writer)
            for msg in protocol.unbatch(frame):
                msg_id = msg.get("msg_id")
                try:
                    result = await self._handle(msg)
                    if msg_id is not None:
                        if self.faults is not None:
                            rule = self.faults.fire("worker.result",
                                                    tag=msg["type"],
                                                    defer_stall=True)
                            if rule is not None \
                                    and rule.action in ("delay", "stall"):
                                await asyncio.sleep(rule.arg or 0.0)
                            if rule is not None and rule.action == "drop":
                                continue  # reply lost in flight
                            if rule is not None and rule.action == "close":
                                # Die exactly at the answer: the coordinator
                                # sees EOF, evicts, and retries the task on
                                # a survivor.
                                writer.close()
                                raise ConnectionResetError(
                                    "fault injection: worker died before "
                                    "replying"
                                )
                        await protocol.send_message(
                            writer,
                            protocol.message("RESULT", result, msg_id=msg_id))
                except ConnectionError:
                    # The stream is dead: an ERROR reply could never be
                    # delivered; run()'s connection handling ends the worker.
                    raise
                except Exception as e:  # report, don't die: the coordinator retries
                    log.exception("command %s failed", msg["type"])
                    if msg_id is not None:
                        # The ERROR reply is the coordinator's retry
                        # trigger: counted, not only logged.
                        METRICS.inc("worker.errors")
                        await protocol.send_message(
                            writer,
                            protocol.message("ERROR", {"error": str(e)},
                                             msg_id=msg_id),
                        )

    async def _handle(self, msg: dict) -> Any:
        mtype = msg["type"]
        payload = msg.get("payload") or {}
        if self.faults is not None:
            # "raise" surfaces as an ERROR reply -> coordinator retry.
            rule = self.faults.fire("worker.handle", tag=mtype,
                                    defer_stall=True)
            if rule is not None and rule.action in ("delay", "stall"):
                await asyncio.sleep(rule.arg or 0.0)
        if mtype == "PLACE_SHARDS":
            store_dir = payload["store_dir"]
            shards = payload["shards"]
            # The load (store read + copy to the device) runs off the loop.
            async with self._engine_lock:
                self.engine = await asyncio.to_thread(
                    self.engine_factory, store_dir, shards, self.rt
                )
            self.loaded_shards = shards
            # What the built engine is, not what the config asked for.
            pm = getattr(self.engine, "pm", None)
            resident = (
                f"mesh({dict(pm.mesh.shape)})" if pm is not None
                else "full-model"
            )
            return {"loaded": shards, "resident": resident}
        if mtype == "UNLOAD_SHARDS":
            self.engine = None
            unloaded, self.loaded_shards = self.loaded_shards, []
            return {"unloaded": unloaded}
        if mtype in ("GENERATE", "SCHEDULE_COMPUTATION"):
            if self.engine is None:
                raise RuntimeError("no model placed (PLACE_SHARDS first)")
            async with self._engine_lock:
                if "requests" in payload:
                    return await asyncio.to_thread(
                        self._generate_requests, payload["requests"]
                    )
                res = await asyncio.to_thread(
                    self.engine.generate_text, payload["prompts"],
                    payload.get("max_new_tokens")
                )
            return {
                "text": res.text,
                "generated_tokens": res.generated_tokens,
                "seconds": res.seconds,
                "tokens_per_second": res.tokens_per_second,
            }
        if mtype == "SHUTDOWN":
            self.stop()
            return {"ok": True}
        raise protocol.ProtocolError(f"unhandled command {mtype}")

    def _generate_requests(self, requests: list[dict]) -> dict:
        """A mixed-budget batch (GENERATE with a ``requests`` list): through
        the engine's continuous batcher (per-request budgets, short replies
        never wait for long ones; its shape — slots, paged pool, prefix
        cache — from the runtime config) on one device and on a data x
        tensor-parallel mesh.  A pipelined or sequence-parallel mesh,
        whose decode schedules manage their own batching, takes the
        grouped fallback: one batch at the longest budget."""
        t0 = time.perf_counter()
        prompts = [r["prompt"] for r in requests]
        budgets = [int(r.get("max_new_tokens", 32)) for r in requests]
        tok = self.engine.tokenizer
        pm = getattr(self.engine, "pm", None)
        if pm is None or not (pm.pipelined or pm.seq_parallel):
            batcher = self.engine.continuous_batcher()
            rids = [batcher.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, budgets)]
            results = batcher.run()
            rows = [results[r] for r in rids]
        else:
            res = self.engine.generate_text(prompts, max(budgets))
            # Every row decoded max(budgets) tokens: each keeps its own
            # budget and stops at its EOS (never the pad tail after it), so
            # the text and the token count are the batcher's basis.
            rows = [_emitted([int(x) for x in row[:n]], tok.eos_id)
                    for row, n in zip(res.tokens, budgets)]
        texts = [tok.decode(row) for row in rows]
        n_gen = sum(len(row) for row in rows)
        dt = time.perf_counter() - t0
        return {
            "text": texts,
            "generated_tokens": n_gen,
            "seconds": dt,
            "tokens_per_second": n_gen / max(dt, 1e-9),
        }


def _emitted(row: list, eos_id: int | None) -> list:
    """``row`` up to and including its first ``eos_id``."""
    if eos_id is not None and eos_id in row:
        return row[:row.index(eos_id) + 1]
    return row
