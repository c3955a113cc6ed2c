"""Coordinator of the control plane (PyTorch port of
``distributed_llms_tpu/cluster/coordinator.py``): the master of the source
system, which converts a checkpoint into a shard store, places it on
workers and fans inference tasks out to them.

- a registry of workers with their device capabilities;
- deadline-based liveness: a worker whose heartbeats stop past
  ``heartbeat_timeout_s`` is evicted, its shards reassigned to survivors
  and its in-flight tasks retried;
- the model lifecycle: ``plan_shards`` (a capacity-weighted or
  round-robin shard -> worker assignment), ``place_shards`` (each worker
  loads its shards from the store; no tensor crosses this socket),
  ``rebalance`` after workers join or leave;
- a task queue with ids, timeouts and retries (``submit``, ``generate``,
  ``generate_requests``); the single-threaded event loop owns all of it;
- ``status`` and, with ``metrics_port``, ``/metrics`` / ``/healthz`` /
  ``/status`` over HTTP (``cluster/metrics_http.py``).

Fault site (runtime/faults.py): ``coordinator.dispatch`` (tag = task
type), consulted before each task is sent.
"""

from __future__ import annotations

import asyncio
import itertools
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from ..core.config import ClusterConfig
from ..core.observability import METRICS, get_logger
from . import protocol

log = get_logger("coordinator")


@dataclass
class WorkerInfo:
    worker_id: str
    capabilities: dict
    writer: asyncio.StreamWriter
    last_heartbeat: float
    status: str = "idle"  # idle | busy | dead
    shards: list[int] = field(default_factory=list)


@dataclass
class Task:
    task_id: str
    payload: dict
    future: asyncio.Future
    attempts: int = 0
    max_attempts: int = 3
    assigned_to: str | None = None


class Coordinator:
    def __init__(self, cfg: ClusterConfig | None = None,
                 faults: Any = None) -> None:
        # ``faults``: FaultPlane | None (runtime/faults.py).  Site
        # "coordinator.dispatch" (tag = task type): a "drop" rule models a
        # dispatch lost in flight — the task stays assigned and unanswered,
        # exercising the submitter-timeout / retry machinery without
        # wall-clock-killing a worker.
        self.cfg = cfg or ClusterConfig()
        self.faults = faults
        # The control-plane state below is confined to the asyncio event
        # loop (single-threaded by construction, so no task races).  graftlint's lock-discipline rule pins
        # the confinement: accesses must sit in async defs, or in sync
        # helpers explicitly annotated "# graftlint: holds(event-loop)"
        # (called only from coroutines / loop callbacks).
        self.workers: dict[str, WorkerInfo] = {}  # guarded-by: event-loop
        self.task_queue: asyncio.Queue[Task] = asyncio.Queue()
        self.tasks: dict[str, Task] = {}  # guarded-by: event-loop
        # shard -> worker_id
        self.shard_assignment: dict[int, str] = {}  # guarded-by: event-loop
        self.num_shards = 0
        self.store_dir: str | None = None
        self._server: asyncio.base_events.Server | None = None
        self._metrics_server = None
        self._bg: list[asyncio.Task] = []
        self._counter = itertools.count()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_connection, self.cfg.coordinator_host, self.cfg.coordinator_port
        )
        addr = self._server.sockets[0].getsockname()
        self._bg.append(asyncio.create_task(self._liveness_loop()))
        self._bg.append(asyncio.create_task(self._dispatch_loop()))
        if self.cfg.metrics_port is not None:
            from .metrics_http import MetricsServer

            self._metrics_server = MetricsServer(
                self.cfg.coordinator_host, self.cfg.metrics_port, status_fn=self.status
            )
            try:
                await self._metrics_server.start()
            except OSError:
                # A half-started coordinator must not leak its control socket
                # and background tasks when the metrics port can't bind.
                self._metrics_server = None
                await self.stop()
                raise
        log.info("coordinator listening on %s:%s", addr[0], addr[1])
        return addr[0], addr[1]

    @property
    def metrics_port(self) -> int | None:
        return self._metrics_server.bound_port if self._metrics_server else None

    async def stop(self) -> None:
        if self._metrics_server is not None:
            await self._metrics_server.stop()
        for t in self._bg:
            t.cancel()
        for w in list(self.workers.values()):
            w.writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    # -- connection handling ----------------------------------------------

    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        worker_id: str | None = None
        try:
            while True:
                frame = await protocol.receive_message(reader, writer=writer)
                for msg in protocol.unbatch(frame):
                    worker_id = await self._handle_message(msg, writer, worker_id)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except protocol.ProtocolError as e:
            log.warning("protocol error from %s: %s", worker_id, e)
        finally:
            info = self.workers.get(worker_id) if worker_id else None
            # Only evict if this connection still owns the registration — a
            # worker that re-registered under a stable id (new connection)
            # must not be evicted when its stale connection finally closes.
            if info is not None and info.writer is writer:
                await self._evict(worker_id, reason="connection closed")
            writer.close()

    async def _handle_message(
        self, msg: dict, writer: asyncio.StreamWriter, worker_id: str | None
    ) -> str | None:
        mtype = msg["type"]
        payload = msg.get("payload") or {}
        if mtype == "REGISTER":
            worker_id = payload.get("worker_id") or f"worker-{next(self._counter)}"
            prior = self.workers.get(worker_id)
            if prior is not None and prior.writer is not writer:
                # Same stable id on a fresh connection (host restart):
                # replace the registration and drop the stale socket.
                prior.writer.close()
            self.workers[worker_id] = WorkerInfo(
                worker_id=worker_id,
                capabilities=payload.get("capabilities", {}),
                writer=writer,
                last_heartbeat=time.monotonic(),
            )
            METRICS.set_gauge("coordinator.workers", len(self.workers))
            log.info("registered %s caps=%s", worker_id, payload.get("capabilities"))
            # A registration whose id already has assigned shards is a rejoin
            # (stale-connection replacement, or a post-eviction comeback when
            # no survivor could take the orphans): the fresh process has
            # nothing loaded, so re-place its assignment — without this,
            # shard_assignment routes generates at an empty worker.  The
            # assignment is read before the acknowledgement's await: a plan
            # made while the ack is sent (the worker is already listed) is
            # placed by its own place_shards, and a second PLACE_SHARDS
            # would load the engine twice (on a mesh rank, a second mesh
            # whose groups the other ranks never join).
            shards = sorted(
                s for s, w in self.shard_assignment.items() if w == worker_id
            )
            await protocol.send_message(
                writer,
                protocol.message(
                    "REGISTER_ACK",
                    {"worker_id": worker_id, "heartbeat_interval_s": self.cfg.heartbeat_interval_s},
                ),
            )
            if shards and self.store_dir is not None:
                self._bg.append(
                    asyncio.create_task(self._place_on(worker_id, shards))
                )
            if prior is not None and prior.writer is not writer:
                # Tasks in flight on the dead connection will never answer.
                for task in list(self.tasks.values()):
                    if task.assigned_to == worker_id and not task.future.done():
                        await self._retry(
                            task, reason=f"worker {worker_id} re-registered"
                        )
        elif mtype == "HEARTBEAT":
            if worker_id in self.workers:
                self.workers[worker_id].last_heartbeat = time.monotonic()
        elif mtype == "RESULT":
            task_id = msg.get("msg_id")
            task = self.tasks.get(task_id)
            # The sender is done either way — a late reply (task already
            # timed out and popped) must still free the worker.
            if worker_id in self.workers:
                self.workers[worker_id].status = "idle"
            if task is not None and not task.future.done():
                task.future.set_result(payload)
                METRICS.inc("coordinator.tasks_completed")
        elif mtype == "ERROR":
            task_id = msg.get("msg_id")
            task = self.tasks.get(task_id)
            log.warning("worker %s error on %s: %s", worker_id, task_id, payload)
            if worker_id in self.workers:
                self.workers[worker_id].status = "idle"
            if task is not None and not task.future.done():
                await self._retry(task, reason=str(payload))
        elif mtype == "GET_STATUS":
            await protocol.send_message(
                writer,
                protocol.message("RESULT", self.status(), msg_id=msg.get("msg_id")),
            )
        elif mtype == "GET_METRICS":
            await protocol.send_message(
                writer,
                protocol.message("RESULT", METRICS.snapshot(), msg_id=msg.get("msg_id")),
            )
        else:
            log.warning("unhandled message type %s", mtype)
            if msg.get("msg_id") is not None:
                await protocol.send_message(
                    writer,
                    protocol.message(
                        "ERROR", {"error": f"unsupported command {mtype}"},
                        msg_id=msg["msg_id"],
                    ),
                )
        return worker_id

    # -- liveness -------------------------------------------------------

    async def _liveness_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.heartbeat_interval_s / 2)
            now = time.monotonic()
            for wid, info in list(self.workers.items()):
                if now - info.last_heartbeat > self.cfg.heartbeat_timeout_s:
                    await self._evict(wid, reason="heartbeat timeout")

    async def _evict(self, worker_id: str, reason: str) -> None:
        info = self.workers.pop(worker_id, None)
        if info is None:
            return
        log.warning("evicting %s (%s)", worker_id, reason)
        METRICS.set_gauge("coordinator.workers", len(self.workers))
        METRICS.inc("coordinator.evictions")
        # Close the connection so the worker *sees* the eviction (EOF) and can
        # exit or reconnect — otherwise it heartbeats into the void forever.
        info.writer.close()
        # Reassign its shards to survivors and requeue its in-flight tasks.
        orphaned = sorted(
            s for s, w in self.shard_assignment.items() if w == worker_id
        )
        if orphaned and self.workers:
            for s in orphaned:
                del self.shard_assignment[s]
            self._bg.append(asyncio.create_task(self._reassign_orphans(orphaned)))
        elif orphaned:
            # No survivor can take the orphans: keep the assignment pointing
            # at the dead id.  Pinned dispatch already tolerates an absent
            # worker (requeue-with-delay), and a stable-id rejoin re-places
            # exactly this set (REGISTER handler); rebalance() also fixes it.
            log.warning(
                "no survivors for %s's shards %s; keeping assignment pending "
                "rejoin or rebalance", worker_id, orphaned,
            )
        for task in list(self.tasks.values()):
            if task.assigned_to == worker_id and not task.future.done():
                await self._retry(task, reason=f"worker {worker_id} evicted")

    async def _retry(self, task: Task, reason: str) -> None:
        task.assigned_to = None
        if task.attempts >= task.max_attempts:
            if not task.future.done():
                task.future.set_exception(
                    RuntimeError(f"task {task.task_id} failed after "
                                 f"{task.attempts} attempts: {reason}")
                )
            METRICS.inc("coordinator.tasks_failed")
            return
        METRICS.inc("coordinator.tasks_retried")
        await self.task_queue.put(task)

    # -- model lifecycle ---------------------------------------------------

    def _capacity(self, info: WorkerInfo) -> float:
        """Assignment weight from the worker's advertised capabilities."""
        caps = info.capabilities or {}
        w = caps.get("capacity") or caps.get("memory_gb") or caps.get("num_devices") or 1
        return max(float(w), 1e-9)

    # graftlint: holds(event-loop)
    def _balanced_assign(
        self, shards: list[int], load: dict[str, float] | None = None
    ) -> dict[int, str]:
        """Greedy capacity-weighted balancing: each shard goes to the worker
        with the lowest (projected load / capacity) ratio."""
        workers = sorted(self.workers)
        load = dict(load or {w: 0.0 for w in workers})
        weight = {w: self._capacity(self.workers[w]) for w in workers}
        out: dict[int, str] = {}
        for s in shards:
            w = min(workers, key=lambda w_: ((load.get(w_, 0.0) + 1) / weight[w_], w_))
            out[s] = w
            load[w] = load.get(w, 0.0) + 1
        return out

    # graftlint: holds(event-loop)  (REPL/CLI callers run it via the loop)
    def plan_shards(
        self,
        num_shards: int,
        store_dir: str | None = None,
        policy: str = "capacity",
    ) -> dict[int, str]:
        """Assign store shards to registered workers.

        policy='round_robin' is the source system's only strategy;
        'capacity' (default) weights the
        per-worker shard count by advertised capacity — with equal
        capabilities it degenerates to the same balanced split."""
        if not self.workers:
            raise RuntimeError("no workers registered")
        self.num_shards = num_shards
        self.store_dir = store_dir
        workers = sorted(self.workers)
        if policy == "round_robin":
            self.shard_assignment = {
                s: workers[s % len(workers)] for s in range(num_shards)
            }
        elif policy == "capacity":
            self.shard_assignment = self._balanced_assign(list(range(num_shards)))
        else:
            raise ValueError(f"unknown policy {policy!r}; round_robin|capacity")
        return dict(self.shard_assignment)

    async def _place_on(
        self, wid: str, shards: list[int], timeout: float | None = None
    ) -> Any:
        """Tell one worker its (new) shard set — PLACE_SHARDS, or
        UNLOAD_SHARDS when it lost everything — and sync bookkeeping."""
        try:
            if shards:
                reply = await self.submit(
                    "PLACE_SHARDS",
                    {"store_dir": self.store_dir, "shards": sorted(shards)},
                    worker_id=wid,
                    timeout=timeout,
                )
            else:
                reply = await self.submit("UNLOAD_SHARDS", {}, worker_id=wid, timeout=timeout)
        except (RuntimeError, asyncio.TimeoutError) as e:
            log.warning("placement on %s failed: %s", wid, e)
            return {"error": str(e)}
        info = self.workers.get(wid)  # may have been evicted meanwhile
        if info is None:
            return {"error": f"worker {wid} evicted during placement"}
        info.shards = sorted(shards)
        return reply

    async def _reassign_orphans(self, orphaned: list[int]) -> None:
        """Dynamic reassignment: move an evicted worker's shards onto
        survivors —
        capacity-weighted against their current load — and re-place them
        from the store."""
        try:
            if not self.workers:
                # Last worker died before this task ran.  num_shards is
                # intact, so a later plan_shards/rebalance rebuilds the map.
                log.warning(
                    "no survivors to take orphaned shards %s; replan needed",
                    orphaned,
                )
                return
            load: dict[str, float] = {w: 0.0 for w in self.workers}
            for s, w in self.shard_assignment.items():
                if w in load:
                    load[w] += 1
            moved = self._balanced_assign(orphaned, load)
            self.shard_assignment.update(moved)
            METRICS.inc("coordinator.shards_reassigned", len(moved))
            log.info("reassigned orphaned shards %s", moved)
            if self.store_dir is None:
                return
            targets = sorted(set(moved.values()))
            await asyncio.gather(
                *(
                    self._place_on(
                        wid,
                        [s for s, w in self.shard_assignment.items() if w == wid],
                    )
                    for wid in targets
                )
            )
        except Exception:  # background task: never die silently
            log.exception("orphan reassignment failed")

    async def rebalance(self, policy: str = "capacity") -> dict[int, str]:
        """Recompute the whole assignment over the *current* pool (e.g. after
        workers joined) and re-place every worker whose shard set changed —
        including workers that lost all shards (they get UNLOAD_SHARDS)."""
        if not self.num_shards:
            raise RuntimeError("plan_shards first")
        old_sets: dict[str, list[int]] = {}
        for s, w in self.shard_assignment.items():
            old_sets.setdefault(w, []).append(s)
        self.plan_shards(self.num_shards, self.store_dir, policy)
        if self.store_dir is not None:
            new_sets: dict[str, list[int]] = {}
            for s, w in self.shard_assignment.items():
                new_sets.setdefault(w, []).append(s)
            changed = [
                w for w in set(old_sets) | set(new_sets)
                if w in self.workers
                and sorted(old_sets.get(w, [])) != sorted(new_sets.get(w, []))
            ]
            await asyncio.gather(
                *(self._place_on(wid, sorted(new_sets.get(wid, []))) for wid in changed)
            )
        return dict(self.shard_assignment)

    async def place_shards(self, timeout: float | None = None) -> dict[str, Any]:
        """Tell each worker which shards to load from the store (the worker
        reads from shared storage and device_puts; no tensor bytes here)."""
        if not self.shard_assignment:
            raise RuntimeError("plan_shards first")
        per_worker: dict[str, list[int]] = {}
        for shard, wid in self.shard_assignment.items():
            per_worker.setdefault(wid, []).append(shard)
        # Placements are independent — run them concurrently so N hosts
        # load/compile in ~1× wall-clock, not N×.
        replies = await asyncio.gather(
            *(self._place_on(w, s, timeout) for w, s in per_worker.items())
        )
        return dict(zip(per_worker, replies))

    # -- task submission ---------------------------------------------------

    async def submit(
        self,
        type_: str,
        payload: dict,
        worker_id: str | None = None,
        timeout: float | None = None,
    ) -> Any:
        """Submit a task; returns the worker's RESULT payload."""
        task = Task(
            task_id=uuid.uuid4().hex,
            payload={"type": type_, "body": payload, "worker_id": worker_id},
            future=asyncio.get_running_loop().create_future(),
        )
        self.tasks[task.task_id] = task
        await self.task_queue.put(task)
        try:
            return await asyncio.wait_for(
                task.future, timeout or self.cfg.task_timeout_s
            )
        finally:
            self.tasks.pop(task.task_id, None)

    async def generate(self, prompts: list[str], max_new_tokens: int | None = None,
                       timeout: float | None = None) -> Any:
        """One batch of prompts on one worker; returns the decoded text of
        every row.  If the registered workers are controllers of one
        multi-process SPMD runtime, a single-worker dispatch would hang
        inside the first cross-process collective — route to generate_spmd.
        """
        if self._spmd_pool():
            return await self.generate_spmd(prompts, max_new_tokens, timeout)
        return await self.submit(
            "GENERATE", {"prompts": prompts, "max_new_tokens": max_new_tokens},
            timeout=timeout,
        )

    async def schedule_computation(
        self, payload: dict, worker_id: str | None = None,
        timeout: float | None = None,
    ) -> Any:
        """Dispatch one SCHEDULE_COMPUTATION task (the source system's
        generic compute verb, kept wire-compatible: workers serve it
        through the same engine path as GENERATE).  Declared-frame liveness is gated —
        graftflow's GF401 fails the tree when a MESSAGE_TYPES entry has
        handlers but no sender, which is exactly what this method closes."""
        return await self.submit("SCHEDULE_COMPUTATION", payload,
                                 worker_id=worker_id, timeout=timeout)

    async def shutdown_workers(self, timeout: float | None = None) -> dict:
        """Broadcast SHUTDOWN to every registered worker: each one answers
        ``{"ok": True}`` and stops its loops (graceful fleet retirement —
        the wire half the worker handler always implemented but nothing
        sent).  Returns {worker_id: reply-or-error-string}; a worker that
        died before answering reports its error instead of failing the
        whole broadcast."""
        wids = list(self.workers)
        results = await asyncio.gather(
            *(self.submit("SHUTDOWN", {}, worker_id=w, timeout=timeout)
              for w in wids),
            return_exceptions=True,
        )
        return {
            w: (f"{type(r).__name__}: {r}" if isinstance(r, BaseException)
                else r)
            for w, r in zip(wids, results)
        }

    # graftlint: holds(event-loop)
    def _spmd_pool(self) -> bool:
        """True when registered workers are controllers of one multi-process
        SPMD runtime (single-worker dispatch would hang in a collective)."""
        return any(
            w.capabilities.get("process_count", 1) > 1
            for w in self.workers.values()
        )

    async def generate_requests(
        self, requests: list[dict], timeout: float | None = None,
    ) -> Any:
        """Mixed-budget generation: each request is {"prompt": str,
        "max_new_tokens": int}.  A worker serves it with continuous
        batching (runtime/batcher.py): per-request budgets, no
        head-of-line blocking, on one device and on data x tensor-parallel
        meshes.  A pipelined mesh, whose decode schedule manages its own
        batching, serves the grouped longest-budget fallback
        (``cluster/worker.py``).  A pool of workers that report
        ``process_count > 1`` (one multi-process runtime) gets the batch
        broadcast, as :meth:`generate_spmd` does (the processes of a mesh
        worker)."""
        # Validate before dispatch so single-device (batcher) and mesh
        # (grouped) workers see only well-formed batches — the two engines
        # would otherwise diverge on how a bad request degrades.
        for i, r in enumerate(requests):
            prompt = r.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                raise ValueError(
                    f"request {i}: prompt must be a non-empty string, got "
                    f"{prompt!r}"
                )
            n = r.get("max_new_tokens", 32)
            # bool is an int subclass: True would silently serve 1 token.
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                raise ValueError(
                    f"request {i}: max_new_tokens must be an int >= 1, got {n!r}"
                )
        payload = {"requests": requests}
        if self._spmd_pool():
            return await self._submit_spmd(payload, timeout)
        return await self.submit("GENERATE", payload, timeout=timeout)

    async def _submit_spmd(self, payload: dict, timeout: float | None) -> Any:
        wids = list(self.workers)
        unplaced = [w for w in wids if not self.workers[w].shards]
        if unplaced:
            raise RuntimeError(
                f"SPMD generate needs every worker placed; missing engine on "
                f"{unplaced} (run place_shards first)"
            )
        results = await asyncio.gather(
            *(
                self.submit("GENERATE", payload, worker_id=w, timeout=timeout)
                for w in wids
            ),
            return_exceptions=True,
        )
        errors = {
            w: r for w, r in zip(wids, results) if isinstance(r, BaseException)
        }
        if errors:
            raise RuntimeError(f"SPMD generate failed on {errors}")
        texts = {tuple(r["text"]) for r in results}
        if len(texts) != 1:
            raise RuntimeError(
                f"SPMD generate disagreement across {len(wids)} workers: {texts}"
            )
        return results[0]

    async def generate_spmd(
        self, prompts: list[str], max_new_tokens: int | None = None,
        timeout: float | None = None,
    ) -> Any:
        """Generate over a runtime that SPANS the worker processes: every
        process must run the same computation in lockstep, so the task is
        dispatched to ALL registered workers at once (a single-worker
        dispatch would deadlock inside the first collective).  Each
        process computes and returns the identical full batch; the
        replies are checked against each other and one is returned (the
        ranks of a mesh worker, ``cluster/worker.py``)."""
        if not self.workers:
            raise RuntimeError("no workers registered")
        return await self._submit_spmd(
            {"prompts": prompts, "max_new_tokens": max_new_tokens}, timeout
        )

    async def _dispatch_loop(self) -> None:
        while True:
            task = await self.task_queue.get()
            if task.future.done():
                if task.future.cancelled():
                    # Submitter gave up (wait_for timeout) while the task was
                    # still queued — surface it as a failure, not silence.
                    METRICS.inc("coordinator.tasks_failed")
                continue
            wid = task.payload.get("worker_id")
            if wid and wid not in self.workers:
                # Pinned worker is absent — it may reconnect and re-register
                # under the same id (a heartbeat blip).  Requeue after a
                # delay *without* blocking this loop (other queued tasks keep
                # dispatching); the submitter's wait_for timeout bounds the
                # wait (a cancelled future is dropped at the top of this
                # loop).  Pin-waits are not dispatches, so they don't consume
                # task.attempts.
                loop = asyncio.get_running_loop()
                loop.call_later(0.2, self.task_queue.put_nowait, task)
                continue
            info = self.workers.get(wid) if wid else self._pick_worker()
            if info is None:
                # no worker (yet): brief backoff then requeue
                await asyncio.sleep(0.2)
                await self.task_queue.put(task)
                continue
            task.attempts += 1
            task.assigned_to = info.worker_id
            info.status = "busy"
            if self.faults is not None:
                # defer_stall: the dispatch loop runs ON the event loop —
                # a stall rule is awaited here, never slept (sleeping
                # would freeze heartbeat handling and every other task).
                rule = self.faults.fire("coordinator.dispatch",
                                        tag=task.payload["type"],
                                        defer_stall=True)
                if rule is not None and rule.action in ("delay", "stall"):
                    await asyncio.sleep(rule.arg or 0.0)
                if rule is not None and rule.action == "drop":
                    # The dispatch vanished in flight: task stays assigned
                    # and unanswered until the submitter's timeout fires.
                    continue
            try:
                await protocol.send_message(
                    info.writer,
                    protocol.message(
                        task.payload["type"], task.payload["body"], msg_id=task.task_id
                    ),
                )
                METRICS.inc("coordinator.tasks_dispatched")
            except (ConnectionError, OSError) as e:
                await self._evict(info.worker_id, reason=f"send failed: {e}")

    # graftlint: holds(event-loop)
    def _pick_worker(self) -> WorkerInfo | None:
        idle = [w for w in self.workers.values() if w.status == "idle"]
        if idle:
            return min(idle, key=lambda w: w.worker_id)
        alive = list(self.workers.values())
        return alive[0] if alive else None

    # -- introspection -----------------------------------------------------

    # graftlint: holds(event-loop)  (served by the asyncio MetricsServer)
    def status(self) -> dict:
        return {
            "workers": {
                wid: {
                    "capabilities": w.capabilities,
                    "status": w.status,
                    "shards": w.shards,
                    "heartbeat_age_s": round(time.monotonic() - w.last_heartbeat, 2),
                }
                for wid, w in self.workers.items()
            },
            "num_shards": self.num_shards,
            "shard_assignment": {str(k): v for k, v in self.shard_assignment.items()},
            "queued_tasks": self.task_queue.qsize(),
        }
