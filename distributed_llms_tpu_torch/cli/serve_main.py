"""Standalone HTTP serving entry point of the PyTorch/CUDA port.

``dlt-serve-torch --preset llama-3-8b --paged-pages 256 --prefix-cache``
boots an InferenceEngine with random seeded weights on the GPU, wraps a
paged, prefix-cached continuous batcher (``--kv-bits 8``: int8 pages) in
the OpenAI-style HTTP gateway (runtime/server.py), and serves until
SIGTERM/SIGINT.  Without ``--paged-pages`` (or with ``--paged-pages 0``)
the batcher serves contiguous mode, the one mode for sliding-window
models: ``dlt-serve-torch --preset mistral-7b --max-len 6144``, or at the
model's whole context with chunked prefill: ``dlt-serve-torch --preset
mistral-7b --max-len 32768 --prefill-chunk 1024``.  The engine loop
dispatches ahead unless ``--overlap off``.  ``--host-pages N`` puts N
pages of host RAM behind the paged pool: preempted rows swap out and back,
and cold cached pages spill there instead of being lost.
``--spec-decode`` serves speculatively: the engine attaches its int4
self-draft and every round drafts ``--spec-k`` tokens a row and verifies
them in one target forward (temperature 0: the target's greedy tokens).
``dlt-serve-torch --store DIR`` serves a shard store instead (model
config and tokenizer from its manifest); with ``--override
runtime.serve_quantized=true`` an int8/int4 store keeps its decoder-block
weights quantized on the device and every projection runs the
dequant-matmul kernel.  ``--device cpu`` runs on the CPU; without a GPU
and without it, the boot raises.

Requests may constrain their output (``response_format``: a JSON schema
or a regex; ``logit_bias``; ``banned_tokens``) unless the server runs
``--no-constrained``; ``--constrain-cache N`` sizes the LRU of compiled
automata.  ``--fault SPEC`` (repeatable; runtime/faults.py grammar, e.g.
``batcher.decode:raise@3``) arms deterministic fault injection, parsed
strictly before the engine builds: a site the port does not wire fails
the boot.

``--replicas N`` (N >= 2) serves N replica stacks behind a health-aware
router on ``--port`` (cluster/fleet.py, runtime/router.py): every replica
shares the engine's weights by reference and has its own pool, caches,
supervisor and engine thread; the router places by prefix affinity, pulls
a cached run from a sibling on an affinity miss, and fails zero-streamed
requests over exactly.  ``--disaggregate`` builds ``--prefill-replicas``
prefill-role and ``--decode-replicas`` decode-role stacks instead (needs
``--paged-pages`` and ``--prefix-cache``): the router hands each prompt to
the prefill tier, which ships the finished KV pages to the decode replica
over the checksummed handoff (cluster/kv_transfer.py), degrading to
colocated prefill when that fails.  ``--tenant-weights gold:4,free:1``
schedules tenants weighted-fair, ``--tenant-max-rows`` caps each tenant's
resident rows, ``--tenant-quota-tps`` sheds a tenant over its token rate
with 429 + its own ``Retry-After`` (in a fleet the router holds the one
ledger).  In a fleet, each replica gets its own fault plane parsed from
the same ``--fault`` spec; the ``replica.*`` and ``router.*`` sites fire
on the shared one.  SIGHUP restarts the fleet one replica at a time.

``--replicas-min 1 --replicas-max 2`` boots an ELASTIC colocated fleet:
replicas-min stacks now and an autoscaler (cluster/autoscale.py) that
grows it to replicas-max on the router's committed-token load and shrinks
it back by graceful drain only (``--autoscale-interval``,
``--autoscale-up-load``, ``--autoscale-down-load``,
``--autoscale-hysteresis``, ``--autoscale-cooldown``).  With
``--disaggregate``, ``--replicas-max`` or the per-tier
``--prefill-replicas-max`` / ``--decode-replicas-max`` arm the tiered
autoscaler: each tier scales between its boot count and its ceiling.
Every added replica is built by the same factory as the boot-time ones,
over the same copy of the weights.  The ``fleet.scale_up`` /
``fleet.scale_down`` fault sites fire on the shared plane.

Tensor and data parallelism: ``torchrun --nproc-per-node 2 -m
distributed_llms_tpu_torch.cli.serve_main --store DIR --override
mesh.model=2 ...`` (or one process per rank with ``--override
cluster.num_processes=2 --override cluster.process_id=R --override
cluster.distributed_coordinator=HOST:PORT``) serves a store on a data x
model mesh: every rank joins one ``torch.distributed`` group
(``cluster/distributed.py``: NCCL when each rank has a GPU of its own,
gloo when ranks share one), loads its block of the weights, and builds
the same batcher; rank 0 serves HTTP and journals its requests, which the
other ranks follow at every engine iteration (``runtime/lockstep.py``).
A mesh whose size is not the group's fails at boot.  Fleets, presets
and the speculative knobs are single-process.

The flags mirror ``dlt-serve``'s.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import os
import signal

from ..core.config import load_config
from ..core.observability import get_logger
from ..runtime.engine import InferenceEngine
from ..runtime.server import InferenceServer

log = get_logger("serve_main")

def _build_engine(args):
    """Config + fault plane + engine.  Returns (engine, default model
    name, runtime config, fault plane or None, fault spec)."""
    check_fleet_flags(args)
    cfg = load_config(args.config, args.override)
    rt = cfg.runtime
    # The speculative knobs land on the RuntimeConfig BEFORE the engine
    # builds: the engine attaches its self-draft at construction from
    # rt.spec_decode (a flag wins over the config when given).
    spec_overrides = {
        field: val for field, val in (
            ("spec_decode", args.spec_decode),
            ("spec_k", args.spec_k),
            ("spec_adaptive_k", args.spec_adaptive_k),
        ) if val is not None
    }
    if spec_overrides:
        import dataclasses

        rt = dataclasses.replace(rt, **spec_overrides)
    # The fault spec parses BEFORE the (slow) engine build, strictly: a
    # typo'd site, or one of a part of the stack not ported yet, fails the
    # boot in milliseconds instead of arming a rule that never fires.
    faults = None
    fault_spec = ",".join(args.fault or []) or rt.faults
    if fault_spec:
        from ..runtime.faults import FaultPlane

        faults = FaultPlane.parse(fault_spec, strict=True)
        log.warning("fault injection armed: %s", faults.describe())
    mesh_cfg = _join_mesh(args, cfg)
    if args.store:
        engine = InferenceEngine.from_store(args.store, rt=rt,
                                            mesh_cfg=mesh_cfg,
                                            device=args.device)
        return (engine, os.path.basename(os.path.normpath(args.store)), rt,
                faults, fault_spec)
    if not args.preset:
        raise SystemExit("one of --store or --preset is required")
    if mesh_cfg is not None:
        raise SystemExit("a mesh serves a shard store: pass --store")
    # Random-weight serving with the byte tokenizer: tiny presets (vocab
    # 256) cannot hold its specials (259 ids) — widen to 512.
    from ..models.presets import get_preset
    from ..runtime.tokenizer import ByteTokenizer

    overrides = (
        {"vocab_size": 512}
        if get_preset(args.preset).vocab_size < ByteTokenizer.vocab_size
        else {}
    )
    engine = InferenceEngine.from_preset(
        args.preset, rt=rt, rng_seed=args.seed, device=args.device,
        **overrides,
    )
    return engine, args.preset, rt, faults, fault_spec


def _join_mesh(args, cfg):
    """Join the process group this server is one rank of (the config's
    ``cluster`` section, or ``torchrun``'s environment) and return the
    mesh to serve on, or None for one process on one device."""
    from ..cluster.distributed import (initialize_distributed,
                                       initialize_from_env)

    if cfg.mesh.pipe > 1 or cfg.mesh.seq > 1:
        # The server serves through the continuous batcher, which refuses
        # these meshes (InferenceEngine.continuous_batcher): refuse before
        # joining the group or loading the store.  A pipelined or
        # sequence-parallel mesh serves behind the control plane
        # (dlt-host-torch).
        raise ValueError(
            "continuous batching requires a single-device engine or a "
            "pure data/tensor-parallel mesh (no pipe/seq axes)"
        )
    if cfg.cluster.num_processes > 1:
        initialize_distributed(cfg.cluster, device=args.device)
    else:
        initialize_from_env(device=args.device)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and cfg.mesh.num_devices == 1:
        return None
    if cfg.mesh.num_devices != world:
        raise ValueError(
            f"mesh shape {cfg.mesh.shape} needs {cfg.mesh.num_devices} "
            f"processes, got {world}")
    if _is_fleet(args) or args.spec_decode:
        raise SystemExit("--replicas, --disaggregate, --replicas-max and "
                         "--spec-decode serve on one process, not on a mesh")
    return cfg.mesh


def _server_factory(args, engine, default_name, rt, faults, *,
                    host=None, port=None, role="colocated",
                    backstop_x=None):
    """() -> a fresh, unstarted InferenceServer over a fresh batcher.
    Replicas share the engine's weights by reference; each gets its own
    pool, caches and supervisor."""
    from ..runtime import constrain as constrain_lib

    # The compiled-constraint LRU is module-level: one size per serving
    # process, shared by respawned batchers.
    constrain_lib.configure_cache(
        args.constrain_cache if args.constrain_cache is not None
        else rt.constrain_cache_size
    )

    def make_batcher():
        # Called at boot and again by the supervisor after an engine crash,
        # with the SAME fault plane: its rules' counters survive the
        # restart, so a once-only rule does not fire again.
        b = _make()
        if b.pm is not None:
            b.enable_lockstep()  # rank 0 journals, the others follow
        return b

    def _make():
        return engine.continuous_batcher(
            batch_slots=args.slots,
            max_len=args.max_len,
            chunk_steps=args.chunk_steps,
            prefill_chunk=args.prefill_chunk,
            prefill_concurrency=args.prefill_concurrency,
            paged_pages=args.paged_pages,
            page_size=args.page_size,
            prefix_cache=args.prefix_cache,
            kv_bits=args.kv_bits,
            host_pages=args.host_pages,
            overlap=(None if args.overlap is None
                     else args.overlap == "on"),
            schedule=args.schedule,
            token_budget=args.token_budget,
            tenant_weights=args.tenant_weights,
            tenant_max_rows=args.tenant_max_rows,
            faults=faults,
        )

    # Tenant QoS (the gateway half): the flag wins, the config field is
    # the fallback.  Weights parse ONCE here, so a typo'd spec fails the
    # boot before any server exists.
    from ..runtime.scheduler import parse_tenant_weights

    tenant_weights = parse_tenant_weights(
        args.tenant_weights if args.tenant_weights is not None
        else rt.tenant_weights
    )
    tenant_quota_tps = (args.tenant_quota_tps
                        if args.tenant_quota_tps is not None
                        else rt.tenant_quota_tps)

    def make_server():
        return InferenceServer(
            make_batcher(),
            model_name=args.model_name or default_name,
            host=args.host if host is None else host,
            port=args.port if port is None else port,
            max_pending=args.max_pending,
            batcher_factory=make_batcher,
            request_timeout_s=(args.request_timeout
                               if args.request_timeout is not None
                               else rt.request_timeout_s),
            watchdog_timeout_s=args.watchdog_timeout,
            shed_cost_factor=(args.shed_cost_factor
                              if args.shed_cost_factor is not None
                              else rt.shed_cost_factor),
            constrained=(args.constrained if args.constrained is not None
                         else rt.constrained_decoding),
            role=role,
            tenant_weights=tenant_weights,
            tenant_quota_tps=tenant_quota_tps,
            tenant_backstop_x=backstop_x,
        )

    return make_server


def check_fleet_flags(args) -> None:
    """Refuse fleet flags that mean nothing as given, before the model
    loads (the reference's checks in its ``main``)."""
    defaults = parser()
    if args.replicas_max is not None and args.replicas_max < 1:
        raise SystemExit(f"--replicas-max must be >= 1, got "
                         f"{args.replicas_max}")
    for k in ("prefill_replicas_max", "decode_replicas_max"):
        v = getattr(args, k)
        flag = f"--{k.replace('_', '-')}"
        if v is not None and v < 1:
            raise SystemExit(f"{flag} must be >= 1, got {v}")
        if v is not None and not args.disaggregate:
            raise SystemExit(f"{flag} needs --disaggregate")
    if args.replicas_max is None and args.prefill_replicas_max is None \
            and args.decode_replicas_max is None:
        # A ceiling is THE elastic switch: the floor and every autoscale
        # knob mean nothing without one.
        stray = [f"--{k.replace('_', '-')}" for k in (
            "replicas_min", "autoscale_interval", "autoscale_up_load",
            "autoscale_down_load", "autoscale_hysteresis",
            "autoscale_cooldown",
        ) if getattr(args, k) != defaults.get_default(k)]
        if stray:
            raise SystemExit(
                f"{', '.join(stray)} need --replicas-max (or a "
                "--prefill/--decode-replicas-max tier ceiling)"
            )
    if args.disaggregate and args.replicas_min != defaults.get_default(
            "replicas_min"):
        raise SystemExit(
            "--replicas-min sizes the colocated elastic fleet; "
            "--disaggregate tiers floor at --prefill-replicas/"
            "--decode-replicas"
        )


def _is_fleet(args) -> bool:
    return bool(args.replicas > 1 or args.disaggregate or args.replicas_max)


def build_server(args) -> InferenceServer:
    if _is_fleet(args):
        raise SystemExit("--replicas, --disaggregate and --replicas-max "
                         "serve a fleet: build it with build_fleet")
    engine, default_name, rt, faults, _spec = _build_engine(args)
    return _server_factory(args, engine, default_name, rt, faults)()


def build_fleet(args, engine_parts=None):
    """``--replicas N`` (N >= 2) or ``--disaggregate``: full server/batcher
    stacks on ephemeral local ports behind a health-aware ReplicaRouter on
    --host/--port.  ``--disaggregate`` builds --prefill-replicas
    prefill-role and --decode-replicas decode-role stacks instead of N
    colocated ones.  The ROUTER owns the tenant rate ledger (one
    admission-commit point, so a fleet of N admits one quota, not N);
    replica gateways keep a loose 2x backstop.  ``--replicas-min`` /
    ``--replicas-max`` boot an elastic colocated fleet under an
    :class:`~..cluster.autoscale.Autoscaler`; with ``--disaggregate`` a
    ceiling above a tier's boot count arms the
    :class:`~..cluster.autoscale.TieredAutoscaler`.  A scale-up builds
    its replica with the boot-time factory, over the same weights.
    ``engine_parts`` is a :func:`_build_engine` result to reuse (one copy
    of the weights for several fleets in one process).  Returns (fleet,
    router, autoscaler or None); the caller starts and stops the
    autoscaler around the fleet."""
    from ..cluster.autoscale import Autoscaler, TieredAutoscaler, TierPolicy
    from ..cluster.fleet import ReplicaFleet
    from ..runtime.router import ReplicaRouter
    from ..runtime.scheduler import parse_tenant_weights

    engine, default_name, rt, faults, fault_spec = (
        engine_parts if engine_parts is not None else _build_engine(args))

    def replica_factory(role="colocated"):
        # Each replica gets its OWN plane parsed from the same spec: its
        # batcher.* and server-side rule counters are traversed by that
        # replica's engine thread and loop alone, @N windows count per
        # replica, and a replica.stall drill wedges its target only.  The
        # shared ``faults`` plane keeps the replica.* / router.* sites.
        plane = None
        if fault_spec:
            from ..runtime.faults import FaultPlane

            plane = FaultPlane.parse(fault_spec, strict=True)
        # Behind a router the replica gateway is not the admission-commit
        # point: it keeps a loose ~2x backstop, so a bypassed router gate
        # still meters.
        return _server_factory(args, engine, default_name, rt, plane,
                               host="127.0.0.1", port=0, role=role,
                               backstop_x=2.0)()

    if args.disaggregate:
        if args.prefill_replicas < 1 or args.decode_replicas < 1:
            raise SystemExit(
                "--disaggregate needs --prefill-replicas >= 1 and "
                "--decode-replicas >= 1"
            )
        paged = args.paged_pages if args.paged_pages is not None \
            else rt.paged_pages
        cache_on = args.prefix_cache if args.prefix_cache is not None \
            else rt.prefix_cache
        if not paged or not cache_on:
            raise SystemExit(
                "--disaggregate ships content-addressed KV pool pages: it "
                "needs --paged-pages and --prefix-cache on every replica"
            )
        factories = (
            [functools.partial(replica_factory, "prefill")]
            * args.prefill_replicas
            + [functools.partial(replica_factory, "decode")]
            * args.decode_replicas
        )
        names = [f"p{i}" for i in range(args.prefill_replicas)] \
            + [f"d{i}" for i in range(args.decode_replicas)]
    else:
        n = args.replicas_min if args.replicas_max else args.replicas
        factories = [replica_factory] * n
        names = None
    fleet = ReplicaFleet(
        factories, names=names,
        probe_interval_s=args.probe_interval,
        faults=faults,
    )
    tenant_weights = parse_tenant_weights(
        args.tenant_weights if args.tenant_weights is not None
        else rt.tenant_weights
    )
    tenant_quota_tps = (args.tenant_quota_tps
                        if args.tenant_quota_tps is not None
                        else rt.tenant_quota_tps)
    router = ReplicaRouter(
        fleet, host=args.host, port=args.port,
        tokenizer=engine.tokenizer,
        page_size=(args.page_size or rt.page_size or 64),
        max_failover_retries=args.failover_retries,
        faults=faults,
        handoff=bool(args.disaggregate),
        # Affinity/handoff digests must match the fleet's pool digests,
        # which are salted by the KV width.
        kv_bits=(args.kv_bits if args.kv_bits is not None else rt.kv_bits),
        tenant_weights=tenant_weights,
        tenant_quota_tps=tenant_quota_tps,
    )
    autoscaler = None
    if args.disaggregate:
        # Tier ceilings: the per-tier flag wins, --replicas-max is the
        # shared spelling, the boot count means a fixed tier.
        p_max = (args.prefill_replicas_max or args.replicas_max
                 or args.prefill_replicas)
        d_max = (args.decode_replicas_max or args.replicas_max
                 or args.decode_replicas)
        if p_max < args.prefill_replicas or d_max < args.decode_replicas:
            raise SystemExit(
                f"tier ceiling below its boot count: prefill "
                f"{args.prefill_replicas}..{p_max}, decode "
                f"{args.decode_replicas}..{d_max}"
            )
        if p_max > args.prefill_replicas or d_max > args.decode_replicas:
            def policy(floor, ceiling):
                return TierPolicy(
                    min_replicas=floor, max_replicas=ceiling,
                    up_load=args.autoscale_up_load,
                    down_load=args.autoscale_down_load,
                    hysteresis=args.autoscale_hysteresis,
                    cooldown_s=args.autoscale_cooldown,
                )

            autoscaler = TieredAutoscaler(
                fleet,
                prefill=policy(args.prefill_replicas, p_max),
                decode=policy(args.decode_replicas, d_max),
                prefill_factory=functools.partial(replica_factory,
                                                  "prefill"),
                decode_factory=functools.partial(replica_factory, "decode"),
                interval_s=args.autoscale_interval,
                drain_timeout_s=args.drain_timeout,
                faults=faults,
            )
    elif args.replicas_max:
        if args.replicas_max < args.replicas_min:
            raise SystemExit(
                f"--replicas-max {args.replicas_max} < --replicas-min "
                f"{args.replicas_min}"
            )
        if args.replicas != 1:
            raise SystemExit(
                "--replicas fixes the fleet size; an elastic fleet is "
                "sized by --replicas-min/--replicas-max"
            )
        autoscaler = Autoscaler(
            fleet,
            min_replicas=args.replicas_min,
            max_replicas=args.replicas_max,
            interval_s=args.autoscale_interval,
            up_load=args.autoscale_up_load,
            down_load=args.autoscale_down_load,
            hysteresis=args.autoscale_hysteresis,
            cooldown_s=args.autoscale_cooldown,
            drain_timeout_s=args.drain_timeout,
            factory=replica_factory,
            faults=faults,
        )
    return fleet, router, autoscaler


async def _serve_fleet(args, stop: asyncio.Event) -> None:
    loop = asyncio.get_running_loop()
    fleet, router, autoscaler = build_fleet(args)
    await fleet.start()
    host, port = await router.start()
    # Replicas boot "starting" and only a healthy probe makes them
    # routable: announce ready once the fleet can place work.
    if not await fleet.wait_healthy(timeout_s=60.0):
        log.warning(
            "not every replica probed healthy within 60s; serving with "
            "%d routable", fleet.report()["healthy"],
        )
    # SIGHUP: a rolling restart of the whole fleet, one replica at a time;
    # one restart at a time (a second SIGHUP mid-walk is ignored).
    restart_task: list[asyncio.Task | None] = [None]

    def on_hup():
        t = restart_task[0]
        if t is not None and not t.done():
            log.warning("SIGHUP ignored: a rolling restart is already in "
                        "progress")
            return

        async def run():
            try:
                await fleet.rolling_restart(
                    drain_timeout_s=args.drain_timeout)
                log.info("rolling restart complete")
            except Exception:
                log.exception("rolling restart failed")

        restart_task[0] = asyncio.ensure_future(run())

    loop.add_signal_handler(signal.SIGHUP, on_hup)
    if autoscaler is not None:
        # Flat or tiered: each logs its own bounds in start().
        await autoscaler.start()
    log.info("fleet of %d ready on http://%s:%s (SIGHUP = rolling restart; "
             "Ctrl-C to stop)", len(fleet.replicas), host, port)
    await stop.wait()
    log.info("shutting down fleet...")
    if autoscaler is not None:
        await autoscaler.stop()
    await router.stop()
    await fleet.stop()


async def _serve(args) -> None:
    stop = asyncio.Event()
    force = asyncio.Event()
    loop = asyncio.get_running_loop()

    def on_signal():
        # First signal: graceful drain.  Second: cut the drain short.
        (force if stop.is_set() else stop).set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, on_signal)
    if _is_fleet(args):
        await _serve_fleet(args, stop)
        return
    engine, default_name, rt, faults, _spec = _build_engine(args)
    make_server = _server_factory(args, engine, default_name, rt, faults)
    if engine.pm is not None and engine.pm.mesh.rank != 0:
        # A following rank: the same batcher, fed by rank 0's journal.
        from ..runtime.lockstep import follow

        batcher = make_server().batcher
        log.info("rank %d following rank 0", engine.pm.mesh.rank)
        await asyncio.to_thread(follow, batcher)
        return
    server = make_server()
    host, port = await server.start()
    log.info("ready on http://%s:%s (Ctrl-C to stop)", host, port)
    await stop.wait()
    log.info("shutting down (draining up to %.0fs; signal again to force)...",
             args.drain_timeout)
    drain = asyncio.create_task(server.stop(drain_timeout=args.drain_timeout))
    forcer = asyncio.create_task(force.wait())
    await asyncio.wait({drain, forcer}, return_when=asyncio.FIRST_COMPLETED)
    if not drain.done():
        log.info("second signal: forcing immediate shutdown")
        server.force_stop()
    await drain
    forcer.cancel()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--store", default=None,
                    help="shard store directory (checkpoint.store); wins "
                         "over --preset")
    ap.add_argument("--preset", default=None,
                    help="serve a random-weight preset (e.g. llama-3-8b)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU explicitly)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--config", default=None, help="JSON/YAML config file")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override, e.g. runtime.temperature=0.7")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--model-name", default=None,
                    help="name reported by /v1/models (default: the "
                         "store's directory name, or the preset)")
    ap.add_argument("--slots", type=int, default=8,
                    help="continuous-batching row slots")
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-row cache length (default: runtime.max_seq_len)")
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="decode steps per scheduling chunk")
    ap.add_argument("--paged-pages", type=int, default=None,
                    help="paged KV: size of the shared page pool (pages) "
                         "(default: runtime.paged_pages; 0 or unset serves "
                         "contiguous KV)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV: tokens per page (default: "
                         "runtime.page_size)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="automatic prefix caching over the paged pool "
                         "(default: runtime.prefix_cache)")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[16, 8],
                    help="8 stores paged KV pages as int8 with one float32 "
                         "absmax scale per head vector (about half the "
                         "bytes; not bit-exact).  Needs --paged-pages.  "
                         "Default: runtime.kv_bits (16)")
    ap.add_argument("--schedule", choices=["mixed", "alternate"],
                    default=None,
                    help="scheduling policy: 'mixed' runs pending prefill "
                         "bites in the decode step, so decode rows never "
                         "stall for a serialized prefill forward; "
                         "'alternate' runs them as rounds of their own.  "
                         "Temp-0 tokens identical either way (default: "
                         "runtime.schedule, mixed)")
    ap.add_argument("--overlap", choices=["on", "off"], default=None,
                    help="dispatch-ahead engine loop: chunk N+1 dispatches "
                         "from chunk N's carry on the device while chunk "
                         "N's host work (delivery, digest hashing, "
                         "metrics) runs.  Temp-0 tokens identical on or "
                         "off; gauges under batcher_overlap_* on /metrics "
                         "(default: runtime.overlap, on)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-step token budget of the mixed schedule: "
                         "each fused step runs one decode leg per active "
                         "slot plus up to budget - n_active prefill "
                         "tokens; prompts longer than the budget "
                         "auto-chunk.  0 = prefill-chunk-sized bites "
                         "(default: runtime.token_budget)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: admit at most this many prompt "
                         "tokens per scheduling round per pending prefill, "
                         "so long prompts never stall in-flight decodes "
                         "(default: monolithic admission)")
    ap.add_argument("--prefill-concurrency", type=int, default=2,
                    help="chunked prefills in flight at once (per-round "
                         "prefill work is bounded by prefill-chunk x this)")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="in-flight request cap before 429s")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="graceful shutdown: seconds to let in-flight "
                         "requests finish before cancelling (0 = immediate)")
    ap.add_argument("--request-timeout", type=float, default=None,
                    help="default per-request deadline in seconds "
                         "(default: runtime.request_timeout_s)")
    ap.add_argument("--shed-cost-factor", type=float, default=None,
                    help="estimated-cost admission gate: 429 once queued + "
                         "resident token mass exceeds this multiple of KV "
                         "capacity (0 disables; default: "
                         "runtime.shed_cost_factor)")
    ap.add_argument("--watchdog-timeout", type=float, default=30.0,
                    help="engine watchdog: /healthz flips unhealthy when "
                         "in-flight work exists but no chunk was delivered "
                         "for this many seconds")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host-RAM KV tier size in pages: preemption swaps "
                         "rows out (byte-exact restore) and cold cached "
                         "pages spill before eviction.  Needs "
                         "--paged-pages.  Default: runtime.host_pages (0)")
    ap.add_argument("--spec-decode", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="speculative decoding: the engine drafts spec-k "
                         "tokens a row with its own int4-quantized "
                         "self-draft and verifies them in one target "
                         "forward; at temperature 0 every token is the "
                         "target's greedy token.  Composes with --paged-pages, "
                         "--prefix-cache, --kv-bits 8 and --host-pages; "
                         "not with --prefill-chunk (default: "
                         "runtime.spec_decode)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens per speculative round (default: "
                         "runtime.spec_k)")
    ap.add_argument("--spec-adaptive-k",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="adaptive per-row spec-k downshift from the "
                         "acceptance-rate EMA and the token budget "
                         "(default: runtime.spec_adaptive_k)")
    ap.add_argument("--constrained", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="grammar-constrained output: the response_format "
                         "({\"type\": \"json_schema\"|\"regex\"}), "
                         "logit_bias and banned_tokens request fields, "
                         "served as token-mask automata inside the decode "
                         "step.  --no-constrained answers every "
                         "constrained request 400 (default: "
                         "runtime.constrained_decoding, on)")
    ap.add_argument("--constrain-cache", type=int, default=None,
                    help="LRU capacity of the compiled (constraint, "
                         "tokenizer) automaton cache (default: "
                         "runtime.constrain_cache_size)")
    ap.add_argument("--fault", action="append", default=[],
                    help="deterministic fault injection spec "
                         "(runtime/faults.py grammar, repeatable): e.g. "
                         "'batcher.decode:raise@3' crashes the 3rd decode "
                         "chunk (the supervisor respawns the batcher), "
                         "'batcher.decode:stall@2:5' wedges the 2nd for "
                         "the watchdog.  Parsed strictly before the "
                         "engine builds (default: runtime.faults)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica-fleet serving: N server/batcher stacks "
                         "sharing one copy of the weights, each with its "
                         "own supervisor and KV pool, behind a "
                         "health-aware router on --port: prefix-affinity "
                         "placement, cross-replica KV pulls, exact "
                         "failover on replica crash/stall/partition, "
                         "SIGHUP = rolling restart (1 = one server)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="disaggregated serving: prefill-role replicas "
                         "admit prompts and ship the finished KV pages to "
                         "decode-role replicas over the verified handoff; "
                         "any handoff failure degrades to colocated "
                         "prefill on the decode replica.  Needs "
                         "--paged-pages and --prefix-cache; ignores "
                         "--replicas")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="prefill-role replicas under --disaggregate")
    ap.add_argument("--decode-replicas", type=int, default=2,
                    help="decode-role replicas under --disaggregate")
    ap.add_argument("--probe-interval", type=float, default=0.25,
                    help="fleet health-probe interval in seconds")
    ap.add_argument("--failover-retries", type=int, default=2,
                    help="router failover budget: how many other replicas "
                         "a zero-streamed request may be re-sent to after "
                         "a replica failure before answering 503 + "
                         "Retry-After")
    ap.add_argument("--tenant-weights", default=None,
                    help="multi-tenant weighted-fair serving: "
                         "\"gold:4,free:1\"-style shares (\"*\" sets the "
                         "default weight).  Requests carry X-Tenant (or a "
                         "\"tenant\" body field); admission serves tenants "
                         "by virtual token counter (default: "
                         "runtime.tenant_weights)")
    ap.add_argument("--tenant-quota-tps", type=float, default=None,
                    help="per-tenant token-rate quota: admitted "
                         "prompt+budget tokens/s per unit weight; a tenant "
                         "over its rate sheds 429 with its own Retry-After "
                         "(0 disables; default: runtime.tenant_quota_tps)")
    ap.add_argument("--tenant-max-rows", type=int, default=None,
                    help="per-tenant resident-row cap in the batcher "
                         "(0 = uncapped; default: runtime.tenant_max_rows)")
    ap.add_argument("--prefill-replicas-max", type=int, default=None,
                    help="elastic prefill-tier ceiling under "
                         "--disaggregate: the tiered autoscaler grows "
                         "the tier on handoff queue depth and shrinks "
                         "it via graceful drain, never below "
                         "--prefill-replicas (default: --replicas-max, "
                         "else fixed at the boot count)")
    ap.add_argument("--decode-replicas-max", type=int, default=None,
                    help="elastic decode-tier ceiling under "
                         "--disaggregate: scales on committed-token "
                         "mass over tier KV capacity, never below "
                         "--decode-replicas (default: --replicas-max, "
                         "else fixed at the boot count)")
    ap.add_argument("--replicas-min", type=int, default=1,
                    help="elastic fleet floor: boot this many colocated "
                         "replicas and never drain below it (used with "
                         "--replicas-max)")
    ap.add_argument("--replicas-max", type=int, default=None,
                    help="elastic fleet ceiling: arm the autoscaler "
                         "(cluster/autoscale.py) to grow the colocated "
                         "fleet up to this many replicas under load and "
                         "shrink it back by graceful drain; every added "
                         "replica shares the weights.  With "
                         "--disaggregate: both tiers' ceiling (the "
                         "--prefill/--decode-replicas-max flags override "
                         "per tier).  Unset = fixed-size fleet")
    ap.add_argument("--autoscale-interval", type=float, default=1.0,
                    help="autoscaler tick cadence in seconds")
    ap.add_argument("--autoscale-up-load", type=float, default=0.8,
                    help="scale up when committed-token load (fraction "
                         "of aggregate KV capacity) stays at or above this")
    ap.add_argument("--autoscale-down-load", type=float, default=0.25,
                    help="scale down when load stays at or below this")
    ap.add_argument("--autoscale-hysteresis", type=int, default=3,
                    help="consecutive ticks past a threshold before the "
                         "autoscaler acts (noise filter)")
    ap.add_argument("--autoscale-cooldown", type=float, default=10.0,
                    help="quiet seconds after every scale action (or "
                         "failed attempt) before the next one")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    check_fleet_flags(args)
    try:
        asyncio.run(_serve(args))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
