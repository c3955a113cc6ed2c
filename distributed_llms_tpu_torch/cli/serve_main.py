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

The flags mirror ``dlt-serve``'s.  Those of later port slices are
accepted by the parser and refused with ``NotImplementedError`` when set,
never silently ignored.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal

from ..core.config import load_config
from ..core.observability import get_logger
from ..runtime.engine import InferenceEngine
from ..runtime.server import InferenceServer

log = get_logger("serve_main")

# dlt-serve flags of later port slices: argparse dest -> the feature.  Any
# of them set (to a value other than its default) refuses the boot.
_LATER_SLICE_FLAGS: dict[str, str] = {
    "constrained": "constrained output (--constrained)",
    "tenant_weights": "multi-tenant scheduling (--tenant-weights)",
    "tenant_quota_tps": "tenant rate quotas (--tenant-quota-tps)",
    "tenant_max_rows": "tenant row caps (--tenant-max-rows)",
    "replicas": "replica fleets (--replicas)",
    "disaggregate": "disaggregated prefill/decode (--disaggregate)",
    "fault": "fault injection (--fault)",
}
_LATER_SLICE_DEFAULTS = {"replicas": 1,
                         "disaggregate": False, "fault": []}


def _refuse_later_slices(args) -> None:
    for dest, what in _LATER_SLICE_FLAGS.items():
        value = getattr(args, dest)
        # False (--no-spec-decode, --no-constrained) asks for what the
        # port already does.
        if value not in (None, False) and value != _LATER_SLICE_DEFAULTS.get(dest):
            raise NotImplementedError(f"{what} is not ported yet")


def _build_engine(args):
    """Config + engine.  Returns (engine, default model name, runtime
    config)."""
    _refuse_later_slices(args)
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
    if args.store:
        mesh_cfg = cfg.mesh if cfg.mesh.num_devices > 1 else None
        engine = InferenceEngine.from_store(args.store, rt=rt,
                                            mesh_cfg=mesh_cfg,
                                            device=args.device)
        return engine, os.path.basename(os.path.normpath(args.store)), rt
    if not args.preset:
        raise SystemExit("one of --store or --preset is required")
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
    return engine, args.preset, rt


def _server_factory(args, engine, default_name, rt):
    """() -> a fresh, unstarted InferenceServer over a fresh batcher."""

    def make_batcher():
        # Called at boot and again by the supervisor after an engine crash.
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
        )

    def make_server():
        return InferenceServer(
            make_batcher(),
            model_name=args.model_name or default_name,
            host=args.host,
            port=args.port,
            max_pending=args.max_pending,
            batcher_factory=make_batcher,
            request_timeout_s=(args.request_timeout
                               if args.request_timeout is not None
                               else rt.request_timeout_s),
            watchdog_timeout_s=args.watchdog_timeout,
            shed_cost_factor=(args.shed_cost_factor
                              if args.shed_cost_factor is not None
                              else rt.shed_cost_factor),
        )

    return make_server


def build_server(args) -> InferenceServer:
    engine, default_name, rt = _build_engine(args)
    return _server_factory(args, engine, default_name, rt)()


async def _serve(args) -> None:
    stop = asyncio.Event()
    force = asyncio.Event()
    loop = asyncio.get_running_loop()

    def on_signal():
        # First signal: graceful drain.  Second: cut the drain short.
        (force if stop.is_set() else stop).set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, on_signal)
    server = build_server(args)
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
    # Flags of later port slices (refused when set; see _LATER_SLICE_FLAGS).
    ap.add_argument("--constrained", action=argparse.BooleanOptionalAction,
                    default=None, help="not ported yet")
    ap.add_argument("--tenant-weights", default=None, help="not ported yet")
    ap.add_argument("--tenant-quota-tps", type=float, default=None,
                    help="not ported yet")
    ap.add_argument("--tenant-max-rows", type=int, default=None,
                    help="not ported yet")
    ap.add_argument("--replicas", type=int, default=1, help="not ported yet")
    ap.add_argument("--disaggregate", action="store_true",
                    help="not ported yet")
    ap.add_argument("--fault", action="append", default=[],
                    help="not ported yet")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    _refuse_later_slices(args)
    asyncio.run(_serve(args))


if __name__ == "__main__":
    main()
